"""The repo-level ``conftest.py``'s test order: the long-pole files first,
then the rest by test count, with xdist's own sort by test count off.

The hooks are called directly on stand-in items and configs, without a
pytest subprocess.
"""
import importlib.util
import os
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_root_conftest():
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", os.path.join(ROOT, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


order = _load_root_conftest()


def _items(counts):
    """Stand-in items, ``counts`` tests a file, in collection order."""
    return [types.SimpleNamespace(nodeid=f"tests/{name}::test_{i}")
            for name, n in counts for i in range(n)]


def _files(items):
    seen = []
    for item in items:
        name = item.nodeid.split("::")[0].rsplit("/", 1)[-1]
        if not seen or seen[-1] != name:
            seen.append(name)
    return seen


# Every pole with one test, collected in reverse, among files of 1 to 5
# tests (two of them tied at 3).
COUNTS = ([("test_a.py", 1), ("test_b.py", 3)]
          + [(name, 1) for name in reversed(order.LONG_POLES)]
          + [("test_c.py", 5), ("test_d.py", 3), ("test_e.py", 4)])


def test_long_poles_first_in_the_tuples_order_then_by_test_count():
    items = _items(COUNTS)
    order.pytest_collection_modifyitems(items)
    assert _files(items) == list(order.LONG_POLES) + [
        "test_c.py", "test_e.py", "test_b.py", "test_d.py", "test_a.py"]


def test_every_item_kept_once_in_file_order():
    items = _items(COUNTS)
    before = list(items)
    order.pytest_collection_modifyitems(items)
    assert sorted(map(id, items)) == sorted(map(id, before))
    for name, _ in COUNTS:
        assert ([x.nodeid for x in items if f"/{name}::" in x.nodeid]
                == [x.nodeid for x in before if f"/{name}::" in x.nodeid])


@pytest.mark.parametrize("name", order.LONG_POLES)
def test_each_long_pole_exists(name):
    assert os.path.isfile(os.path.join(ROOT, "tests", name))


def test_configure_turns_off_xdist_reorder():
    config = types.SimpleNamespace(
        option=types.SimpleNamespace(loadscopereorder=True))
    order.pytest_configure(config)
    assert config.option.loadscopereorder is False


def test_configure_without_xdist_adds_nothing():
    config = types.SimpleNamespace(option=types.SimpleNamespace())
    order.pytest_configure(config)
    assert vars(config.option) == {}
