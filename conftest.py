"""Test order for the tier-1 gate: the long-pole files start first.

Under ``-p xdist --dist loadfile`` a file's tests run on one worker, and
xdist hands out the files with the most tests first.  The few-test files
that take minutes would then start last and set the wall clock.  So xdist's
sort is turned off and the collection is ordered here instead: the dearest
files first, one per worker at ``-n 6``, then the rest by test count, most
first, so that the files queued behind a 1- or 2-test pole are cheap
many-test ones.  The order is the same on every worker, as xdist requires.
"""
import os

import pytest

# The dearest files, dearest first, with their junit seconds on the CPU
# (tier-1 at -n 6).  Update the tuple when another file's time overtakes
# one of these.
LONG_POLES = (
    "test_verify_e2e.py",      # 625.3 s, 2 tests
    "test_distributed.py",     # 321.7 s, 1 test
    "test_mesh.py",            # 205.6 s, 4 tests
    "test_pallas_kernels.py",  # 95.1 s, 5 tests
    "test_torch_mesh.py",      # 82.8 s, 15 tests
    "test_torch_verify.py",    # 73.6 s, 8 tests
)


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):  # xdist is loaded
        config.option.loadscopereorder = False


@pytest.hookimpl(trylast=True)  # after `-m` has deselected
def pytest_collection_modifyitems(items):
    by_file = {}
    for item in items:
        by_file.setdefault(item.nodeid.split("::", 1)[0], []).append(item)

    def rank(path):
        name = os.path.basename(path)
        if name in LONG_POLES:
            return 0, LONG_POLES.index(name)
        return 1, -len(by_file[path])

    items[:] = [item for path in sorted(by_file, key=rank)
                for item in by_file[path]]
