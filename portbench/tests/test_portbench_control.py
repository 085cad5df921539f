"""Each control (the reference with one guarantee broken, in the system's
place) comes out not correct on a cell's own plan, on three seeds."""

import pytest

from portbench.harness import control


@pytest.mark.parametrize("name", control.CONTROLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 5, 987654321])
def test_control_is_caught(name, seed, cached_reference):
    result = control.run("decode_block-b4", seed, 0.2, name)
    assert result["correct"] is False
    assert result["failed"] > 0


def test_reference_itself_is_correct(cached_reference):
    assert control.run("decode_block-b4", 11, 0.2, None)["correct"] is True
