"""The control (``gpubench/control.py``: the program's case-insensitive
path, which breaks the configurations' case-sensitive guarantee) comes out
not correct: on the CPU at a small size where the check can see it, and on
the card at each cell's own size."""

import json

import pytest

from gpubench import control

# The small set's 2- and 3-byte patterns meet their case variants in a few
# hundred kilobytes of payload.
SMALL = {
    "ref_strings.stream_mega": {"packets": 1500},
}
CELLS = sorted(SMALL)


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_on_the_cpu(workload, seed):
    got = control.control_run(workload, seed, 0.2, device="cpu", capture_overrides=SMALL[workload])
    assert got["correct"] is False
    assert got["checks"]["wrong_answers"]["value"] == got["attempted"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (11, 12, 2**31 + 13):
        got = control.control_run(workload, seed, 2.0)
        print(json.dumps(got))   # the control's readings (run with -s)
        assert got["correct"] is False, got
