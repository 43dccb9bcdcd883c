"""Each cell's run, on the CPU at a small size with the program's plain
versions, comes out correct; with the timed path broken underneath it comes
out not correct, once for each fault the cell can have: a pass that returns
its state unchanged, half of the packets left out with the rest counted
double, and an answer altered where it is produced.  (No cell spans chips:
there is no exchange between chips to leave out.)  A trial cell on a toy
generator and a toy reference comes out not correct when its reference
miscounts one entry."""

import numpy as np
import pytest

from gpubench import run
from gpubench.tests.plugins import trial_cell

SMALL = {
    "ref_strings.stream_mega": {"packets": 1500},
}
SEED = 2**31 + 29


def small_run(workload, seed=SEED):
    result, _ = run.run_cell(workload, seed, 0.2, False, device="cpu",
                             capture_overrides=SMALL[workload])
    return result


def _unchanged(counts):
    return np.zeros_like(np.asarray(counts))


def _altered(counts):
    out = np.array(counts, copy=True)
    out[0] += 1
    return out


def break_stream(monkeypatch, fault):
    from multithreading_string_matching_tpu_torch.parallel import pipeline

    ptc = pipeline.PackedTileCounter
    totals, add = ptc.totals, ptc.add
    if fault == "half":
        monkeypatch.setattr(ptc, "add", lambda self, p, l: add(self, p[::2], l[::2]))
        monkeypatch.setattr(ptc, "totals", lambda self: 2 * totals(self))
    else:
        f = _unchanged if fault == "unchanged" else _altered
        monkeypatch.setattr(ptc, "totals", lambda self: f(totals(self)))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    result = small_run(workload)
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    break_stream(monkeypatch, fault)
    result = small_run(workload)
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] == result["attempted"] >= 1


@pytest.mark.parametrize("miscount", [0, 1])
def test_a_trial_reference_that_miscounts_is_not_correct(tmp_path, monkeypatch, miscount):
    workload = trial_cell(tmp_path, monkeypatch, miscount=miscount)
    result, _ = run.run_cell(workload, SEED, 0.2, False, device="cpu")
    checks = {k: c["value"] for k, c in result["checks"].items()}
    if miscount:
        assert result["correct"] is False
        assert checks == {"wrong_answers": result["attempted"], "wrong_entries_max": 1,
                          "payload_bytes_gap": 0}
    else:
        assert result["correct"] is True and set(checks.values()) == {0}
