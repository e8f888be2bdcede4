"""On the card: the control of each cell (the precision below the
configuration's in the program's place: for the bf16 detection cell the
program's int8 twin) and each fault the cell can have fail the cell's
comparison, and the program as it runs passes it, every cell at its own
size (``portbench.control`` over more seeds set the limits; see
PERF.md)."""

import pytest

from portbench import control, harness, judge

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
FAIL = ("control", "half_left_out", "answer_altered", "state_unchanged")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail(card, workload):
    limits = harness.load_json(harness.limits_path(workload))
    out = control.readings(workload, 2 ** 31 + 77)
    if "sound" in out:
        assert judge.verdict(out["sound"], limits), out["sound"]
    for case in FAIL:
        if case in out:
            assert not judge.verdict(out[case], limits), (case, out[case])
