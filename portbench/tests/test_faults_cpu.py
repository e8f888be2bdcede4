"""On the CPU, at a tiny size: a run past the look for a card, with the
program in float32 so that it equals the reference, reads ``correct``
true; the same run with the timed path broken underneath reads false.
(``test_faults.py`` does the same on the card, at the cells' sizes.)"""

import argparse
import json

import pytest
import torch

from portbench import harness, run
from portbench.tests import test_faults as faults

SMALL = {
    "voc320-train-b64": {"batch": 2, "pool_batches": 3, "staging": 160,
                         "warm_steps": 0},
    "ssdd512-detect-b16": {"batch": 2, "pool_images": 4, "warm_calls": 0,
                           "reference_block": 2},
}
CASES = [("voc320-train-b64", None), ("voc320-train-b64",
                                      faults._state_unchanged),
         ("voc320-train-b64", faults._half_batch),
         ("ssdd512-detect-b16", None), ("ssdd512-detect-b16",
                                        faults._half_rows),
         ("ssdd512-detect-b16", faults._moved_boxes)]


@pytest.fixture
def cpu_cuda(monkeypatch):
    """torch.cuda's clocks and counters as the CPU's stand-ins."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    torch.set_num_threads(4)


@pytest.mark.parametrize("workload,fault", CASES, ids=[
    f"{w}-{f.__name__[1:] if f else 'sound'}" for w, f in CASES])
def test_a_broken_path_is_not_correct(cpu_cuda, capsys, monkeypatch,
                                      workload, fault):
    if fault is not None:
        fault(monkeypatch)
    bench = harness.benchmark()
    args = argparse.Namespace(workload=workload, seed=2 ** 33 + 9,
                              seconds=4.0, trace=0)
    assert run.report(args, bench, harness.cell(bench, workload),
                      torch.device("cpu"), SMALL[workload],
                      {"dtype": "float32"}) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is (fault is None), line["checks"]
