"""On the card: a whole run of a cell, the look for a card passed and
everything else as the driver runs it, with the timed path broken
underneath, prints ``correct`` false."""

import json

import pytest
import torch

from portbench import harness, run

CELLS = {w["name"]: w for w in harness.benchmark()["workloads"]}


def last_line(capsys, workload):
    assert run.main(["--workload", workload, "--seed", str(2 ** 32 + 5),
                     "--seconds", "2", "--trace", "0"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _half_rows(monkeypatch):
    from refinedet_tpu_torch.serve.export import ServingModel
    call = ServingModel.__call__

    def broken(self, images):
        out = call(self, images).copy()
        out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(ServingModel, "__call__", broken)


def _moved_boxes(monkeypatch):
    from refinedet_tpu_torch.serve.export import ServingModel
    call = ServingModel.__call__

    def broken(self, images):
        out = call(self, images).copy()
        out[..., 0:4:2] += (out[..., 4:5] > 0) * 0.02
        return out

    monkeypatch.setattr(ServingModel, "__call__", broken)


def _state_unchanged(monkeypatch):
    from refinedet_tpu_torch.train import train_step
    monkeypatch.setattr(train_step.SGD, "apply_gradients",
                        lambda self, step: self.zero_grad())


def _half_batch(monkeypatch):
    from refinedet_tpu_torch.train import train_step
    make = train_step.make_train_step

    def broken(*args, **kw):
        step = make(*args, **kw)

        def half(state, images, boxes, labels, valid):
            n = images.shape[0] // 2
            return step(state, images[:n], boxes[:n], labels[:n], valid[:n])
        return half

    monkeypatch.setattr(train_step, "make_train_step", broken)
    import refinedet_tpu_torch.train as train
    monkeypatch.setattr(train, "make_train_step", broken)


FAULTS = {"train": [_state_unchanged, _half_batch],
          "detect": [_half_rows, _moved_boxes]}
CASES = [(w, f) for w, c in CELLS.items() for f in FAULTS[harness.load_json(
    harness.traffic_path(c["traffic"]))["driver"]]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in CASES])
def test_a_broken_path_is_not_correct(card, capsys, monkeypatch, workload,
                                      fault):
    fault(monkeypatch)
    assert last_line(capsys, workload)["correct"] is False
    torch.cuda.empty_cache()
