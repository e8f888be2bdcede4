"""Card-only tests of the port: kernel K1 against its plain version, the
CUDA serving path against the CPU one, the training slice (matcher,
losses, one train step, Trainer resume, the BN variant's train-mode
forward) on the card against the CPU, on-device augmentation (the card
against the CPU on the same draws; the augmenting step makes no host
wait), the eval slice (the eval post-process and the Evaluator, kernel path
against plain path; no host sync inside a batch; the host NMS library), and
the serving artifact (exported on the card: the live serving function
exactly, one CUDA graph per bucket exactly as eager, K1 counted per replay,
no host sync inside), the int8 path's kernels (the convolution bitwise
equal to its plain version at every geometry of the 320 set, split-K
plans included, and at odd shapes; the quantize bitwise equal to its
plain version at every served input shape; strided inputs) and the int8
serving artifact (equal to the live int8 function, its launches counted
per replay, no host sync), and data parallelism at world size 1 (NCCL
chosen on the card; the grouped step, DDP with the all-reduced N and the
synced BN, equal to the ungrouped one), and the trained-fixture tools
(the fixture built on the card, the shared training core for 3 steps and
its AP through K1, ``bench_serve`` with 8 requests), the artifact's two
programs (the card's and the CPU's, each exact on its device), the
on-device ``soft_nms`` against the CPU (no host sync),
``profile_trace`` seeing one K1 launch under its op, the program's spans
(no host sync; the step's phases and the call's copies timed), the
space-to-depth stem twin against the standard net, the slice max-pool
backward bitwise against ATen's (and filed under the pool's backward in
a trace), the two bench tools at a small size, and the demo's core
against the CPU.

They skip without a CUDA card. On the card::

    python -m pytest -m gpu tests/test_torch_port_gpu.py -q

This file imports no JAX, so it also runs where JAX is not installed.
"""

import collections

import numpy as np
import pytest
import torch
import torch.distributed as dist

import os

from refinedet_tpu_torch.boxes.geometry import iou_pairwise
from refinedet_tpu_torch.boxes.matcher import refine_match_batch
from refinedet_tpu_torch.boxes.codec import decode
from refinedet_tpu_torch.config import (MEANS, VOC_MEANS, DetectConfig,
                                        TrainConfig)
from refinedet_tpu_torch.data import BaseTransform
from refinedet_tpu_torch.data.augment import augment_batch, sample_draws, \
    select_crop
from refinedet_tpu_torch.data.loader import wait_for_copy
from refinedet_tpu_torch.data.collate import detection_collate
from refinedet_tpu_torch.detect.detection import detect_refinedet
from refinedet_tpu_torch.eval import Evaluator
from refinedet_tpu_torch.eval import evaluator as evaluator_module
from refinedet_tpu_torch.eval.evaluator import eval_postprocess
from refinedet_tpu_torch.models import (build_refinedet, build_refinedet_bn,
                                        layers)
from refinedet_tpu_torch.ops import int8_conv, nms_cuda, nms_native
from refinedet_tpu_torch.ops.nms import nms_sweep_reference, soft_nms
from refinedet_tpu_torch.parallel import distributed
from refinedet_tpu_torch.losses import refinedet_multibox_loss
from refinedet_tpu_torch.quant import DEFAULT_QUANT_SKIP, quantize_variables
from refinedet_tpu_torch.serve.export import (ServingModel,
                                              fused_nms_settings,
                                              fused_postprocess,
                                              load_serving, make_serving_fn,
                                              model_on, save_serving)
from refinedet_tpu_torch.tools import (bench_pool_backward, bench_serve,
                                       bench_stem_s2d, demo, fixture_train,
                                       int8_bench)
from refinedet_tpu_torch.tools.fixtures import coco_fixture
from refinedet_tpu_torch.tools.eval_check import (SyntheticSSDD,
                                                  SyntheticVOC)
from refinedet_tpu_torch.tools.train_check import (SyntheticDetection,
                                                   StagedSyntheticDetection,
                                                   biases_before_bn,
                                                   crop_near_ties,
                                                   one_step,
                                                   separated_batch,
                                                   update_rel_errors)
from refinedet_tpu_torch.train import (Trainer, create_train_state,
                                       make_optimizer, make_train_step)
from refinedet_tpu_torch.utils import timer
from refinedet_tpu_torch.utils.timer import profile_trace, span
from refinedet_tpu_torch.utils.trace_summary import trace_stats

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _candidates(rng, g, k, scale):
    xy = rng.uniform(0, 0.8 * scale, (g, k, 2))
    wh = rng.uniform(0.02 * scale, 0.3 * scale, (g, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(g, k)) < 0.8  # non-prefix
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("g,k", [
    (640, 200), (160, 1024), (3, 7),
    # ragged K around the 64-column words, one group each
    (1, 1), (1, 63), (1, 64), (1, 65), (1, 129), (1, 1000), (1, 1024),
    (3, "limit")])  # K = the kernel's largest
def test_kernel_matches_plain(cuda, g, k, plus_one):
    if k == "limit":
        k = nms_cuda.load_kernel().max_k
    rng = np.random.RandomState(g + k)
    boxes, valid = _candidates(rng, g, k, 320.0 if plus_one else 1.0)
    want = nms_sweep_reference(boxes, valid, 0.45, plus_one)
    before = nms_cuda.nms_sweep.launches
    got = nms_cuda.nms_sweep(boxes.to(cuda), valid.to(cuda), 0.45, plus_one)
    torch.cuda.synchronize()
    assert nms_cuda.nms_sweep.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_kernel_limit(cuda):
    max_k = nms_cuda.load_kernel().max_k
    assert max_k >= 11068  # no lower than the first kernel's limit
    boxes = torch.zeros(1, max_k + 1, 4, device=cuda)
    valid = torch.ones(1, max_k + 1, dtype=torch.bool, device=cuda)
    before = nms_cuda.nms_sweep.launches
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        nms_cuda.nms_sweep(boxes, valid, 0.45)  # no fallback to the plain
    assert nms_cuda.nms_sweep.launches == before


def test_kernel_edge_cases(cuda):
    same = torch.tensor([[10.0, 10.0, 50.0, 60.0]]).repeat(2, 300, 1)
    zero = torch.tensor([[5.0, 5.0, 5.0, 5.0]]).repeat(2, 300, 1)
    # widths of -0 and +0: the plain version's + 0.0 makes them +0
    signed = torch.tensor([[-0.0, -0.0, 0.0, 0.0], [0.0, 0.0, -0.0, 1.0],
                           [-0.0, 0.0, 1.0, -0.0]]).repeat(2, 100, 1)
    masks = [torch.ones(2, 300, dtype=torch.bool),
             torch.zeros(2, 300, dtype=torch.bool),
             torch.arange(300).remainder(7).eq(3).repeat(2, 1)]
    for boxes in (same, zero, signed):
        for valid in masks:
            for plus_one in (False, True):
                want = nms_sweep_reference(boxes, valid, 0.45, plus_one)
                got = nms_cuda.nms_sweep(boxes.to(cuda), valid.to(cuda),
                                         0.45, plus_one)
                assert torch.equal(got.cpu(), want)
    # the wrapper raises rather than fall back to the plain version
    with pytest.raises(ValueError, match="contiguous"):
        nms_cuda.nms_sweep(same.to(cuda).transpose(0, 1), masks[0].to(cuda).t(),
                           0.45)


def _assert_separated(h_gpu, h_cpu, priors, opts):
    def scored(h):
        return detect_refinedet(h[0], h[1].softmax(-1), h[2],
                                h[3].softmax(-1), priors.to(h[0].device))

    boxes, scores = scored(h_cpu)
    drift = float((scored(h_gpu)[1].cpu() - scores).abs().max())
    for b in range(scores.shape[0]):
        for c in range(1, scores.shape[2]):
            best, order = torch.sort(scores[b, :, c], descending=True,
                                     stable=True)
            n = int((best[:opts.nms_top_k + 1] > opts.conf_thresh).sum())
            gaps = best[:n - 1] - best[1:n]
            assert n < 2 or float(gaps.min()) > 2 * drift
            cand = boxes[b, order[:min(n, opts.nms_top_k)]]
            iou = iou_pairwise(cand, cand).fill_diagonal_(0.0)
            assert float((iou - opts.nms_thresh).abs().min()) > 1e-4


def test_cuda_serving_matches_cpu(cuda):
    cpu_model = build_refinedet("test", 320, 3, device="cpu", seed=1)
    gpu_model = build_refinedet("test", 320, 3, device=cuda, seed=1)
    img = torch.from_numpy(np.random.RandomState(4).randn(
        2, 320, 320, 3).astype(np.float32))
    with torch.inference_mode():
        h_cpu = cpu_model.raw_forward(img)
        h_gpu = gpu_model.raw_forward(img.to(cuda))
        for a, b in zip(h_cpu, h_gpu):
            # cuDNN and oneDNN sum in different orders (TF32 off).
            torch.testing.assert_close(b.cpu(), a, rtol=1e-4,
                                       atol=1e-4 * float(a.abs().max()))
        # The same heads through the post-process: K1 on the card, the
        # plain version on the CPU. Row order and keep sets are exact,
        # given that the two devices' softmax and exp, which may differ in
        # the last ulp, can neither reorder candidates nor move an IoU
        # across the threshold.
        opts = fused_nms_settings(3, {})
        _assert_separated([h.to(cuda) for h in h_cpu], h_cpu,
                          cpu_model.priors, opts)
        want = fused_postprocess(h_cpu, cpu_model.priors, opts)
        before = nms_cuda.nms_sweep.launches
        got = fused_postprocess([h.to(cuda) for h in h_cpu],
                                gpu_model.priors, opts)
        assert nms_cuda.nms_sweep.launches == before + 1
    got = got.cpu()
    assert torch.equal(got[..., 4] > 0, want[..., 4] > 0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # And the numpy serving function end to end on the card.
    dets = make_serving_fn(gpu_model, None, fused_nms={})(img.numpy())
    assert dets.shape == (2, 2, 200, 5) and np.isfinite(dets).all()


def _heads_and_targets(seed, p, c=4, b=2, m=8):
    rng = np.random.RandomState(seed)
    heads = [(rng.randn(b, p, 4) * 0.5).astype(np.float32),
             rng.randn(b, p, 2).astype(np.float32),
             (rng.randn(b, p, 4) * 0.5).astype(np.float32),
             rng.randn(b, p, c).astype(np.float32)]
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        n = rng.randint(2, m)
        xy = rng.uniform(0, 0.7, (n, 2))
        boxes[i, :n] = np.hstack([xy, xy + rng.uniform(0.05, 0.3, (n, 2))])
        labels[i, :n] = rng.randint(1, c, n)
        valid[i, :n] = True
    return heads, (boxes, labels, valid)


def _assert_odm_separated(arm_loc, targets, priors):
    """No ODM IoU within 1e-6 of the threshold and each GT's best decoded
    anchor ahead of its second best by more than 1e-6, so the two devices'
    last-ulp differences in exp cannot flip a match."""
    anchors = decode(torch.from_numpy(arm_loc), priors, (0.1, 0.2))
    boxes, _, valid = targets
    for b in range(len(boxes)):
        iou = iou_pairwise(torch.from_numpy(boxes[b][valid[b]]), anchors[b])
        top2 = iou.topk(2, dim=1).values
        assert float((iou - 0.5).abs().min()) > 1e-6
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-6


@pytest.mark.parametrize("use_arm", [False, True], ids=["arm", "odm"])
def test_matcher_and_loss_on_card_match_cpu(cuda, use_arm):
    priors = build_refinedet("train", 320, 4, device="cpu").priors
    heads, targets = _heads_and_targets(0, len(priors))
    _assert_odm_separated(heads[0], targets, priors)
    cpu = [torch.from_numpy(x) for x in (*heads, priors.numpy(), *targets)]
    results = []
    for dev in ("cpu", cuda):
        t = [x.to(dev, copy=True) for x in cpu]
        for x in t[:4]:
            x.requires_grad_(True)
        match = refine_match_batch(*t[5:], t[4], (0.1, 0.2), 0.5,
                                   arm_loc=t[0].detach() if use_arm else None)
        out = refinedet_multibox_loss(tuple(t[:5]), *t[5:],
                                      num_classes=4 if use_arm else 2,
                                      use_arm=use_arm)
        (out.loss_l + out.loss_c).backward()
        results.append((match, out, [x.grad for x in t[:4]]))
    (cm, co, cg), (gm, go, gg) = results
    # IEEE-exact elementwise ops: the ARM matching is bitwise equal; the
    # ODM decode's exp may differ in the last ulp.
    assert torch.equal(gm.conf_t.cpu(), cm.conf_t)
    torch.testing.assert_close(gm.loc_t.cpu(), cm.loc_t, rtol=1e-5,
                               atol=1e-5)
    assert float(co.num_pos) > 0 and float(go.num_pos) == float(co.num_pos)
    for a, b in zip(go[:2], co[:2]):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=0)
    for a, b in zip(gg, cg):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 step at batch 2 (VOC, 21 classes, max_boxes 60) from the
    same weights and batch: losses rtol 2e-4, each parameter's update a
    relative L2 norm of 2e-2."""
    cfg = TrainConfig(max_boxes=60)
    cpu_model = build_refinedet("train", 320, 21, device="cpu", seed=0)
    _, batch = separated_batch(cpu_model, 2, 60, 21, cfg.theta,
                               cfg.overlap_thresh)
    gpu_model = build_refinedet("train", 320, 21, device=cuda, seed=0)
    want, want_up = one_step(cpu_model, batch, cfg, cfg.lr)
    got, got_up = one_step(gpu_model, batch, cfg, cfg.lr)
    for k in ("arm_loss_l", "arm_loss_c", "odm_loss_l", "odm_loss_c"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
    rel = update_rel_errors(got_up, want_up)
    assert len(rel) > 50 and max(rel.values()) < 2e-2, max(rel.items(),
                                                            key=lambda kv:
                                                            kv[1])


def test_bn_train_forward_on_card_matches_cpu(cuda):
    """A train-mode forward of RefineDet320-BN (batch 2, f32) on the card
    equals the CPU's, heads and running statistics (which follow flax's
    biased variance on both) at rtol 1e-4 of each tensor's largest
    magnitude, with no host sync inside."""
    cpu_model = build_refinedet_bn("train", 320, 21, device="cpu", seed=2)
    gpu_model = build_refinedet_bn("train", 320, 21, device=cuda, seed=2)
    img = torch.from_numpy(np.random.RandomState(4).randn(
        2, 320, 320, 3).astype(np.float32))
    x = img.to(cuda)
    with torch.no_grad():
        gpu_model.raw_forward(x, train=True)  # warm-up: cuDNN's plans
        gpu_model.net.load_state_dict(cpu_model.net.state_dict())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            h_gpu = gpu_model.raw_forward(x, train=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        h_cpu = cpu_model.raw_forward(img, train=True)
    for a, b in zip(h_cpu, h_gpu):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))
    want = cpu_model.net.state_dict()
    stats = 0
    for k, v in gpu_model.net.state_dict().items():
        if ".running_" in k:
            torch.testing.assert_close(v.cpu(), want[k], rtol=1e-4,
                                       atol=1e-4 * float(want[k].abs().max()))
            stats += 1
        elif "num_batches" in k:
            assert int(v) == int(want[k]) == 1
    assert stats == 2 * 17


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_never_waits_for_the_card(cuda, dtype):
    """The step (forward, matching, losses, backward, optimizer, EMA)
    makes no blocking copy and no synchronization: the host stays ahead
    of the card. Only reading the metrics waits."""
    model = build_refinedet("train", 320, 21, device=cuda, dtype=dtype)
    data = SyntheticDetection(2, seed=4)
    batch = [torch.from_numpy(a).to(cuda) for a in detection_collate(
        [data[i] for i in range(2)], 60)]
    cfg = TrainConfig(max_boxes=60, grad_clip_norm=10.0, ema_decay=0.99)
    opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                         grad_clip_norm=10.0)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt, ema=True)
    state, _ = step(state, *batch)  # warm-up: lazy init may sync once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, *batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))


def test_augmented_train_step_never_waits_for_the_card(cuda):
    """With on-device augmentation (uint8 staged at 640) the step, the
    draws and the augmentation included, makes no blocking copy and no
    synchronization."""
    model = build_refinedet("train", 320, 21, device=cuda,
                            dtype=torch.bfloat16)
    data = StagedSyntheticDetection(2, 640, seed=4)
    batch = [torch.from_numpy(a).to(cuda) for a in detection_collate(
        [data[i] for i in range(2)], 60)]
    assert batch[0].dtype == torch.uint8
    cfg = TrainConfig(max_boxes=60, grad_clip_norm=10.0,
                      on_device_augment=True, mean=VOC_MEANS)
    opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                         grad_clip_norm=10.0)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    state, _ = step(state, *batch)  # warm-up: lazy init may sync once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, *batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))


def test_augment_batch_on_card_matches_cpu(cuda):
    """The same draws and staged images on both devices: images 1e-3
    absolute on the 0-255 scale (the resample's sums), boxes 1e-5, the
    trial taken and the kept boxes exact away from a crop test within
    1e-5 of its threshold."""
    data = StagedSyntheticDetection(6, 640, seed=5)
    b = detection_collate([data[i] for i in range(6)], 60)
    cpu = [torch.from_numpy(a) for a in b]
    card = [t.to(cuda) for t in cpu]
    draws = sample_draws(torch.Generator().manual_seed(1), 6)
    want = augment_batch(cpu[0], cpu[1], cpu[3], draws, 320, VOC_MEANS)
    got = augment_batch(card[0], card[1], card[3], draws.to(cuda), 320,
                        VOC_MEANS)
    differ = ((select_crop(card[1], card[3], draws.to(cuda), 640.0, 640.0)
               .trial.cpu()
               != select_crop(cpu[1], cpu[3], draws, 640.0, 640.0).trial)
              | (got[2].cpu() != want[2]).any(1))
    near = crop_near_ties(cpu[1], cpu[3], draws, 640.0, 640.0)
    assert not (differ & ~near).any()
    same = ~differ
    torch.testing.assert_close(got[0].cpu()[same], want[0][same], rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(got[1].cpu()[same], want[1][same], rtol=0,
                               atol=1e-5)


def test_trainer_resume_on_card(cuda, tmp_path):
    data = SyntheticDetection(4, seed=3)
    cfg = TrainConfig(batch_size=2, max_boxes=60, max_epoch=10,
                      num_workers=2, grad_clip_norm=10.0)

    def trainer(seed):
        return Trainer(build_refinedet("train", 320, 21, device=cuda,
                                       seed=seed), data, cfg,
                       save_folder=str(tmp_path), log_fn=lambda line: None)

    live = trainer(0)
    state = live.train()
    assert state.step == 20
    assert os.path.exists(live.ckpt.path(10))
    assert os.path.exists(live.ckpt.path("final"))
    fresh = trainer(1)
    rstate = fresh.resume(10)
    assert rstate.step == 20
    for a, b in zip(live.optimizer.state_dict()["state"].values(),
                    fresh.optimizer.state_dict()["state"].values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    fixed = [torch.from_numpy(a).to(cuda) for a in detection_collate(
        [data[i] for i in range(2)], 60)]
    torch.backends.cudnn.deterministic = True
    try:
        live.train_step(state, *fixed)
        fresh.train_step(rstate, *fixed)
    finally:
        torch.backends.cudnn.deterministic = False
    for (k, a), b in zip(live.model.net.state_dict().items(),
                         fresh.model.net.state_dict().values()):
        assert torch.equal(a, b), k


# -- the eval slice ------------------------------------------------------------

# (size, classes, data, cfg, nms_top_k, plus_one, mean): the VOC CLI's
# path (G = 8 * 20, K = 300) and the COCO/SSDD CLI's (G = 8, K = 1000, +1)
EVAL_PATHS = {
    "voc": (320, 21, lambda n: SyntheticVOC(n, 320, seed=7),
            DetectConfig(num_classes=21, nms_thresh=0.45), 300, False,
            VOC_MEANS),
    "ssdd": (512, 2, lambda n: SyntheticSSDD(n, 512, seed=7),
             DetectConfig(num_classes=2, nms_thresh=0.49), 1000, True,
             MEANS),
}


def _evaluator(cuda, path, n, dtype=torch.bfloat16):
    size, classes, data, cfg, top_k, plus_one, mean = EVAL_PATHS[path]
    model = build_refinedet("test", size, classes, device=cuda, dtype=dtype)
    return Evaluator(model, data(n), cfg, BaseTransform(size, mean),
                     batch_size=8, nms_top_k=top_k, plus_one=plus_one,
                     log=lambda line: None)


@pytest.mark.parametrize("path", ["voc", "ssdd"])
def test_eval_postprocess_kernel_matches_plain(cuda, path):
    """At both eval shapes, on random-weight heads (huge and zero-area
    pixel boxes among the candidates): the kernel path equals the plain
    path exactly, with one K1 launch."""
    ev = _evaluator(cuda, path, 8)
    (_, (imgs, scales), ready), = list(ev._staged_batches(8))
    with torch.inference_mode():
        wait_for_copy([imgs, scales], ready)
        heads = ev.model.raw_forward(imgs)
        before = nms_cuda.nms_sweep.launches
        got = eval_postprocess(heads, ev.model.priors, scales, ev.cfg,
                               ev.nms_top_k, ev.plus_one)
        assert nms_cuda.nms_sweep.launches == before + 1
        want = eval_postprocess(heads, ev.model.priors, scales, ev.cfg,
                                ev.nms_top_k, ev.plus_one, plain=True)
    assert got.shape == (8, ev.num_classes - 1, ev.nms_top_k, 5)
    assert int((got[..., 4] > 0).sum()) > 100
    assert torch.equal(got, want)


def test_evaluator_on_card_matches_plain(cuda, monkeypatch):
    """A small eval set (12 images: one full batch, one padded) through
    the Evaluator twice: K1 once per batch, and the same all_boxes as
    with the plain post-process."""
    ev = _evaluator(cuda, "voc", 12)
    before = nms_cuda.nms_sweep.launches
    got = ev.run()
    assert nms_cuda.nms_sweep.launches == before + 2
    monkeypatch.setattr(evaluator_module, "eval_postprocess",
                        lambda *a: eval_postprocess(*a, plain=True))
    want = ev.run()
    assert nms_cuda.nms_sweep.launches == before + 2
    n = 0
    for g_cls, w_cls in zip(got[1:], want[1:]):
        for g, w in zip(g_cls, w_cls):
            assert np.array_equal(g, w)
            n += len(g)
    assert n > 100


def test_evaluator_batch_never_syncs(cuda):
    """Staging, forward, post-process and K1 make no blocking copy and no
    synchronization; the batch's one wait is on the event after its
    detections' copy to pinned memory, which the debug mode does not
    count."""
    ev = _evaluator(cuda, "ssdd", 8)
    ev.run()  # warm-up: the kernel's build, cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        all_boxes = ev.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(all_boxes[1]) == 8


def test_nms_native_on_the_card_host(cuda):
    lib = nms_native.load_library()
    assert "_build" in lib._name
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 200, (300, 2))
    dets = np.hstack([xy, xy + rng.uniform(10, 80, (300, 2)),
                      rng.uniform(0, 1, (300, 1))]).astype(np.float32)
    for plus_one in (True, False):
        assert nms_native.nms(dets, 0.45, plus_one=plus_one) == \
            nms_native._numpy_nms(dets, 0.45, plus_one)
    keep = nms_native.soft_nms(dets.copy(), method="gaussian")
    assert 0 < len(keep) <= 300


@pytest.fixture(scope="module")
def card_artifact(tmp_path_factory):
    """RefineDet320 (VOC, 21 classes) in bf16, exported with fused NMS and
    a symbolic batch for the card and the CPU into one file, written, and
    its card program loaded back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    model = build_refinedet("test", 320, 21, dtype=torch.bfloat16,
                            device="cuda", seed=0)
    path = tmp_path_factory.mktemp("artifact") / "refinedet320.rdtpu"
    meta = save_serving(model, None, str(path), fused_nms={},
                        platforms=("cuda", "cpu"))
    assert meta["platforms"] == ["cuda", "cpu"]
    assert meta["dtype"] == "bfloat16"
    loaded = load_serving(str(path))
    assert loaded.meta["device"] == "cuda:0"
    return model, make_serving_fn(model, None, fused_nms={}), loaded, path


def test_two_program_artifact_cpu_program(card_artifact):
    """The same file's CPU program equals the live function of the
    model's CPU copy exactly; the card's model is not moved."""
    model, _, _, path = card_artifact
    host = load_serving(str(path), device="cpu")
    assert host.meta["device"] == "cpu"
    assert model.priors.is_cuda and next(model.net.parameters()).is_cuda
    imgs = _noise(2, 1)
    np.testing.assert_array_equal(
        host(imgs), make_serving_fn(model_on(model, "cpu"), None,
                                    fused_nms={})(imgs))


def _noise(seed, b):
    raw = np.random.RandomState(seed).randint(0, 256, (b, 320, 320, 3))
    return (raw - np.asarray(VOC_MEANS[::-1])).astype(np.float32)


@pytest.mark.parametrize("batch", [1, 5])
def test_cuda_artifact_matches_live(card_artifact, batch):
    _, live, serving, _ = card_artifact
    imgs = _noise(batch, batch)
    before = nms_cuda.nms_sweep.launches
    got = serving(imgs)
    assert nms_cuda.nms_sweep.launches == before + 1
    assert got.shape == (batch, 20, 200, 5)
    assert int((got[..., 4] > 0).sum()) > 100 * batch
    np.testing.assert_array_equal(got, live(imgs))


def test_bucket_graphs_replay_eager_and_count_k1(card_artifact):
    """Each bucket's graph replay equals the eager program exactly, and
    adds one K1 launch, which the capture itself did not count."""
    _, _, loaded, _ = card_artifact
    serving = ServingModel(loaded.meta, loaded.program)
    buckets = (1, 2, 4, 8)
    captured = nms_cuda.nms_sweep.captured
    serving.warm_up(buckets)
    assert sorted(serving.graphs) == list(buckets)
    assert nms_cuda.nms_sweep.captured == captured + len(buckets)
    for b in buckets:
        assert serving.graphs[b].launches == 1
        imgs = _noise(10 + b, b)
        before = nms_cuda.nms_sweep.launches
        got = serving(imgs)
        got_again = serving(imgs)
        assert nms_cuda.nms_sweep.launches == before + 2
        with torch.inference_mode():
            want = serving.module(torch.from_numpy(imgs).cuda()).cpu()
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got_again, got)


def test_fused_artifact_never_syncs(card_artifact):
    """The exported program (forward, post-process, K1) makes no blocking
    copy and no synchronization, so it can be captured in a graph."""
    _, _, serving, _ = card_artifact
    x = torch.from_numpy(_noise(3, 4)).cuda()
    with torch.inference_mode():
        serving.module(x)  # warm-up: cuDNN plans of this shape
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dets = serving.module(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert dets.shape == (4, 20, 200, 5)


# -- the int8 convolution and the int8 serving path ----------------------------

def _int8_cases():
    """Every distinct quantized conv of RefineDet320 (quant_skip=()):
    its real input shape and geometry."""
    return int8_bench.distinct(int8_bench.conv_shapes(320, 21, ()))


@pytest.mark.parametrize("batch", [1, 5, 32])
def test_int8_conv_matches_plain(cuda, batch):
    """The kernel bitwise equal to the plain version at every geometry of
    the 320 set: the int32 sums, and the bf16 and f32 outputs. At batch
    32 the 5x5 and 10x10 levels split K."""
    splits = 0
    for i, case in enumerate(_int8_cases()):
        xq, w, ws, bias = int8_bench.random_case(case, batch, cuda, i)
        k, s, p, d = case["geom"]
        splits += int8_conv.plan(batch, *case["hwc"], case["o"], k, s, p,
                                 d).splits > 1
        before = int8_conv.int8_conv.launches
        for dtype in (torch.int32, torch.bfloat16, torch.float32):
            got = int8_conv.int8_conv(xq, w, ws, bias, s, p, d, dtype)
            want = int8_conv.int8_conv_reference(xq, w, ws, bias, s, p, d,
                                                 dtype)
            assert got.dtype == dtype and got.is_contiguous()
            assert torch.equal(got, want), (case["names"], dtype)
        assert int8_conv.int8_conv.launches == before + 3
    assert splits > 0


@pytest.mark.parametrize("shape,o,geom", [
    ((2, 11, 9, 64), 128, (3, 2, 1, 1)),  # odd input, stride 2
    ((3, 9, 13, 32), 64, (3, 1, 1, 1)),   # 32-byte K steps
    ((3, 7, 7, 96), 192, (3, 1, 1, 1)),   # O a multiple of 64 only
    ((1, 5, 5, 128), 64, (1, 1, 0, 1)),
    ((2, 10, 10, 512), 1024, (3, 1, 3, 3)),
])
def test_int8_conv_odd_shapes(cuda, shape, o, geom):
    case = {"hwc": shape[1:], "o": o, "geom": geom}
    xq, w, ws, bias = int8_bench.random_case(case, shape[0], cuda, 3)
    k, s, p, d = geom
    for dtype in (torch.int32, torch.bfloat16):
        got = int8_conv.int8_conv(xq, w, ws, bias, s, p, d, dtype)
        assert torch.equal(got, int8_conv.int8_conv_reference(
            xq, w, ws, bias, s, p, d, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_quantize_matches_plain(cuda, dtype):
    """The quantize kernel bitwise equal to its plain version at every
    input shape of the served convs (batches 1 and 32), edge values
    included, and at a C that takes its one-element path."""
    shapes = int8_bench.conv_shapes(320, 21, DEFAULT_QUANT_SKIP)
    inputs = list(dict.fromkeys(c["hwc"] for c in shapes)) + [(3, 5, 37)]
    for batch in (1, 32):
        for i, hwc in enumerate(inputs):
            x, scale = int8_bench.quantize_case(hwc, batch, dtype, cuda, i)
            before = int8_conv.int8_quantize.launches
            got = int8_conv.int8_quantize(x, scale)
            assert int8_conv.int8_quantize.launches == before + 1
            assert got.dtype == torch.int8 and got.shape == x.shape
            assert torch.equal(got, int8_conv.int8_quantize_reference(
                x, scale)), (hwc, batch)


def test_int8_quantize_strided_input_is_copied(cuda):
    x, scale = int8_bench.quantize_case((6, 5, 64), 2, torch.bfloat16,
                                        cuda, 0)
    strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    before = int8_conv.int8_quantize.copies
    got = torch.ops.refinedet_tpu_torch.int8_quantize(strided, scale)
    assert int8_conv.int8_quantize.copies == before + 1
    assert torch.equal(got, int8_conv.int8_quantize_reference(x, scale))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        int8_conv.int8_quantize(x.half(), scale)


def test_int8_conv_strided_inputs_and_refusals(cuda):
    """The op takes strided views (an exported program may hand it some);
    the wrapper refuses shapes the kernel does not take."""
    case = _int8_cases()[2]
    xq, w, ws, bias = int8_bench.random_case(case, 2, cuda, 7)
    nchw = xq.permute(0, 3, 1, 2).contiguous()
    strided = nchw.permute(0, 2, 3, 1)  # NHWC view of NCHW memory
    assert not strided.is_contiguous()
    wide = torch.stack([w, w], dim=-1)[..., 0]  # strided, same values
    assert not wide.is_contiguous() and torch.equal(wide, w)
    want = int8_conv.int8_conv_reference(xq, w, ws, bias, 1, 1, 1,
                                         torch.bfloat16)
    got = torch.ops.refinedet_tpu_torch.int8_conv(
        strided, wide, ws, bias, 1, 1, 1, torch.bfloat16)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_conv.int8_conv(xq[..., :48].contiguous(),
                            w[..., :48].contiguous(), ws, bias, 1, 1, 1)
    with pytest.raises(ValueError, match="multiple of 64"):
        int8_conv.int8_conv(xq, w[:96].contiguous(), ws[:96], bias[:96])
    with pytest.raises(ValueError, match="stride 1 or 2"):
        int8_conv.int8_conv(xq, w, ws, bias, 3, 1, 1)


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    """RefineDet320 (21 classes) quantized from made-up statistics, bf16,
    exported on the card with fused NMS, written and loaded back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    model = build_refinedet("test", 320, 21, dtype=torch.bfloat16,
                            device="cuda", seed=0)
    model_q = build_refinedet("test", 320, 21, dtype=torch.bfloat16,
                              device="cuda", quant=True,
                              quant_skip=DEFAULT_QUANT_SKIP)
    model_q.net.load_state_dict(quantize_variables(
        model_q, model.net.state_dict(),
        int8_bench.made_up_stats(model_q.net, 0)))
    path = tmp_path_factory.mktemp("int8") / "refinedet320_int8.rdtpu"
    meta = save_serving(model_q, None, str(path), fused_nms={})
    assert meta["int8"] and meta["quant_skip"] == list(DEFAULT_QUANT_SKIP)
    return model_q, make_serving_fn(model_q, None, fused_nms={}), \
        load_serving(str(path))


def test_int8_artifact_graphs_equal_live_and_count(int8_artifact):
    """The int8 artifact equals the live int8 function exactly; each
    bucket's graph holds 26 int8 conv launches, 26 quantize launches and
    one K1 launch, which every replay adds to the counts."""
    _, live, loaded = int8_artifact
    imgs = _noise(21, 2)
    np.testing.assert_array_equal(loaded(imgs), live(imgs))
    serving = ServingModel(loaded.meta, loaded.program)
    serving.warm_up((1, 2))
    for b in (1, 2):
        graph = serving.graphs[b]
        assert (graph.int8_launches, graph.quant_launches,
                graph.launches) == (26, 26, 1)
        imgs = _noise(30 + b, b)
        before = (int8_conv.int8_conv.launches,
                  int8_conv.int8_quantize.launches,
                  nms_cuda.nms_sweep.launches)
        got = serving(imgs)
        assert (int8_conv.int8_conv.launches - before[0],
                int8_conv.int8_quantize.launches - before[1],
                nms_cuda.nms_sweep.launches - before[2]) == (26, 26, 1)
        np.testing.assert_array_equal(got, live(imgs))


def test_int8_forward_never_syncs(int8_artifact):
    """The int8 serving function (quantize, kernel, epilogue, K1) makes no
    blocking copy and no synchronization."""
    _, _, serving = int8_artifact
    x = torch.from_numpy(_noise(4, 4)).cuda()
    with torch.inference_mode():
        serving.module(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dets = serving.module(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert dets.shape == (4, 20, 200, 5)


# -- data parallelism at world size 1 -------------------------------------------

@pytest.fixture(scope="module")
def nccl_world1():
    """A one-rank process group on card 0, for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert distributed.maybe_initialize(
        f"tcp://localhost:{distributed.free_port()}", 1, 0)
    yield distributed.default_group()
    dist.destroy_process_group()


def test_maybe_initialize_takes_nccl_on_the_card(cuda, nccl_world1):
    assert dist.get_backend(nccl_world1) == "nccl"
    assert distributed.local_device("cuda") == torch.device("cuda", 0)
    assert torch.cuda.current_device() == 0
    assert distributed.maybe_initialize()  # a second call is a no-op
    assert (distributed.process_index(), distributed.process_count()) == \
        (0, 1)


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_grouped_step_at_world1_equals_ungrouped(cuda, nccl_world1, use_bn):
    """One step under the group (DDP over NCCL, the all-reduced N, the
    BN variant's synced statistics in flax's formula) against today's
    step, from the same weights on the same batch: RefineDet320 in f32
    (losses rtol 2e-4, each update 2e-2), RefineDet320-BN in float64
    (also the running statistics 1e-4 of each tensor's largest; the
    conv biases that feed a BN left out: their gradient is zero)."""
    cfg = TrainConfig(max_boxes=8)
    data = SyntheticDetection(4, 320, 21, seed=5)
    batch = detection_collate([data[i] for i in range(4)], 8)
    runs = []
    for group in (None, nccl_world1):
        model = build_refinedet("train", 320, 21, use_bn=use_bn,
                                device=cuda, seed=0)
        if use_bn:
            model.net.double()
        runs.append(one_step(model, batch, cfg, lr=cfg.lr, group=group))
    (want, want_up), (got, got_up) = runs
    for k in ("arm_loss_l", "arm_loss_c", "odm_loss_l", "odm_loss_c"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
    assert got["num_pos_odm"] == want["num_pos_odm"] > 0
    skip = biases_before_bn(model.net)
    params = {k for k, _ in model.net.named_parameters()} - skip
    rel = update_rel_errors(got_up, {k: want_up[k] for k in params})
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 2e-2, (worst, rel[worst])
    stats = [k for k in want_up if ".running_" in k]
    assert len(stats) == (34 if use_bn else 0)
    for k in stats:
        w = want_up[k]
        assert float((got_up[k] - w).abs().max()) <= \
            1e-4 * float(w.abs().max()), k


# -- the trained-fixture tools -----------------------------------------------

def test_tools_fixture_on_the_card(cuda):
    """The fixture upsampled on the card: within one grey level of the
    CPU's (rounding at .5), the same targets and ground truth."""
    got, want = coco_fixture(4, 3, 320, cuda), coco_fixture(4, 3, 320, "cpu")
    for a, b in zip(got.images, want.images):
        assert a.dtype == np.uint8 and a.shape == (320, 320, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for (gb, gl), (wb, wl) in zip(got.targets, want.targets):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)
    assert got._COCO.dataset == want._COCO.dataset


def test_fixture_train_three_steps_on_the_card(cuda):
    """``train_from_scratch`` for 3 bf16 steps (every loss logged, finite)
    and ``ap_of`` through the Evaluator: one K1 launch for one batch."""
    ds = coco_fixture(4, 3, 320, cuda)
    lines = []
    model, logged = fixture_train.train_from_scratch(
        0, 320, 2, 3, 2, ds, fixture_train.decay_schedule(3), cuda,
        log_every=1, log=lines.append)
    assert [it for it, _ in logged] == [0, 1, 2, 2]
    assert all(np.isfinite(loss) for _, loss in logged)
    before = nms_cuda.nms_sweep.launches
    ap = fixture_train.ap_of(build_refinedet("test", 320, 2,
                                             dtype=torch.bfloat16,
                                             device=cuda),
                             fixture_train.net_state(model.net), ds)
    assert nms_cuda.nms_sweep.launches - before == 1
    assert 0.0 <= ap["ap"] <= ap["ap50"] <= 1.0


def test_bench_serve_on_the_card(cuda):
    """8 requests from 4 clients through the engine (twice) and HTTP on a
    fused-NMS artifact: none fails, K1 runs in the graphs."""
    out = bench_serve.main(["--requests", "8", "--clients", "4",
                            "--max_batch", "4", "--fused_nms"])
    assert set(out["results"]) == {"engine-warm", "engine", "http"}
    for leg in out["results"].values():
        assert leg["errors"] == 0 and leg["ok"] == 8
    assert out["fused_nms"] and out["launches"]["nms_sweep"] >= 3


# -- soft-NMS on the card, and the profiler -------------------------------------

def _soft_set(seed, n=200):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 240, (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(
        rng.uniform(0.01, 1.0, n).astype(np.float32))


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_on_the_card_matches_the_cpu(cuda, method):
    """Indices and keep equal the CPU's exactly; scores bitwise for linear
    and hard, within 20 ulps for gaussian (the card's exp is not the
    CPU's); the rounds make no host sync."""
    boxes, scores = _soft_set(1)
    want = soft_nms(boxes, scores, method=method)
    b, s = boxes.to(cuda), scores.to(cuda)
    soft_nms(b, s, method=method)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = soft_nms(b, s, method=method)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.indices.cpu(), want.indices)
    assert torch.equal(got.keep.cpu(), want.keep)
    a, w = got.scores.cpu().numpy(), want.scores.numpy()
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - w.view(np.int32).astype(np.int64)).max()
    assert ulps <= (20 if method == "gaussian" else 0)


def test_profile_trace_sees_one_k1_launch(cuda, tmp_path):
    """One K1 launch under ``profile_trace``: the trace's summary finds
    its kernel under the op ``refinedet_tpu_torch::nms_sweep``, inside
    the annotated execution."""
    boxes, valid = _candidates(np.random.RandomState(0), 64, 200, 1.0)
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    nms_cuda.nms_sweep(boxes, valid, 0.45)  # build and warm up
    before = nms_cuda.nms_sweep.launches
    with profile_trace(str(tmp_path)):
        with span("k1"):
            nms_cuda.nms_sweep(boxes, valid, 0.45)
    assert nms_cuda.nms_sweep.launches == before + 1
    stats = trace_stats(str(tmp_path))
    assert stats["handwritten_calls"] == {"nms_sweep (K1)": 1}
    assert stats["categories_ms"]["nms_sweep (K1)"] > 0
    assert [x["name"] for x in stats["executions"]] == ["k1"]


def test_spans_on_the_card_add_no_sync(cuda, card_artifact, tmp_path,
                                       monkeypatch):
    """Under the profiler, in ``set_sync_debug_mode("error")``, a train
    step and a graph replay (its input already on the card, so the copy
    in is a device copy) raise nothing: the spans' events add no host
    wait. Then a whole call into the artifact, whose blocking copies in
    and out are the call's own, outside the debug mode: ``serve.call``
    around ``serve.h2d``, ``serve.replay`` and ``serve.d2h``, the copy
    in timed on the card (the replay and the blocking copy out on the
    host alone), and the step's five phases timed on the card."""
    monkeypatch.setattr(timer, "_ring", collections.deque(
        maxlen=timer.SPAN_RING))
    _, _, serving, _ = card_artifact
    if 2 not in serving.graphs:
        serving.warm_up([2])
    model = build_refinedet("train", 320, 21, device=cuda,
                            dtype=torch.bfloat16)
    data = SyntheticDetection(2, seed=4)
    batch = [torch.from_numpy(a).to(cuda) for a in detection_collate(
        [data[i] for i in range(2)], 60)]
    opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                         grad_clip_norm=10.0)
    step = make_train_step(model, opt, TrainConfig(max_boxes=60,
                                                   grad_clip_norm=10.0))
    state = create_train_state(model, opt)
    state, _ = step(state, *batch)  # warm-up: lazy init may sync once
    x = torch.from_numpy(_noise(5, 2)).to(cuda)
    with torch.inference_mode():
        serving.graphs[2].replay(x)
    torch.cuda.synchronize()
    with profile_trace(str(tmp_path / "t")):
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = step(state, *batch)
            with torch.inference_mode():
                serving.graphs[2].replay(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        serving(_noise(6, 2))
    assert np.isfinite(float(metrics["loss"]))
    recs = timer.span_records()
    phases = [r for r in recs if r.parent == "train.step"]
    assert [r.name for r in phases] == [
        "train.augment", "train.forward", "train.loss", "train.backward",
        "train.optimizer"]
    assert all(r.id == 1 for r in phases)
    assert all(r.device_ms > 0 for r in phases[1:])
    call = timer.span_records(last_ids=1)
    assert [(r.name, r.id) for r in call] == [
        ("serve.call", serving.calls), ("serve.h2d", serving.calls),
        ("serve.replay", serving.calls), ("serve.d2h", serving.calls)]
    summary = timer.span_summary(call)
    assert summary["serve.h2d"]["device_ms"] > 0
    assert summary["serve.replay"]["device_ms"] is None
    assert summary["serve.d2h"]["device_ms"] is None


# -- the stem twin, the slice pool backward, the benches, the demo core --------

def test_stem_twin_on_the_card_matches_standard(cuda):
    """f32 (TF32 off), batch 2: the JAX test's 2e-3 of max(1, max |head|)."""
    m0 = build_refinedet("test", 320, 21, device=cuda, seed=0)
    m1 = build_refinedet("test", 320, 21, device=cuda, seed=0, stem_s2d=True)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -120, 130, (2, 320, 320, 3)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        for a, b in zip(m0.raw_forward(x), m1.raw_forward(x)):
            assert float((b - a).abs().max()) <= 2e-3 * max(
                1.0, float(a.abs().max()))


def _pool_grads(x, ceil, g):
    out = {}
    for mode in layers.POOL_BACKWARDS:
        xx = x.detach().clone().requires_grad_()
        with layers.pool_backward(mode):
            y = layers.MaxPool2x2(ceil)(xx)
        y.backward(g)
        out[mode] = (y.detach(), xx.grad)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,ceil", [((8, 64, 80, 80), False),
                                        ((4, 256, 75, 75), True)],
                         ids=["even", "ceil-odd"])
def test_slice_pool_backward_on_the_card_equals_aten(cuda, shape, ceil,
                                                     dtype):
    """Channels-last, ties forced: output and gradient bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.round(torch.randn(shape, generator=gen, device=cuda) * 2)
         / 2).to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        g = torch.randn(layers.MaxPool2x2(ceil)(x).shape, generator=gen,
                        device=cuda).to(dtype)
    out = _pool_grads(x, ceil, g)
    (y_a, g_a), (y_s, g_s) = out["select_scatter"], out["slice"]
    view = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y_s.view(view), y_a.view(view))
    assert torch.equal(g_s.view(view), g_a.view(view))
    assert g_s.is_contiguous(memory_format=torch.channels_last)


def test_slice_pool_backward_in_a_trace(cuda, tmp_path):
    """Every kernel of the slice pool's forward and backward is filed
    under ``max_pool2d`` or ``max_pool2d backward``."""
    x = torch.randn(4, 64, 80, 80, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    g = torch.randn(4, 64, 40, 40, device=cuda)
    pool = layers.MaxPool2x2()
    with layers.pool_backward("slice"):
        pool(x).backward(g)  # warm-up
        x.grad = None  # a second gradient would be added in another op
        with profile_trace(str(tmp_path)):
            with span("pool"):
                pool(x).backward(g)
    cats = trace_stats(str(tmp_path))["categories_ms"]
    assert cats.get("max_pool2d backward", 0) > 0
    assert set(cats) <= {"max_pool2d", "max_pool2d backward"}, cats


def test_benches_on_the_card(cuda):
    """Both bench tools at batch 2, 2 iterations: four timed turns each,
    A, B, B, A, with their peaks, for the whole and for the part each
    changes alone."""
    for tool, argv, names, part in (
            (bench_stem_s2d, ["--batch", "2", "--iters", "2"],
             {"standard", "stem_s2d"}, "stems"),
            (bench_pool_backward, ["2", "2"], set(layers.POOL_BACKWARDS),
             "pools")):
        out = tool.main(argv)
        for runs in (out["results"], out[part]):
            assert set(runs) == names
            for r in runs.values():
                assert len(r["ms"]) == 2 and all(ms > 0 for ms in r["ms"])
                assert all(p >= b > 0 for p, b in zip(r["peak_bytes"],
                                                      r["base_bytes"]))
        assert "," in out["card"]  # nvidia-smi's name, power limit


def test_demo_core_on_the_card_matches_the_cpu(cuda):
    """``demo.detect_image`` on a 320x320 BGR image, f32: the card's rows
    the CPU's (same classes and order, scores 1e-4, pixels 1). The ODM
    confidence head has zero weights and seeded biases, so the scores
    order the candidates alike on both."""
    model = build_refinedet("test", 320, 21, device=cuda, seed=0)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.startswith("odm_conf."):
                p.copy_(torch.from_numpy(rng.uniform(
                    -4, 4, p.shape).astype(np.float32)) if name.endswith(
                    "bias") else torch.zeros_like(p))
            elif name.startswith(("arm_loc.", "odm_loc.")):
                p.mul_(0.01)
    host = model_on(model, "cpu")
    img = rng.randint(0, 256, (320, 320, 3)).astype(np.uint8)
    before = nms_cuda.nms_sweep.launches
    got = demo.detect_image(model, img, 0.2)
    assert nms_cuda.nms_sweep.launches == before + 1
    want = demo.detect_image(host, img, 0.2)
    assert len(got) == len(want) > 0
    for (c, s, b), (wc, ws, wb) in zip(got, want):
        assert c == wc and abs(s - ws) <= 1e-4
        assert max(abs(p - q) for p, q in zip(b, wb)) <= 1
