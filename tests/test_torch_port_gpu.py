"""Card-only tests of the port: kernel K1 against its plain version, and
the CUDA serving path against the CPU one.

They skip without a CUDA card. On the card::

    python -m pytest -m gpu tests/test_torch_port_gpu.py -q

This file imports no JAX, so it also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from refinedet_tpu_torch.boxes.geometry import iou_pairwise
from refinedet_tpu_torch.detect.detection import detect_refinedet
from refinedet_tpu_torch.models import build_refinedet
from refinedet_tpu_torch.ops import nms_cuda
from refinedet_tpu_torch.ops.nms import nms_sweep_reference
from refinedet_tpu_torch.serve.export import (fused_nms_settings,
                                              fused_postprocess,
                                              make_serving_fn)

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
