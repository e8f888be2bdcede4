"""Kernel K1's design choices, measured on the card.

    python -m refinedet_tpu_torch.tools.k1_bench

Builds variants of ``csrc/nms_sweep.cu``, each a text substitution of the
shipped source (it raises if the source no longer holds the text), and
times each with ``graph_ms`` at the main path's two shapes, G = 640 groups
(a batch of 32, 20 classes) of K = 200 (serving) and K = 1000 (the detect
``top_k``), on two kinds of candidates: those of the serving path
(RefineDet320, VOC, weights from seed 0, ``noise_images`` from seed 0: the
candidates ``chip_smoke.py`` times), and seeded uniform boxes:

  shipped       the kernel as it ships;
  build_only    the sweep skipped, so the bitmask build alone (not exact);
  no_prefilter  no prefilter: every pair goes to the clear-hit test and,
                failing it, the IEEE division;
  row_step      the sweep one kept row a step, one ``__ffsll`` a word and
                one ``__reduce_min_sync``, instead of a word at a time.

The exact variants are first held against the plain version. The variants
run in the order listed and then in reverse, and each time is the smaller
of the two. The last line is a JSON object of the times.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from refinedet_tpu_torch.detect.detection import detect_refinedet
from refinedet_tpu_torch.models import build_refinedet
from refinedet_tpu_torch.ops import nms_cuda
from refinedet_tpu_torch.ops.nms import (as_f32, nms_sweep_reference,
                                         select_candidates)
from refinedet_tpu_torch.serve.export import fused_nms_settings

THRESH = 0.49  # the serving default
SHAPES = ((640, 200, 0.95), (640, 1000, 0.8))  # G, K, share of valid
SIZE, NUM_CLASSES, BATCH = 320, 21, 32

SWEEP_START = ("  const int nq = (nw + 31) / 32;  // words a lane holds for "
               "this K\n")
SWEEP_END = ("  if (lane == 0) *reinterpret_cast<volatile int*>(&sweep_done)"
             " = 1;\n")
ROW_STEP_SWEEP = """  const int nq = (nw + 31) / 32;
  constexpr int kNone = 0x7fffffff;
  int cur = -1, held = -1;
  const uint64_t* rows = ring;
  for (;;) {
    int cand = kNone;
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int w = lane + 32 * q;
      const int sh = cur - w * kStripe;
      const uint64_t after =
          sh < 0 ? ~0ull : sh >= 63 ? 0ull : ~0ull << (sh + 1);
      const uint64_t open = q < nq ? ~removed[q] & after : 0ull;
      cand = min(cand, open ? w * kStripe + __ffsll(open) - 1 : kNone);
    }
    const int next = __reduce_min_sync(~0u, cand);
    if (next == kNone) break;
    const int s = next / kStripe;
    if (s != held) {
      need(s);
      held = s;
      rows = ring + static_cast<size_t>(s % depth) * kStripe * nw;
    }
    const uint64_t* row = rows + (next % kStripe) * nw;
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int w = lane + 32 * q;
      if (q < nq && w >= s && w < nw) removed[q] |= row[w];
    }
    cur = next;
  }
"""


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return text.replace(old, new)


def _replace_between(text: str, start: str, end: str, new: str) -> str:
    a, b = text.find(start), text.find(end)
    if a < 0 or b < a:
        raise RuntimeError("the source no longer holds the sweep markers")
    return text[:a] + new + text[b:]


def variants(src: str) -> dict:
    """Variant name -> (source text, exact?)."""
    return {
        "shipped": (src, True),
        "build_only": (_replace(
            src, "    need(s);\n    const uint64_t* rows",
            "    need(s);\n    if (k > 0) continue;\n"
            "    const uint64_t* rows"),
            False),
        "no_prefilter": (_replace(
            src, "  return t >= 0x1p-20f && t <= 1.0f ? t * (1.0f - 0x1p-20f)"
            " : 0.0f;", "  return 0.0f;"), True),
        "row_step": (_replace_between(src, SWEEP_START, SWEEP_END,
                                      ROW_STEP_SWEEP), True),
    }


def graph_ms(fn, n: int = 50, reps: int = 3) -> float:
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events; the least replay over n.
    The host's cost of each call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def uniform_candidates(g: int, k: int, p_valid: float, seed: int,
                       scale: float = 1.0):
    """Seeded boxes of side 0.02-0.3 at uniform places in [0, 1.1], and a
    non-prefix valid mask, on the card."""
    gen = torch.Generator().manual_seed(seed)
    xy = torch.rand(g, k, 2, generator=gen) * 0.8
    wh = torch.rand(g, k, 2, generator=gen) * 0.28 + 0.02
    boxes = torch.cat([xy, xy + wh], -1) * scale
    valid = torch.rand(g, k, generator=gen) < p_valid
    return boxes.cuda().contiguous(), valid.cuda().contiguous()


def noise_images(rng, batch: int, size: int = SIZE):
    """Mean-subtracted f32 RGB images of uniform pixel noise, as numpy."""
    raw = rng.randint(0, 256, (batch, size, size, 3)).astype(np.float32)
    return raw - np.asarray((123.0, 117.0, 104.0), np.float32)


def serving_candidates(model, images, top_ks, conf_thresh: float) -> dict:
    """top_k -> (boxes [B * (C - 1), top_k, 4], valid) of the serving
    path's NMS candidates for numpy ``images``, on the model's device."""
    with torch.inference_mode():
        heads = model.raw_forward(torch.from_numpy(images).to(
            model.priors.device))
        boxes, scores = detect_refinedet(
            heads[0], heads[1].softmax(-1), heads[2], heads[3].softmax(-1),
            model.priors)
        cls = scores[..., 1:].movedim(-1, 1)  # [B, C - 1, P]
        out = {}
        for top_k in top_ks:
            _, _, cand, valid = select_candidates(boxes[:, None], cls, top_k,
                                                  conf_thresh)
            out[top_k] = (cand.reshape(-1, top_k, 4).contiguous(),
                          valid.reshape(-1, top_k).contiguous())
    return out


def _launcher(kernel, boxes, valid, plus_one=False):
    g, k = valid.shape
    keep = torch.empty((g, k), dtype=torch.bool, device=boxes.device)

    def run():
        err = kernel.lib.nms_sweep_launch(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), g, k,
            as_f32(THRESH), int(plus_one),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return keep
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_bench: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    out_dir = nms_cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    table = variants(nms_cuda.SOURCE.read_text())
    paths = {}
    for name, (text, _) in table.items():
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:  # one nvcc each, together
        libs = dict(zip(paths, pool.map(nms_cuda.build_library,
                                        paths.values())))

    for name, (_, exact) in table.items():
        if not exact:
            continue
        for g, k, p_valid in SHAPES + ((3, 129, 0.8), (2, 4000, 0.8)):
            for plus_one in (False, True):
                boxes, valid = uniform_candidates(
                    g, k, p_valid, seed=g + k, scale=320.0 if plus_one
                    else 1.0)
                got = _launcher(libs[name], boxes, valid, plus_one)()
                want = nms_sweep_reference(boxes, valid, THRESH, plus_one)
                bad = int((got != want).sum())
                if bad:
                    raise RuntimeError(f"{name}: {bad} mismatches at G={g} "
                                       f"K={k} plus_one={plus_one}")
        print(f"{name}: keep masks equal to the plain version's", flush=True)

    model = serving_candidates(
        build_refinedet("test", SIZE, NUM_CLASSES, device="cuda", seed=0),
        noise_images(np.random.RandomState(0), BATCH),
        [k for _, k, _ in SHAPES],
        fused_nms_settings(NUM_CLASSES, {}).conf_thresh)
    inputs = {f"model K={k}": model[k] for _, k, _ in SHAPES}
    model_labels = list(inputs)
    inputs.update({f"uniform K={k}": uniform_candidates(g, k, p, seed=1)
                   for g, k, p in SHAPES})
    for label in model_labels:  # the serving path's candidates, too
        boxes, valid = inputs[label]
        area = ((boxes[..., 2] - boxes[..., 0])
                * (boxes[..., 3] - boxes[..., 1]))[valid]
        print(f"{label}: {int(valid.sum())} valid candidates, "
              f"{int((area == 0).sum())} of zero area, largest |coordinate| "
              f"{float(boxes.abs().max()):.3g}", flush=True)
        want = nms_sweep_reference(boxes, valid, THRESH)
        for name, (_, exact) in table.items():
            if exact and not torch.equal(
                    _launcher(libs[name], boxes, valid)(), want):
                raise RuntimeError(f"{name}: mismatches on {label}")
    times = {name: {} for name in table}
    for order in (list(table), list(table)[::-1]):
        for name in order:
            for label, (boxes, valid) in inputs.items():
                ms = graph_ms(_launcher(libs[name], boxes, valid))
                times[name][label] = min(times[name].get(label, ms), ms)
    for name, per_input in times.items():
        cells = "  ".join(f"{label}: {ms:.4f}"
                          for label, ms in per_input.items())
        print(f"{name:13s} {cells} (ms, G=640)", flush=True)
    print(json.dumps({"card": smi, "thresh": THRESH, "ms": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
