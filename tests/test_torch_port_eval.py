"""Port parity: the eval slice of ``refinedet_tpu_torch`` against the JAX
package on the CPU.

* ``COCOeval``, ``voc_ap``/``voc_eval_class``/``evaluate_voc``,
  ``write_voc_results_files`` and ``COCODetection.evaluate_detections``
  on the same inputs: exactly equal (both are numpy, the same code);
* ``eval_postprocess`` against the functions the JAX ``Evaluator`` calls,
  on identical heads, both area conventions: boxes rtol 1e-5 / atol
  1e-3 px, scores rtol 1e-5, the same surviving rows in the same order;
* ``Evaluator.run`` and ``Evaluator.sweep`` end to end against the JAX
  ``Evaluator`` from the same weights (the same tolerances), under a
  precondition on the seed that the forwards' ~1e-5 drift cannot reorder
  candidates or flip an IoU test;
* the RefineDet512 (2 classes) forward against ``build_refinedet("test",
  512, 2)``: relative 1e-4, as the 320 forward.
"""

import copy
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu import config as JC  # noqa: E402
from refinedet_tpu.config import DetectConfig as JDetectConfig  # noqa: E402
from refinedet_tpu.data import BaseTransform as JBaseTransform  # noqa: E402
from refinedet_tpu.data import COCODetection as JCOCODetection  # noqa: E402
from refinedet_tpu.data.coco_io import COCO as JCOCO  # noqa: E402
from refinedet_tpu.detect.detection import \
    detect_refinedet as jdetect  # noqa: E402
from refinedet_tpu.eval import Evaluator as JEvaluator  # noqa: E402
from refinedet_tpu.eval import coco_eval as jcoco_eval  # noqa: E402
from refinedet_tpu.eval import voc_eval as jvoc_eval  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.models.torch_import import \
    torch_state_dict_to_flax  # noqa: E402
from refinedet_tpu.ops.dispatch import \
    class_parallel_nms as jclass_parallel_nms  # noqa: E402

from refinedet_tpu_torch import config as C  # noqa: E402
from refinedet_tpu_torch.config import DetectConfig  # noqa: E402
from refinedet_tpu_torch.data import BaseTransform, COCODetection  # noqa: E402
from refinedet_tpu_torch.data.coco_io import COCO  # noqa: E402
from refinedet_tpu_torch.detect.detection import detect_refinedet  # noqa: E402
from refinedet_tpu_torch.eval import Evaluator  # noqa: E402
from refinedet_tpu_torch.eval import coco_eval, voc_eval  # noqa: E402
from refinedet_tpu_torch.eval.cli_coco import make_loader  # noqa: E402
from refinedet_tpu_torch.eval.evaluator import eval_postprocess  # noqa: E402
from refinedet_tpu_torch.models import (build_refinedet,  # noqa: E402
                                        state_dict_from_flax)

from data_fixtures import make_coco_dataset  # noqa: E402

SIZE = 320
TOP_K = 50          # the Evaluator tests' top_k, nms_top_k and cap
BOX_RTOL, BOX_ATOL, SCORE_RTOL = 1e-5, 1e-3, 1e-5
# End to end the two forwards differ (heads to ~1e-5 of their largest
# magnitude, see test_torch_port_model.py), and a decoded coordinate moves
# with its box's extent, which the two cascaded decodes scale by exp(0.2 *
# loc) each: measured up to 1.34e-5 of the row's largest |coordinate| on
# the Evaluator's fixture below. End-to-end boxes get this share of it on
# top of rtol 1e-5.
FORWARD_BOX_REL = 5e-5


# -- COCOeval -----------------------------------------------------------------

# The golden fixtures of tests/test_eval.py: (gts, dts, num_cats) with
# gts (img, cat, xywh, iscrowd) and dts (img, cat, xywh, score).
GOLDEN = {
    "perfect_single": ([(1, 1, (0, 0, 10, 10), 0)],
                       [(1, 1, (0, 0, 10, 10), 0.9)], 1),
    "high_score_fp": ([(1, 1, (0, 0, 10, 10), 0)],
                      [(1, 1, (0, 0, 10, 10), 0.8),
                       (1, 1, (500, 500, 10, 10), 0.95)], 1),
    "iou_threshold_switch": ([(1, 1, (0, 0, 10, 10), 0)],
                             [(1, 1, (0, 0, 10, 6), 0.9)], 1),
    "iscrowd": ([(1, 1, (0, 0, 10, 10), 0), (1, 1, (50, 50, 20, 20), 1)],
                [(1, 1, (0, 0, 10, 10), 0.9),
                 (1, 1, (55, 55, 10, 10), 0.95)], 1),
    "area_range": ([(1, 1, (0, 0, 10, 10), 0),
                    (1, 1, (200, 200, 100, 100), 0)],
                   [(1, 1, (0, 0, 10, 10), 0.9),
                    (1, 1, (200, 200, 100, 100), 0.95),
                    (1, 1, (600, 600, 200, 200), 0.7)], 1),
    "maxdets": ([(1, 1, (0, 0, 10, 10), 0)],
                [(1, 1, (500, 0, 10, 10), 0.9),
                 (1, 1, (0, 500, 10, 10), 0.8),
                 (1, 1, (0, 0, 10, 10), 0.7)], 1),
    "interpolation": ([(1, 1, (0, 0, 10, 10), 0),
                       (1, 1, (100, 100, 10, 10), 0)],
                      [(1, 1, (0, 0, 10, 10), 0.9)], 1),
    "multicategory": ([(1, 1, (0, 0, 10, 10), 0),
                       (1, 2, (100, 100, 10, 10), 0)],
                      [(1, 1, (0, 0, 10, 10), 0.9)], 2),
}


def _random_coco(seed):
    """3 images, 2 categories: GTs (some crowd, all area ranges), dets
    jittered from GTs plus strays, scores with ties, some images with
    more than 100 dets (the maxDets cap)."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for img in (1, 2, 3):
        for _ in range(rng.randint(1, 8)):
            cat = int(rng.randint(1, 3))
            wh = rng.choice([8.0, 40.0, 150.0]) * rng.uniform(0.6, 1.4, 2)
            xy = rng.uniform(0, 600, 2)
            gts.append((img, cat, (*xy, *wh), int(rng.uniform() < 0.1)))
            for _ in range(rng.randint(0, 4)):
                j = rng.normal(0, 0.15 * wh.mean(), 4)
                dts.append((img, cat, (*(xy + j[:2]), *np.abs(wh + j[2:])),
                            float(np.round(rng.uniform(), 2))))
        for _ in range(rng.randint(0, 130)):
            dts.append((img, int(rng.randint(1, 3)),
                        (*rng.uniform(0, 600, 2), *rng.uniform(5, 120, 2)),
                        float(np.round(rng.uniform(), 2))))
    return gts, dts, 2


def _coco_json(gts, dts, num_cats):
    img_ids = sorted({g[0] for g in gts} | {d[0] for d in dts}) or [1]
    dataset = {
        "images": [{"id": i, "width": 1000, "height": 1000}
                   for i in img_ids],
        "categories": [{"id": c, "name": f"c{c}"}
                       for c in range(1, num_cats + 1)],
        "annotations": [
            {"id": i + 1, "image_id": g[0], "category_id": g[1],
             "bbox": list(map(float, g[2])),
             "area": float(g[2][2] * g[2][3]), "iscrowd": g[3]}
            for i, g in enumerate(gts)],
    }
    results = [{"image_id": d[0], "category_id": d[1],
                "bbox": list(map(float, d[2])), "score": float(d[3])}
               for d in dts]
    return dataset, results


def _stats(coco_cls, eval_module, dataset, results):
    gt = coco_cls(copy.deepcopy(dataset))
    ev = eval_module.COCOeval(gt, gt.loadRes(copy.deepcopy(results)))
    ev.evaluate()
    ev.accumulate()
    return ev.summarize(), ev.eval


@pytest.mark.parametrize("case", list(GOLDEN) + ["random0", "random1",
                                                 "random2"])
def test_cocoeval_equals_jax(case):
    spec = GOLDEN[case] if case in GOLDEN else _random_coco(int(case[-1]))
    dataset, results = _coco_json(*spec)
    got, got_eval = _stats(COCO, coco_eval, dataset, results)
    want, want_eval = _stats(JCOCO, jcoco_eval, dataset, results)
    assert got.shape == (12,)
    np.testing.assert_array_equal(got, want)
    for key in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(got_eval[key], want_eval[key])
    xywh = np.array([d[2] for d in spec[1]], float).reshape(-1, 4)
    crowd = np.array([g[3] for g in spec[0]])
    gt_xywh = np.array([g[2] for g in spec[0]], float).reshape(-1, 4)
    np.testing.assert_array_equal(
        coco_eval.box_iou_xywh(xywh, gt_xywh, crowd),
        jcoco_eval.box_iou_xywh(xywh, gt_xywh, crowd))


# -- VOC AP -------------------------------------------------------------------

def _random_voc(rng, n_img=4, classes=("cat", "dog", "car")):
    """(all_boxes, per-image GT) with difficult objects, jittered and
    stray detections, and score ties."""
    annos, all_boxes = [], [None] + [[] for _ in classes]
    for i in range(n_img):
        k = rng.randint(0, 6)
        xy = rng.uniform(0, 300, (k, 2))
        boxes = np.hstack([xy, xy + rng.uniform(10, 120, (k, 2))])
        labels = rng.randint(0, len(classes), k)
        difficult = rng.uniform(size=k) < 0.2
        annos.append((f"im{i}", boxes, labels, difficult))
        for c in range(len(classes)):
            rows = [np.r_[b + rng.normal(0, 4, 4), 0]
                    for b in boxes[labels == c]]
            rows += [np.r_[np.sort(rng.uniform(0, 400, 4)).reshape(2, 2).T
                           .ravel(), 0] for _ in range(rng.randint(0, 5))]
            rows = np.array(rows, float).reshape(-1, 5)
            rows[:, 4] = np.round(rng.uniform(0.01, 1, len(rows)), 2)
            all_boxes[c + 1].append(rows)
    return all_boxes, annos, classes


class _StubVOC:
    def __init__(self, annos):
        self.ids = [("root", a[0]) for a in annos]
        self._annos = annos

    def __len__(self):
        return len(self._annos)

    def pull_anno_full(self, i):
        return self._annos[i]


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_equals_jax(use_07, tmp_path):
    rng = np.random.RandomState(3)
    for _ in range(5):
        rec = np.sort(rng.uniform(0, 1, 20))
        prec = rng.uniform(0, 1, 20)
        assert voc_eval.voc_ap(rec, prec, use_07) == \
            jvoc_eval.voc_ap(rec, prec, use_07)
    # test_eval.py's golden cases, then random sets
    gt = {"img1": {"bbox": [[10, 10, 50, 50], [60, 60, 90, 90]],
                   "difficult": [False, True]}}
    dets = [("img1", 0.9, np.array([11, 11, 49, 49])),
            ("img1", 0.8, np.array([12, 12, 48, 48])),
            ("img1", 0.8, np.array([61, 61, 89, 89])),
            ("img1", 0.7, np.array([200, 200, 240, 240]))]
    for shift in (0.0, 1.0):
        got = voc_eval.voc_eval_class(dets, gt, 0.5, use_07, shift)
        want = jvoc_eval.voc_eval_class(dets, gt, 0.5, use_07, shift)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for seed in range(3):
        all_boxes, annos, classes = _random_voc(np.random.RandomState(seed))
        ds = _StubVOC(annos)
        for shift in (0.0, 1.0):
            got = voc_eval.evaluate_voc(all_boxes, ds, classes, 0.5, use_07,
                                        verbose=False, det_shift=shift)
            want = jvoc_eval.evaluate_voc(all_boxes, ds, classes, 0.5,
                                          use_07, verbose=False,
                                          det_shift=shift)
            assert got == want
            assert 0 < got["mAP"] < 1
        ids = [a[0] for a in annos]
        ours = voc_eval.write_voc_results_files(all_boxes, ids, classes,
                                                str(tmp_path / "t"))
        theirs = jvoc_eval.write_voc_results_files(all_boxes, ids, classes,
                                                   str(tmp_path / "j"))
        for cls in classes:
            assert Path(ours[cls]).read_text() == \
                Path(theirs[cls]).read_text()


# -- the dataset's COCO evaluator ---------------------------------------------

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_coco_dataset(str(root), split="test", num_images=4, img_size=96,
                      seed=0)
    return str(root)


def test_evaluate_detections_equals_jax(coco_root, tmp_path):
    ours = COCODetection(coco_root, [("sarship", "test")])
    theirs = JCOCODetection(coco_root, [("sarship", "test")])
    rng = np.random.RandomState(5)
    all_boxes = [None, []]
    for rows in ours.annotations:
        dets = [np.r_[r[:4] + rng.normal(0, 2, 4), rng.uniform()]
                for r in rows] + [np.r_[np.sort(rng.uniform(0, 96, 4))
                                        .reshape(2, 2).T.ravel(),
                                        rng.uniform()] for _ in range(6)]
        all_boxes[1].append(np.array(dets, np.float32))
    got = ours.evaluate_detections(all_boxes, str(tmp_path / "t"))
    want = theirs.evaluate_detections(all_boxes, str(tmp_path / "j"))
    assert got.shape == (12,) and got[1] > 0
    np.testing.assert_array_equal(got, want)
    name = "detections_sarship_test_results.json"
    assert (tmp_path / "t" / name).read_text() == \
        (tmp_path / "j" / name).read_text()


# -- the post-process on identical heads --------------------------------------

def _np_iou(a, b, plus_one):
    off = 1.0 if plus_one else 0.0
    wh = np.clip(np.minimum(a[:, None, 2:], b[None, :, 2:])
                 - np.maximum(a[:, None, :2], b[None, :, :2]) + off, 0, None)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (x[:, 2] - x[:, 0] + off) * (x[:, 3] - x[:, 1] + off)

    with np.errstate(all="ignore"):
        return inter / (area(a)[:, None] + area(b)[None] - inter)


def assert_separated(jscores, tscores, jboxes, tboxes, top_k, cfg,
                     plus_one):
    """The precondition of a parity test: scores ``[B, P, C]`` of the two
    packages differ by less than half of any gap between the best
    ``top_k + 1`` valid scores of each image and class (no reordering),
    and the IoUs of those candidates (pixel boxes ``[B, P, 4]``) differ
    by less than half of their distance to the threshold (no flipped
    suppression). Scores tied exactly in both packages (saturated
    softmaxes) keep their index order in both. A NaN IoU never
    suppresses. Returns the score drift."""
    drift = float(np.abs(tscores - jscores).max())
    for b in range(jscores.shape[0]):
        for c in range(1, jscores.shape[2]):
            order = np.argsort(-jscores[b, :, c], kind="stable")[:top_k + 1]
            best = jscores[b, order, c]
            order = order[best > cfg.conf_thresh]
            best = best[best > cfg.conf_thresh]
            if len(best) < 2:
                continue
            gap = best[:-1] - best[1:]
            tbest = tscores[b, order, c]
            tied = (gap == 0) & (tbest[:-1] == tbest[1:])
            assert np.all((gap > 2 * drift) | tied)
            cand = order[:top_k]
            iou = _np_iou(jboxes[b, cand], jboxes[b, cand], plus_one)
            tiou = _np_iou(tboxes[b, cand], tboxes[b, cand], plus_one)
            np.fill_diagonal(iou, np.nan)
            np.fill_diagonal(tiou, np.nan)
            # a NaN on one side (a box whose width rounds to 0 in one
            # package) must face a non-suppressing IoU on the other
            one_nan = np.isnan(iou) != np.isnan(tiou)
            assert np.all(np.nan_to_num(np.where(one_nan, np.fmax(
                iou, tiou), 0.0)) < cfg.nms_thresh)
            both = ~np.isnan(iou) & ~np.isnan(tiou)
            assert np.all(np.abs(iou - cfg.nms_thresh)[both]
                          > 2 * np.abs(tiou - iou)[both])
    return drift


def assert_forward_boxes_close(got, want, atol=BOX_ATOL):
    """End-to-end boxes ``[..., 4]``: within ``atol`` px, rtol 1e-5, and
    ``FORWARD_BOX_REL`` of the row's largest |coordinate|."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    tol = (atol + BOX_RTOL * np.abs(want)
           + FORWARD_BOX_REL * np.abs(want).max(-1, keepdims=True))
    err = np.abs(got - want)
    assert got.shape == want.shape and np.all(err <= tol), \
        f"worst error {float((err / tol).max()):.3g} x the tolerance"


def assert_rows_close(got, want, forward=False):
    """Same kept rows in the same order; boxes rtol 1e-5 / atol 1e-3 px
    (``forward``: and the forwards' drift, see FORWARD_BOX_REL), scores
    rtol 1e-5."""
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    if forward:
        assert_forward_boxes_close(got[..., :4], want[..., :4])
    else:
        np.testing.assert_allclose(got[..., :4], want[..., :4],
                                   rtol=BOX_RTOL, atol=BOX_ATOL)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=SCORE_RTOL,
                               atol=0)


def _port_boxes_scores(heads, priors, cfg):
    """The port's decoded boxes and filtered scores, as numpy."""
    boxes, scores = detect_refinedet(
        heads[0], heads[1].softmax(-1), heads[2], heads[3].softmax(-1),
        priors, cfg.variance, cfg.objectness_thresh)
    return boxes.numpy(), scores.numpy()


def _jax_postprocess(heads, priors, scales, cfg, top_k, plus_one):
    """The JAX Evaluator's post-process (refinedet_tpu/eval/evaluator.py:
    77-91), on heads given as numpy: returns (dets, boxes, scores)."""
    al, ac, ol, oc = (jnp.asarray(h) for h in heads)
    boxes, scores = jdetect(al, jax.nn.softmax(ac, axis=-1), ol,
                            jax.nn.softmax(oc, axis=-1), jnp.asarray(priors),
                            variances=cfg.variance,
                            objectness_thresh=cfg.objectness_thresh)
    boxes = boxes * jnp.asarray(scales)[:, None, :]
    bx, sc = jclass_parallel_nms(
        boxes[:, None], jnp.moveaxis(scores[..., 1:], -1, 1), cfg.nms_thresh,
        top_k=top_k, score_thresh=cfg.conf_thresh, plus_one=plus_one,
        backend="cpu")
    dets = jnp.concatenate([bx, sc[..., None]], axis=-1)
    return np.asarray(dets), np.asarray(boxes), np.asarray(scores)


@pytest.mark.parametrize("plus_one", [True, False])
def test_eval_postprocess_on_identical_heads(plus_one):
    priors = build_refinedet("test", SIZE, 3, device="cpu").priors
    p = priors.shape[0]
    rng = np.random.RandomState(6)
    heads = [(rng.randn(2, p, 4) * 0.5).astype(np.float32),
             rng.randn(2, p, 2).astype(np.float32),
             (rng.randn(2, p, 4) * 0.5).astype(np.float32),
             (rng.randn(2, p, 3) * 2).astype(np.float32)]
    scales = np.array([[500, 375, 500, 375], [320, 320, 320, 320]],
                      np.float32)
    cfg = DetectConfig(num_classes=3, nms_thresh=0.45)
    jcfg = JDetectConfig(num_classes=3, nms_thresh=0.45)
    want, jboxes, jscores = _jax_postprocess(heads, priors.numpy(), scales,
                                             jcfg, 100, plus_one)
    t = [torch.from_numpy(h) for h in heads]
    got = eval_postprocess(t, priors, torch.from_numpy(scales), cfg, 100,
                           plus_one).numpy()
    tboxes, tscores = _port_boxes_scores(t, priors, cfg)
    # exp's last ulp moves an IoU by ~1e-6: a margin of 1e-5 suffices
    assert_separated(jscores, tscores, jboxes, tboxes * scales[:, None],
                     100, cfg, plus_one)
    assert got.shape == want.shape == (2, 2, 100, 5)
    assert 20 < (got[..., 4] > 0).sum() < got[..., 4].size
    assert_rows_close(got, want)


# -- the Evaluator end to end -------------------------------------------------

@pytest.fixture(scope="module")
def evaluators(coco_root):
    """The JAX Evaluator and the port's, on the tiny COCO set (4 images of
    96², SSDD-like, 2 classes), RefineDet320 f32, batch 2, top_k 50, from
    the same seed-0 weights (the port's, converted by the JAX package's
    importer: Flax's init takes ~45 s on the CPU); plus the JAX run's
    all_boxes."""
    model = build_refinedet("test", SIZE, 2, device="cpu", seed=0)
    state = {k: v.clone() for k, v in model.net.state_dict().items()}
    jmodel = jbuild("test", SIZE, 2)
    variables = {"params": torch_state_dict_to_flax(state)}
    jds = JCOCODetection(coco_root, [("sarship", "test")])
    jcfg = JDetectConfig(num_classes=2, top_k=TOP_K, keep_top_k=TOP_K)
    jev = JEvaluator(jmodel, jds, jcfg, JBaseTransform(SIZE, JC.MEANS),
                     batch_size=2, nms_top_k=TOP_K, max_per_image=TOP_K,
                     log=lambda s: None)
    model.net.load_state_dict(
        build_refinedet("test", SIZE, 2, device="cpu", seed=3).net
        .state_dict())  # run(state) must load the weights
    ds = COCODetection(coco_root, [("sarship", "test")])
    cfg = DetectConfig(num_classes=2, top_k=TOP_K, keep_top_k=TOP_K)
    ev = Evaluator(model, ds, cfg, BaseTransform(SIZE, C.MEANS),
                   batch_size=2, nms_top_k=TOP_K, max_per_image=TOP_K,
                   log=lambda s: None)
    np.testing.assert_array_equal(
        state_dict_from_flax(variables)["vgg.0.weight"],
        state["vgg.0.weight"])
    return jev, variables, jev.run(variables), ev, state


def test_evaluator_separated_seed(evaluators):
    """The run's precondition: on these images and weights the two
    forwards cannot disagree on the order or the suppression of a
    candidate."""
    jev, variables, _, ev, state = evaluators
    ev.model.net.load_state_dict(state, strict=True)
    imgs, scales = [], []
    for i in range(len(ev.dataset)):
        raw, _ = ev.dataset.pull_image(i)
        imgs.append(ev.transform(raw))
        scales.append([raw.shape[1], raw.shape[0]] * 2)
    imgs, scales = np.stack(imgs), np.array(scales, np.float32)
    np.testing.assert_array_equal(
        imgs, np.stack([jev.transform(jev.dataset.pull_image(i)[0])
                        for i in range(len(ev.dataset))]))
    jheads = [np.asarray(h) for h in jev.model.raw_forward(
        variables, jnp.asarray(imgs))]
    with torch.inference_mode():
        theads = ev.model.raw_forward(torch.from_numpy(imgs))
        tboxes, tscores = _port_boxes_scores(theads, ev.model.priors,
                                             ev.cfg)
    _, jboxes, jscores = _jax_postprocess(jheads, np.asarray(jev.model.priors),
                                          scales, jev.cfg, TOP_K, True)
    drift = assert_separated(jscores, tscores, jboxes,
                             tboxes * scales[:, None], TOP_K, ev.cfg, True)
    assert 0 < drift < 1e-4


def _assert_all_boxes_close(got, want, n_images):
    assert len(got) == len(want) == 2
    kept = 0
    for cls in (1,):
        assert len(got[cls]) == len(want[cls]) == n_images
        for g, w in zip(got[cls], want[cls]):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert_rows_close(g, w, forward=True)
            kept += len(g)
    assert kept > 10


def test_evaluator_run_matches_jax(evaluators):
    _, _, jall, ev, state = evaluators
    lines = []
    ev.log = lines.append
    got = ev.run(state)
    _assert_all_boxes_close(got, jall, 4)
    assert "FPS:" in lines[-1] and "p50 batch latency" in lines[-1]
    assert ev.timing["batch_size"] == 2 and ev.timing["fps"] > 0
    assert all(len(rows) <= TOP_K for rows in got[1])


def test_evaluator_sweep_matches_jax(evaluators, tmp_path):
    """Two checkpoints, a bare reference-key state_dict and the same
    weights behind DataParallel's ``module.`` prefix: ap_stats.json equal
    to the JAX sweep's."""
    jev, _, _, ev, state = evaluators
    bare, prefixed = tmp_path / "e200.pth", tmp_path / "e300.pth"
    torch.save(state, bare)
    torch.save({"module." + k: v for k, v in state.items()}, prefixed)
    lines = []
    ev.log = lines.append
    got = ev.sweep([bare, prefixed], make_loader(), [200, 300],
                   str(tmp_path / "t"))
    # the JAX package's importer, as its make_loader uses it (without
    # Flax's slow init, whose values it replaces)
    want = jev.sweep([str(bare), str(prefixed)],
                     lambda path: {"params": torch_state_dict_to_flax(
                         torch.load(path, weights_only=True))},
                     [200, 300], str(tmp_path / "j"))
    assert got == want and got["epoch"] == [200, 300]
    assert json.loads((tmp_path / "t" / "ap_stats.json").read_text()) == \
        json.loads((tmp_path / "j" / "ap_stats.json").read_text())
    assert lines[-1].startswith("best ap: ")


def test_evaluator_needs_a_test_phase_model():
    with pytest.raises(ValueError, match="test"):
        Evaluator(types.SimpleNamespace(phase="train"), None, DetectConfig(),
                  BaseTransform(SIZE))


def test_evaluator_pads_the_last_batch(evaluators, coco_root):
    """3 images at batch 2: one shape for every batch, the padding row
    (zero image, unit scale) never reaches all_boxes; a failing image
    raises from run, not a hang."""
    ds = COCODetection(coco_root, [("sarship", "test")])
    ds.ids, ds.annotations = ds.ids[:3], ds.annotations[:3]
    ev = Evaluator(evaluators[3].model, ds,
                   DetectConfig(num_classes=2, top_k=20),
                   BaseTransform(SIZE, C.MEANS), batch_size=2,
                   log=lambda s: None)
    batches = list(ev._staged_batches(len(ds)))
    assert [(tuple(t[0].shape), tuple(t[1].shape), idx)
            for idx, t, _ in batches] == [
        ((2, SIZE, SIZE, 3), (2, 4), [0, 1]),
        ((2, SIZE, SIZE, 3), (2, 4), [2])]
    pad_img, pad_scale = batches[1][1][0][1], batches[1][1][1][1]
    assert not pad_img.any() and pad_scale.tolist() == [1.0] * 4
    assert len(ev.run()[1]) == 3
    ds.ids[1] = str(Path(coco_root) / "missing.jpg")  # cv2 reads None
    with pytest.raises(AttributeError):
        ev.run()


# -- RefineDet512 -------------------------------------------------------------

def test_refinedet512_heads_match_flax():
    jmodel = jbuild("test", 512, 2)
    model = build_refinedet("test", 512, 2, device="cpu", seed=5)
    variables = {"params": torch_state_dict_to_flax(model.net.state_dict())}
    np.testing.assert_array_equal(model.priors.numpy(),
                                  np.asarray(jmodel.priors))
    img = np.random.RandomState(2).randn(1, 512, 512, 3).astype(np.float32)
    jheads = jmodel.raw_forward(variables, jnp.asarray(img))
    with torch.inference_mode():
        theads = model.raw_forward(torch.from_numpy(img))
    p = 16320
    for want, got, c in zip(jheads, theads, (4, 2, 4, 2)):
        want = np.asarray(want)
        assert got.shape == want.shape == (1, p, c)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


# -- BaseTransform without a resize -------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size", [320, 512])
def test_base_transform_skips_same_size_resize(dtype, size):
    """An image already at the model's size skips cv2.resize, which at the
    same size copies: the output equals the resizing path's bit for bit,
    and the JAX package's transform."""
    import cv2
    rng = np.random.RandomState(size)
    img = (rng.randint(0, 256, (size, size, 3)) if dtype == np.uint8
           else rng.uniform(-50, 300, (size, size, 3))).astype(dtype)
    resized = cv2.resize(img.astype(np.float32), (size, size),
                         interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resized, img.astype(np.float32))
    got = BaseTransform(size, C.MEANS)(img)
    want = np.ascontiguousarray((resized - np.float32(C.MEANS[0]))[..., ::-1])
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JBaseTransform(size, JC.MEANS)(img))
    other = rng.randint(0, 256, (size // 2, size + 7, 3)).astype(dtype)
    np.testing.assert_array_equal(BaseTransform(size, C.VOC_MEANS)(other),
                                  JBaseTransform(size, JC.VOC_MEANS)(other))
