"""Port parity: the host NMS library of ``refinedet_tpu_torch.ops.nms_native``
(its own copy of ``native/nms.cpp``, built by g++ into the port's
``_build/``) against the JAX package's ``refinedet_tpu.ops.nms_native``
on the same rows: equal keep lists, and soft-NMS's rescored rows equal
bit for bit (both libraries are built with the same flags)."""

import numpy as np
import pytest

from refinedet_tpu.ops import nms_native as jnative

from refinedet_tpu_torch.ops import nms_native


def _dets(rng, n, ties=False):
    xy = rng.uniform(0, 210.0, (n, 2))
    wh = rng.uniform(15.0, 90.0, (n, 2))
    scores = rng.uniform(0.01, 1.0, n)
    if ties:  # repeated scores: the stable order must agree too
        scores = np.round(scores, 1)
    return np.hstack([xy, xy + wh, scores[:, None]]).astype(np.float32)


@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_matches_jax(plus_one, ties):
    rng = np.random.RandomState(7 + ties)
    for n in (1, 5, 80, 300):
        dets = _dets(rng, n, ties)
        got = nms_native.nms(dets, 0.45, plus_one=plus_one)
        want = jnative.nms(dets, 0.45, plus_one=plus_one)
        assert got == want
        assert got == nms_native._numpy_nms(dets, 0.45, plus_one)
    assert nms_native.nms(np.zeros((0, 5), np.float32), 0.5) == []


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_matches_jax(method):
    rng = np.random.RandomState(11)
    for n in (1, 40, 200):
        dets = _dets(rng, n)
        ours, theirs = dets.copy(), dets.copy()
        got = nms_native.soft_nms(ours, iou_thresh=0.3, method=method,
                                  score_thresh=0.01)
        want = jnative.soft_nms(theirs, iou_thresh=0.3, method=method,
                                score_thresh=0.01)
        assert got == want and len(got) > 0
        np.testing.assert_array_equal(ours, theirs)
    # float64 input: rescored in place through the float32 copy
    dets = _dets(rng, 30).astype(np.float64)
    want = dets.astype(np.float32)
    keep = nms_native.soft_nms(dets, method=method)
    assert keep == jnative.soft_nms(want, method=method)
    np.testing.assert_array_equal(dets, want)


def test_soft_nms_rejects_unknown_method():
    with pytest.raises(ValueError, match="method"):
        nms_native.soft_nms(_dets(np.random.RandomState(0), 3),
                            method="lin")
    with pytest.raises(ValueError, match=r"\[N, 5\]"):
        nms_native.nms(np.zeros((3, 4), np.float32), 0.5)


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to the
    numpy version."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int nms_hard( { this is not C++ }\n")
    with pytest.raises(RuntimeError, match="failed with code"):
        nms_native.build_library(bad)
    monkeypatch.setattr(nms_native, "SOURCE", bad)
    monkeypatch.setattr(nms_native, "_lib", None)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        nms_native.nms(_dets(np.random.RandomState(0), 4), 0.5)
    other = tmp_path / "other.cpp"
    other.write_text(f"// built nowhere: {tmp_path}\n")
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        nms_native.build_library(other)


def test_library_lives_in_the_port():
    lib = nms_native.load_library()
    assert nms_native.BUILD_DIR.name == "_build"
    assert nms_native.BUILD_DIR.parent.name == "refinedet_tpu_torch"
    assert str(nms_native.BUILD_DIR) in lib._name
