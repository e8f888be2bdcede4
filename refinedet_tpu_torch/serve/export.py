"""The serving function and the serving artifact: numpy images in, numpy
detections out.

Port of ``refinedet_tpu/serve/export.py``. ``make_serving_fn`` wraps a
test-phase model (weights resident on its device) in one callable. With
``fused_nms`` the whole post-processing runs on the device (softmax,
objectness filter, cascade decode, per-class NMS through kernel K1,
compaction), and the host receives ``dets [B, C-1, K, 5]`` rows (x1, y1,
x2, y2, score), normalized 0-1, score-descending, zero-padded. Note the
column order differs from ``detect_refinedet_nms``'s (score first).

``export_inference`` exports the same device function (``InferenceModule``)
with ``torch.export``, weights included; ``save_serving`` writes it to one
file and ``load_serving`` reads it back as a ``ServingModel`` without any
model class: the serving host needs torch, numpy and
``refinedet_tpu_torch.ops`` (which registers K1 as the op
``refinedet_tpu_torch::nms_sweep``, the int8 convolution as
``refinedet_tpu_torch::int8_conv``, the activation quantize before it
as ``refinedet_tpu_torch::int8_quantize`` and a convolution with its bias
and ReLU as ``refinedet_tpu_torch::conv_bias_relu``, one node of the
exported graph each).
One artifact serves any batch size when exported with a symbolic batch.
The int8 twin (``build_refinedet(..., quant=True)`` filled by
``quant.quantize_model``) exports the same way; its metadata says
``"int8": true`` and the ``quant_skip`` it was built with.

File format: ``MAGIC | u32 json_len | json metadata | program bytes``,
one ``torch.export.save`` blob per platform, in the order of the
metadata's ``platforms``, each of the length ``program_bytes`` gives.
MAGIC is not the JAX package's, so each loader refuses the other
package's files with a clear error. A file of the first layout (one
program, a ``device`` key and no ``platforms``) still loads.

``torch.export`` records bf16 autocast for one device type, and a
program's weights live on the device it was exported on: a program moved
to another device type would run in float32 without a word, or not at
all. So, as the JAX artifact holds one lowering per platform,
``save_serving(..., platforms=("cuda", "cpu"))`` exports one program per
device type, each from a copy of the model on that device, under that
device's autocast. Each program holds its own copy of the weights: the
file holds them once per platform. ``load_serving(path, device)`` takes
the program of the device asked for, never another one: a file without
a program for that device raises, and a ``cuda`` request without a card
raises. The op ``refinedet_tpu_torch::nms_sweep`` picks K1 on the card
and its plain version on the CPU by itself, so both programs call it.

On the card, ``ServingModel.warm_up(batch_sizes)`` captures one CUDA
graph per batch size, the counterpart of XLA's one executable per bucket:
a call at a captured size copies its images into the graph's static input
buffer and replays the graph (the copies in and out stay outside it).
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import struct
import threading
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from refinedet_tpu_torch.config import VOC_MEANS, DetectConfig
from refinedet_tpu_torch.detect.detection import detect_refinedet
from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.ops import conv_epilogue, int8_conv, nms_cuda
from refinedet_tpu_torch.ops.dispatch import class_parallel_nms
from refinedet_tpu_torch.utils.timer import span

PLATFORMS = ("cuda", "cpu")
MAGIC = b"RDTPUTORCH1\n"
JAX_MAGIC = b"RDTPUSRV1\n"  # refinedet_tpu/serve/export.py's artifacts
FORMAT = "refinedet-tpu-torch-serving"
FUSED_OUTPUT = ("dets[b, C-1, K, 5] (x1, y1, x2, y2, score), normalized "
                "0-1 coords, per-class NMS'd, score-descending, "
                "zero-padded")


@dataclasses.dataclass(frozen=True)
class FusedNms:
    """Post-processing settings of a fused-NMS serving function."""

    nms_thresh: float
    conf_thresh: float
    objectness_thresh: float
    variance: Tuple[float, float]
    nms_top_k: int = 200


def fused_nms_settings(num_classes: int, fused_nms: Mapping) -> FusedNms:
    """Validate a ``fused_nms`` mapping; missing keys take DetectConfig's
    defaults and ``nms_top_k=200``."""
    known = {"nms_thresh", "conf_thresh", "objectness_thresh", "variance",
             "nms_top_k", "plus_one"}
    unknown = set(fused_nms) - known
    if unknown:
        raise ValueError(f"fused_nms: unknown keys {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    if fused_nms.get("plus_one", False):
        # +1 is a pixel-space area rule; on normalized 0-1 boxes it would
        # swamp every area and let every IoU test pass.
        raise ValueError(
            "fused_nms: plus_one=True is pixel-space semantics; the "
            "serving function runs NMS on normalized 0-1 boxes "
            "(scale-invariant only without +1). Use plus_one=False "
            "(default).")
    dc = DetectConfig(num_classes=num_classes)
    return FusedNms(
        nms_thresh=float(fused_nms.get("nms_thresh", dc.nms_thresh)),
        conf_thresh=float(fused_nms.get("conf_thresh", dc.conf_thresh)),
        objectness_thresh=float(fused_nms.get("objectness_thresh",
                                              dc.objectness_thresh)),
        variance=tuple(fused_nms.get("variance", dc.variance)),
        nms_top_k=int(fused_nms.get("nms_top_k", 200)))


def fused_postprocess(heads, priors: torch.Tensor, opts: FusedNms,
                      plain: bool = False) -> torch.Tensor:
    """Raw heads -> ``dets [B, C-1, K, 5]`` (x1, y1, x2, y2, score).
    ``plain=True`` runs the NMS sweep's plain version instead of K1."""
    arm_loc, arm_conf, odm_loc, odm_conf = heads
    boxes, scores = detect_refinedet(
        arm_loc, torch.softmax(arm_conf, dim=-1), odm_loc,
        torch.softmax(odm_conf, dim=-1), priors, variances=opts.variance,
        objectness_thresh=opts.objectness_thresh)
    cls_scores = scores[..., 1:].movedim(-1, 1)  # [B, C-1, P]
    bx, sc = class_parallel_nms(
        boxes[:, None], cls_scores, opts.nms_thresh, top_k=opts.nms_top_k,
        score_thresh=opts.conf_thresh, plus_one=False, plain=plain)
    return torch.cat([bx, sc[..., None]], dim=-1)


def _mean_bgr(uint8_input: bool,
              input_mean: Optional[Sequence[float]]
              ) -> Optional[Tuple[float, float, float]]:
    """The per-channel mean (BGR) the uint8 wire subtracts, or None."""
    if input_mean is not None and not uint8_input:
        raise ValueError("input_mean only applies with uint8_input=True "
                         "(the f32 wire is already mean-subtracted)")
    if not uint8_input:
        return None
    mean = tuple(float(m) for m in (input_mean if input_mean is not None
                                    else VOC_MEANS))
    if len(mean) != 3:
        raise ValueError(f"input_mean needs 3 channels, got {mean}")
    return mean


class InferenceModule(nn.Module):
    """The device half of serving, images ``[B, S, S, 3]`` to outputs: the
    one function both ``make_serving_fn`` and the artifact run.

    With a mean, the input is raw uint8 RGB and ``x.float() - mean_rgb``
    is its first op (exact for integer pixels); the mean is given in BGR,
    the reference's config convention, and reversed, as BaseTransform
    subtracts in BGR and then flips. In bf16 the network runs under
    autocast, as ``RefineDetModel.raw_forward`` does. Without ``opts`` the
    output is ``RefineDetModel.apply``'s (boxes, scores); with it,
    ``fused_postprocess``'s dets.
    """

    def __init__(self, model, opts: Optional[FusedNms] = None,
                 mean_bgr: Optional[Sequence[float]] = None):
        super().__init__()
        self.net = model.net
        self.register_buffer("priors", model.priors)
        self.register_buffer(
            "mean_rgb", None if mean_bgr is None else torch.tensor(
                mean_bgr[::-1], dtype=torch.float32,
                device=model.priors.device))
        self.device_type = model.priors.device.type
        self.bf16 = model.dtype == torch.bfloat16
        self.opts = opts
        self.detect = model.detect

    def forward(self, images: torch.Tensor):
        x = images if self.mean_rgb is None else \
            images.float() - self.mean_rgb
        with torch.autocast(device_type=self.device_type,
                            dtype=torch.bfloat16, enabled=self.bf16):
            heads = self.net(x)
        if self.opts is not None:
            return fused_postprocess(heads, self.priors, self.opts)
        arm_loc, arm_conf, odm_loc, odm_conf = heads
        arm_probs = torch.softmax(arm_conf, dim=-1)
        odm_probs = torch.softmax(odm_conf, dim=-1)
        if self.detect is not None:
            return self.detect.forward(arm_loc, arm_probs, odm_loc,
                                       odm_probs, self.priors)
        return detect_refinedet(arm_loc, arm_probs, odm_loc, odm_probs,
                                self.priors)


def inference_module(model, state: Optional[Mapping] = None,
                     fused_nms: Optional[Mapping] = None,
                     uint8_input: bool = False,
                     input_mean: Optional[Sequence[float]] = None
                     ) -> InferenceModule:
    """``InferenceModule`` over a test-phase ``model``, checked: ``state``,
    if given, is strict-loaded into ``model.net`` first, and the net is
    put in eval mode."""
    if model.phase != "test":
        raise ValueError("serving requires a 'test'-phase model")
    mean_bgr = _mean_bgr(uint8_input, input_mean)
    opts = (fused_nms_settings(model.num_classes, fused_nms)
            if fused_nms is not None else None)
    if state is not None:
        model.net.load_state_dict(state, strict=True)
    model.net.eval()
    return InferenceModule(model, opts, mean_bgr)


def _numpy(out):
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return tuple(o.cpu().numpy() for o in out)


def make_serving_fn(model, state: Optional[Mapping] = None,
                    fused_nms: Optional[Mapping] = None,
                    uint8_input: bool = False,
                    input_mean: Optional[Sequence[float]] = None
                    ) -> Callable:
    """A numpy -> numpy inference function over ``model`` (test phase).

    ``state``, if given, is strict-loaded into ``model.net`` first.
    Without ``fused_nms`` the function returns the model's (boxes,
    scores); with it, ``dets [B, C-1, K, 5]`` (see ``fused_nms_settings``
    for the keys). The input is NHWC float32 mean-subtracted RGB, or with
    ``uint8_input`` raw uint8 RGB pixels that are mean-subtracted on the
    device (exact for integer pixels), by ``input_mean`` (BGR, default
    ``VOC_MEANS``).
    """
    module = inference_module(model, state, fused_nms, uint8_input,
                              input_mean)
    device = model.device
    in_dtype = np.uint8 if uint8_input else np.float32

    def serve(images: np.ndarray):
        images = np.asarray(images, in_dtype)
        if images.ndim != 4 or \
                images.shape[1:] != (model.size, model.size, 3):
            raise ValueError(f"expected images [B, {model.size}, "
                             f"{model.size}, 3], got {images.shape}")
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            return _numpy(module(x))

    return serve


def export_inference(model, state: Optional[Mapping] = None,
                     batch_size: Optional[int] = None,
                     fused_nms: Optional[Mapping] = None,
                     uint8_input: bool = False,
                     input_mean: Optional[Sequence[float]] = None
                     ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``make_serving_fn``'s device function over
    ``model`` (test phase), weights and priors included, on the model's
    device.

    ``batch_size=None`` exports a symbolic batch dimension (traced at a
    batch of 2, valid from 1 up): one artifact serves any batch. An integer
    fixes the batch. ``fused_nms``, ``uint8_input`` and ``input_mean``
    (BGR, default ``VOC_MEANS``) are ``make_serving_fn``'s.
    """
    module = inference_module(model, state, fused_nms, uint8_input,
                              input_mean)
    b = 2 if batch_size is None else int(batch_size)
    example = torch.zeros((b, model.size, model.size, 3),
                          dtype=torch.uint8 if uint8_input else torch.float32,
                          device=model.priors.device)
    dynamic = None if batch_size is not None else \
        ({0: torch.export.Dim("batch", min=1)},)
    program = torch.export.export(module, (example,),
                                  dynamic_shapes=dynamic)
    # The zeros it was traced at would be saved with it (4.8 MB at 896).
    program.example_inputs = None
    return program


def serving_metadata(model, batch_size: Optional[int] = None,
                     fused_nms: Optional[Mapping] = None,
                     uint8_input: bool = False,
                     input_mean: Optional[Sequence[float]] = None) -> Dict:
    """The artifact's metadata: the JAX package's keys, with ``dtype``
    beside its ``platforms`` and ``torch_version`` for its
    ``jax_version``. ``write_serving`` adds ``platforms`` and
    ``program_bytes``."""
    mean_bgr = _mean_bgr(uint8_input, input_mean)
    if uint8_input:
        inp = ("NHWC uint8, raw RGB pixels; the artifact subtracts "
               "input_mean_bgr (reversed to RGB) on device")
    else:
        inp = "NHWC float32, mean-subtracted RGB (BaseTransform)"
    output = FUSED_OUTPUT if fused_nms is not None else \
        "(boxes[b,N,4], scores[b,N,C]) raw Detect_RefineDet path"
    return {
        "format": FORMAT,
        "input_size": model.size,
        "num_classes": model.num_classes,
        "batch_size": batch_size,  # None = symbolic (any batch)
        "use_bn": model.use_bn,
        "int8": bool(model.quant),
        "quant_skip": list(model.quant_skip) if model.quant else None,
        "dtype": str(model.dtype).replace("torch.", ""),
        "fused_nms": dict(fused_nms) if fused_nms is not None else None,
        "input_dtype": "uint8" if uint8_input else "float32",
        "input_mean_bgr": list(mean_bgr) if mean_bgr else None,
        "input": inp,
        "output": output,
        "torch_version": torch.__version__,
    }


def check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    """``platforms`` as a tuple of distinct device types, each ``cuda``
    or ``cpu``; ``cuda`` needs a visible card."""
    platforms = tuple(platforms)
    if "tpu" in platforms:
        raise ValueError(
            "platforms: 'tpu' programs are written by the JAX package's "
            "exporter (python tools/export_serving.py --platforms tpu,...); "
            f"this one writes {'/'.join(PLATFORMS)} programs")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms: distinct entries of {PLATFORMS} "
                         f"expected, got {platforms}")
    if "cuda" in platforms:
        resolve_device("cuda")
    return platforms


def model_on(model, platform: str):
    """``model`` itself if it lives on ``platform``, else a copy of it
    (net, priors) on that device type; ``model`` is not moved."""
    if model.device.type == platform:
        return model
    other = copy.copy(model)
    other.device = torch.device(platform)
    other.net = copy.deepcopy(model.net).to(other.device)
    other.priors = model.priors.to(other.device)
    return other


def write_serving(path: str,
                  programs: Mapping[str, torch.export.ExportedProgram],
                  meta: Mapping) -> Dict:
    """Write one artifact file holding ``programs`` (device type ->
    program) and ``meta``; returns the metadata as written, with
    ``platforms`` and ``program_bytes``."""
    blobs = []
    for program in programs.values():
        blob = io.BytesIO()
        torch.export.save(program, blob)
        blobs.append(blob.getbuffer())
    meta = dict(meta, platforms=list(programs),
                program_bytes=[len(b) for b in blobs])
    header = json.dumps(meta, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for blob in blobs:
            f.write(blob)
    return meta


def save_serving(model, state: Optional[Mapping], path: str,
                 batch_size: Optional[int] = None,
                 fused_nms: Optional[Mapping] = None,
                 uint8_input: bool = False,
                 input_mean: Optional[Sequence[float]] = None,
                 platforms: Optional[Sequence[str]] = None) -> dict:
    """Export and write a serving artifact; returns its metadata.

    One program per entry of ``platforms`` (``cuda``, ``cpu``; default
    the model's own device type), each exported from the model's weights
    on that device (a copy where it is not the model's), so the file
    holds the weights once per platform. ``state``, if given, is
    strict-loaded into ``model.net`` first."""
    platforms = check_platforms(platforms or (model.device.type,))
    if state is not None:
        model.net.load_state_dict(state, strict=True)
    programs = {p: export_inference(model_on(model, p),
                                    batch_size=batch_size,
                                    fused_nms=fused_nms,
                                    uint8_input=uint8_input,
                                    input_mean=input_mean)
                for p in platforms}
    meta = serving_metadata(model, batch_size, fused_nms, uint8_input,
                            input_mean)
    return write_serving(path, programs, meta)


# each hand-written kernel's wrapper by the BucketGraph attribute that
# holds its launches in one graph
_COUNTED = {"launches": nms_cuda.nms_sweep,
            "int8_launches": int8_conv.int8_conv,
            "quant_launches": int8_conv.int8_quantize,
            "epilogue_launches": conv_epilogue.conv_bias_relu}


class BucketGraph:
    """The artifact at one batch size as one CUDA graph: a static input
    buffer, the graph, its static outputs, and the kernel launches it
    holds.

    Capture runs the module twice on a side stream first (the kernels'
    builds, cuDNN's plans, the allocator's warm-up); a capture that fails
    raises. The kernels' wrappers count a launch recorded into the graph
    in ``nms_sweep.captured`` (K1), ``int8_conv.captured``,
    ``int8_quantize.captured`` and ``conv_bias_relu.captured``; the graph
    holds their launches in ``launches``, ``int8_launches``,
    ``quant_launches`` and ``epilogue_launches`` (``_COUNTED``), and every
    replay adds them to the wrappers' ``launches``.
    """

    def __init__(self, module: nn.Module, static_in: torch.Tensor,
                 pool=None):
        self.static_in = static_in
        side = torch.cuda.Stream(static_in.device)
        side.wait_stream(torch.cuda.current_stream(static_in.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                module(static_in)
        torch.cuda.current_stream(static_in.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = {attr: op.captured for attr, op in _COUNTED.items()}
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = module(static_in)
        for attr, op in _COUNTED.items():
            setattr(self, attr, op.captured - before[attr])

    def replay(self, images: torch.Tensor):
        """Copy ``images`` (host) into the static input, replay, and
        return the static outputs (overwritten by the next replay)."""
        with span("serve.h2d", device=True):
            self.static_in.copy_(images)
        with span("serve.replay"):
            self.graph.replay()
        for attr, op in _COUNTED.items():
            op.launches += getattr(self, attr)
        return self.out


class ServingModel:
    """A loaded program of an artifact: ``serving(images) -> outputs`` as
    numpy, run under ``inference_mode`` on the device the program was
    exported for (``meta["device"]``).
    A call at a batch size ``warm_up`` captured replays its CUDA graph;
    any other runs the exported program eagerly. Calls are serialized
    and counted (``calls``). Under a profiler a call records the span
    ``serve.call`` (its id the call's count) around ``serve.h2d`` (the
    copy into the graph's input) and ``serve.replay``, or
    ``serve.eager``, then ``serve.d2h`` (the copy of the outputs to the
    host, timed on the host alone: the copy blocks, so its time holds
    the wait for the replay) (``utils/timer.span``)."""

    def __init__(self, meta: Dict, program: torch.export.ExportedProgram):
        self.meta = meta
        self.program = program
        self.module = program.module()
        self.device = torch.device(meta["device"])
        self.input_dtype = np.dtype(meta["input_dtype"])
        size = meta["input_size"]
        self.input_shape = (size, size, 3)
        self.graphs: Dict[int, BucketGraph] = {}
        self.calls = 0
        self._lock = threading.Lock()

    def _check_batch(self, n: int) -> None:
        want = self.meta["batch_size"]
        if want is not None and n != want:
            raise ValueError(
                f"artifact was exported for batch {want}, "
                f"got {n} (re-export with batch_size=None "
                "for a symbolic batch)")

    def __call__(self, images):
        images = np.asarray(images, self.input_dtype)
        if images.ndim != 4 or images.shape[1:] != self.input_shape:
            raise ValueError(f"expected images [B, {self.input_shape[0]}, "
                             f"{self.input_shape[1]}, 3], got "
                             f"{images.shape}")
        self._check_batch(images.shape[0])
        x = torch.from_numpy(np.ascontiguousarray(images))
        with self._lock, torch.inference_mode():
            self.calls += 1
            with span("serve.call", id=self.calls):
                graph = self.graphs.get(images.shape[0])
                if graph is not None:
                    out = graph.replay(x)
                else:
                    with span("serve.eager"):
                        out = self.module(x.to(self.device))
                with span("serve.d2h"):
                    return _numpy(out)

    def warm_up(self, batch_sizes: Sequence[int]) -> None:
        """Make each batch size ready before the first request: on the
        card, capture one CUDA graph each (largest first, into one memory
        pool); elsewhere, run each once."""
        for b in batch_sizes:
            self._check_batch(b)
        dtype = torch.uint8 if self.input_dtype == np.uint8 else \
            torch.float32
        with self._lock, torch.inference_mode():
            if self.device.type != "cuda":
                for b in batch_sizes:
                    self.module(torch.zeros((b, *self.input_shape),
                                            dtype=dtype))
                return
            nms_cuda.load_kernel()
            if self.meta.get("int8"):
                int8_conv.load_kernel()
            pool = torch.cuda.graph_pool_handle()
            for b in sorted(set(batch_sizes), reverse=True):
                static_in = torch.zeros((b, *self.input_shape), dtype=dtype,
                                        device=self.device)
                self.graphs[b] = BucketGraph(self.module, static_in, pool)


def load_serving(path: str, device: str = "cuda") -> ServingModel:
    """Load the ``device`` program of an artifact written by
    ``save_serving``. Needs torch and ``refinedet_tpu_torch.ops``
    (imported by this module: it registers the K1 and int8 ops the
    program calls), and no model class, checkpoint or config.

    Raises for a file of the JAX package, for a file that holds no
    program for ``device``'s type (naming the ones it holds), and for
    ``cuda`` on a host without a card. It never takes another device's
    program in place of the one asked for."""
    want = torch.device(device)
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            if magic.startswith(JAX_MAGIC):
                raise ValueError(
                    f"{path}: a serving artifact of the JAX package "
                    "(refinedet_tpu.serve); this loader reads artifacts "
                    "written by refinedet_tpu_torch.serve.save_serving")
            raise ValueError(f"{path}: not a refinedet-tpu-torch serving "
                             f"artifact (magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        if "platforms" not in meta:  # the first layout: one program
            meta["platforms"] = [torch.device(meta.pop("device")).type]
            meta["program_bytes"] = [None]
        platforms = meta["platforms"]
        if want.type not in platforms:
            raise ValueError(
                f"{path} holds programs for {platforms}, none for "
                f"{want.type}: export one with --platforms "
                f"{','.join(platforms + [want.type])}")
        if want.type == "cuda":
            resolve_device(want)
            if want.index is None:
                want = torch.device("cuda", torch.cuda.current_device())
        i = platforms.index(want.type)
        f.seek(sum(meta["program_bytes"][:i]), io.SEEK_CUR)
        blob = f.read(meta["program_bytes"][i] or -1)
    meta["device"] = str(want)
    return ServingModel(meta, torch.export.load(io.BytesIO(blob)))
