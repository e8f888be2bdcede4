#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (refinedet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit and no result line:

  1. device: the card, torch/CUDA versions, the K1 build (nvcc, ptxas -v);
  2. K1 against its plain version on the card, exact keep masks, on
     candidates from the model's real post-softmax scores and on synthetic
     boxes, both area conventions, edge cases, ragged K (1, 63, 64, 65,
     129, 1000, 1024 for one group) and K = the kernel's limit;
  3. the serving slice: RefineDet320 (VOC, 21 classes, 6375 priors) with
     seeded weights, fused-NMS serving through BatchingEngine from several
     client threads and over HTTP; K1's launch count must rise;
  4. kernel path against plain path on the same heads (exact), and the
     card's f32 heads against the CPU's on a small input;
  5. timings on the card: K1's device time per launch at the serving and
     detect shapes (a CUDA graph of 50 launches, replayed between CUDA
     events, so the wrapper's host cost is left out and printed on its own
     line), its plain version's (CUDA events), and per batch of 32 in f32
     and bf16 the forward, the fused post-process (CUDA events) and
     end-to-end serving (host clock, numpy in to numpy out);
  6. the training slice, RefineDet320 (VOC, 21 classes), full width,
     ``max_boxes`` 60, on an in-memory dataset made from a numpy seed (no
     cv2 on the card's host): (a) one f32 step at batch 2 on the card
     against the same step on the CPU, from the same weights and batch
     (losses rtol 2e-4, each parameter's update a relative L2 norm of
     2e-2); (b) ``Trainer(...).train()`` at batch 32 in bf16 for 10 steps
     into a temporary folder, every logged loss finite, the ``final`` and
     epoch-10 checkpoints, a fresh ``Trainer.resume(10)`` restoring the
     step, weights and momentum exactly, and one more step from it equal
     to one from the live state; (c) 10 f32 steps on one batch of 32, the
     loss falls; (d) per step at batch 32 in f32 and bf16 the whole step
     (CUDA events over 10 back-to-back steps after warm-up) and its split
     into the forward, the losses (matching, mining, losses), the
     backward and the optimizer (CUDA events, the card held by a spin
     until the host has issued the step, so a phase's time is the card's
     work alone) beside the host's time to issue each, images/s, peak
     memory, the step's TFLOP/s from the port's conv shapes against the
     data-sheet peak, and on the host clock the Trainer's end-to-end
     images/s over an epoch of 50 steps after a warm-up epoch and its
     feed's alone. The training path launches no hand-written kernel: K1
     must not be launched there;
  7. the eval slice, bf16, batch 8, through ``eval.Evaluator`` and
     ``cli_coco.make_loader``, on in-memory eval sets made from a numpy
     seed (``tools/eval_check.py``): (a) VOC path, RefineDet320, 21
     classes, 6b's ``final`` checkpoint, 128 images, ``nms_top_k`` 300,
     IoU 0.45, no +1, VOC07 mAP; (b) SSDD path, RefineDet512, 2 classes,
     seed-0 weights saved as a bare reference-key ``.pth``, 64 images,
     ``top_k`` 1000, ``keep_top_k`` 500, IoU 0.49, +1 areas, the 12 COCO
     stats. K1 must launch exactly once per batch. (c) A second run of
     each records every batch's heads: the plain post-process on them
     must equal the kernel path's exactly. (d) Per run: the Evaluator's
     FPS and p50 batch latency, and the whole run's images/s (host
     clock), forward and post-process ms per batch (CUDA events), K1 at
     the eval shape (graph replay) beside its plain version and bound,
     the host seconds of the AP, and the staging's images/s alone;
  8. the BN variant and the five-source RefineDet896, 2 classes, full
     width: (a) one step of RefineDet512-BN at batch 2 on the card against
     the same step on the CPU, the network in float64 on both (losses
     rtol 2e-4, each parameter's update a relative L2 norm of 2e-2, the
     running statistics rtol 1e-4 of each tensor's largest magnitude; in
     float32 the train-mode BN forward of a random-init net on these
     images is ill-conditioned: two CPU thread counts give running
     statistics 1e-3 apart and flip a match); (b) RefineDet896-BN in
     bf16 served at batch 8 through ``make_serving_fn(...,
     fused_nms={})``: K1 once per batch (G = 8, K = 200), the kernel
     path equal to the plain path on
     the same heads, then 10 bf16 train steps at batch 8 on one batch of
     an in-memory 896² set (losses finite, the loss falls, every running
     statistic moved, no K1 launch); (c) at batch 8 in bf16 the forward
     and the fused post-process (CUDA events), end-to-end serving (host
     clock), K1 at G = 8, K = 200 (graph replay) beside its plain version
     and bound, and the whole step with images/s, peak memory and
     TFLOP/s;
  9. on-device augmentation (``data/augment.py``), RefineDet320, VOC
     table, full width, ``max_boxes`` 60, staging 640, on the staged
     in-memory set (``tools/train_check.py:StagedSyntheticDetection``,
     uint8 RGB as ``StagingTransform`` hands it on): (a) ``augment_batch``
     on the card against the CPU on the same draws and images, batch 8
     (images 1e-3 absolute on the 0-255 scale, boxes 1e-5; valid and the
     trial taken exact except at a crop test within 1e-5 of its threshold,
     counted); (b) ``Trainer(..., TrainConfig(on_device_augment=True,
     mean=VOC_MEANS)).train()`` in bf16 at batch 32 for 10 steps into a
     temporary folder, every logged loss finite; ``Trainer.resume(10)``
     gives the step, and the next step's augmented batch and one step
     from each (cuDNN deterministic) equal the uninterrupted run's; two
     steps under ``set_sync_debug_mode("error")``; (c) beside the card's
     name and power limit: ``augment_batch`` per batch of 32 and its split
     into the draws, photometric, crop selection and resample (CUDA
     events), the augmented bf16 step against 6d's plain one, the host's
     time to issue ``augment_batch`` and the step (no sync), the bytes
     copied to the card per batch, the augmented Trainer's images/s end to
     end and its feed's alone (host clock, as 6d), and ``augment_batch``
     at 896's staging of 1792, batch 8. K1 must not be launched;
 10. the serving artifact (``serve/export.py``), exported on the card with
     fused NMS and a symbolic batch, written and loaded back in this
     process: (a) RefineDet320 (VOC, 21 classes) in bf16 and f32 equal
     ``make_serving_fn`` exactly at batches 1, 8 and 32; the file holds
     the weights once and the loaded conv weights stay NHWC; (b) the bf16
     artifact behind ``BatchingEngine`` and ``Server``, one CUDA graph per
     bucket captured at warm-up, each replay equal to the eager artifact
     exactly and counting one K1 launch, then requests from several client
     threads and over HTTP: K1 once per device batch; (c) RefineDet896-BN
     (2 classes) in bf16 with the uint8 wire and the SSDD mean 98.13131
     equal to the live function exactly at batch 8; (d) beside the card's
     name and power limit, per batch of 32 at 320 and of 8 at 896-BN: the
     live function, the artifact eager and the graph replay, each end to
     end (host clock), on the device (CUDA events, card preloaded) and the
     share outside the device; export, save, load and capture seconds and
     the file's MB; (e) RefineDet320 in f32 (the ODM confidence head at
     zero weights and seeded biases, as the CPU export test's, and the
     loc heads' weights scaled by 1/100 so the decoded boxes stay near
     their anchors) exported with ``platforms=("cuda", "cpu")`` into one
     file: the cuda program equals the live function on the card
     exactly, the cpu program the live function of the model's CPU copy
     exactly, and card and CPU agree on at least 99% of the kept
     detection rows within 6a's rtol of 2e-4 (a row flips only where an
     IoU test lies within the forwards' drift of the threshold); the
     file's MB against the weights' (once per program);
 11. int8 PTQ (``quant/``) on the int8 path's two kernels
     (``csrc/int8_conv.cu``: the convolution on wgmma fed by TMA, the
     activation quantize in one pass), RefineDet320 (VOC, 21 classes),
     bf16, the default ``quant_skip``: (a) the convolution against its
     plain version at every distinct conv of the 320 set
     (``quant_skip=()``) at batches 1, 2, 4, 8, 16 and 32 (every bucket
     of a ``max_batch`` 32 engine, 13c's, and the tools' eval batch 16)
     and of the 512 set at 8, the int32 sums and the bf16 outputs bitwise
     equal (split-K plans included); the quantize against its plain
     version at every served input shape at the same batches, bf16 and
     f32, edge values
     included, bitwise; (b) PTQ on
     the card: seeded weights calibrated on in-memory images
     (``tools/eval_check.py``), the card's f32 statistics against the
     CPU's (1e-4 of each conv's largest; ``kernel_q`` exact for every conv whose statistics
     are equal), bias correction and GPTQ on two named convs, the card's
     GPTQ rounding against the CPU's on the same Hessian; (c) the int8
     artifact with fused NMS, exported on the card, equal to the live int8
     function exactly at batches 1, 8 and 32, then served through
     ``BatchingEngine`` and HTTP with one CUDA graph per bucket, each
     holding 26 convolution, 26 quantize and one K1 launch: the counts
     rise by that much per device batch; (d) beside the card's name and
     power limit: per distinct conv at batch 32 the kernel (graph
     replay) with its tile plan, its plain version, its bound, the
     ``torch._int_mm`` library call and cuDNN's bf16 conv, summed per
     forward; per served input shape the quantize (graph replay), its
     plain version and its bound, summed per forward; each wrapper's host
     us a call; the strided inputs the quantize copied (none expected);
     the ``IGMMA`` and ``UTMALDG`` instructions in the library's SASS; the
     int8 forward and end to end at batch 32 against the bf16 network's in
     the same call; calibration and GPTQ seconds; (e) int8 eval on the
     in-memory SSDD set (RefineDet512, 2 classes, +1 areas): K1 once per
     batch, 26 convolution and 26 quantize launches per batch, the kernel
     post-process equal to the plain one on every batch;
 12. data parallelism (``parallel/``, the data-parallel train step and
     Evaluator): (a) under a one-rank NCCL process group, one step of
     RefineDet320 in bf16 at batch 32 and of RefineDet512-BN in float64
     at batch 2 with the grouped path (``DistributedDataParallel``, the
     all-reduced N of the loss, the synced BN) against the ungrouped
     step from the same weights (6a's and 8a's limits); (b) two gloo
     ranks spawned on the one card (NCCL refuses two ranks on one
     device) and a reference process without a group
     (``tools/ddp_check.py``): 3 f32 steps of RefineDet320 at global
     batch 4 (the ranks bitwise equal; parameters within the JAX
     package's multi-process limits, updates 2e-2), one float64 step of
     RefineDet512-BN (running statistics and updates 1e-9, the float32
     L2Norm scales 1e-6), and the 2-rank Evaluator on 7a's VOC set at
     batch 8 a rank against one process at batch 8 (``all_boxes``
     exactly equal; K1's launches in the three processes counted in the
     kernels line); (c) beside the card's name and power limit: the bf16
     step at batch 32 with DDP at world 1 against the ungrouped step
     (CUDA events, in turns) and the host's time to issue each, the NCCL
     all-reduce of the 34M f32
     gradients alone, and the 2-rank gloo step's host ms, a correctness
     run through the host and not a scaling figure;
 13. the trained-fixture tools (``refinedet_tpu_torch/tools/``: the
     fixtures, the shared training core, ``smoke_e2e``, ``ablate_int8``,
     ``bench_serve``), RefineDet320, full width: (a) ``smoke_e2e`` at its
     defaults (the 16-image SSDD-like fixture of seed 3, 600 bf16 steps
     from scratch): the first logged loss at least 10x the last, train-set
     AP50 (the port's COCOeval, K1 once per eval batch) at least 0.50;
     (b) the arms bf16, noise-ctl-default, int8-default and
     int8-default-gptq-bc (one calibration of 16 images) on
     ``ablate_int8``'s seed 0 trained here (64 images in 4 rotating
     batches, 2500 steps, the decay schedule): each int8 arm's dAP50
     against bf16 at least -0.10, the JAX repo's ``--int8_max_drop``
     (13a's weights, 16 memorized images at the peak lr, are too
     sensitive to any weight perturbation for that limit:
     ``tools/int8_witness`` scores them); (c) ``bench_serve`` at its defaults (64
     clients, 256 requests, ``max_batch`` 32) with ``--fused_nms`` (f32)
     and with ``--int8 --fused_nms``: every leg (the engine twice, HTTP)
     with 0 errors; req/s, p50/p99 and the batch histogram printed;
     (d) K1's, the int8 conv's and the quantize's launches in 13a-c,
     printed, each above 0; then K1 at the tools' eval shapes on 13a's
     trained candidates (G = 16 and 48, K = 128, +1 areas): the keep
     mask equal to its plain version's, graph replay beside the plain
     version's time and the bound;
 14. profiling on the card (``utils/timer.py``, ``utils/trace_summary.py``
     and the four tools), beside the card's name and power limit: (a)
     ``trace_infer``: RefineDet320 bf16 inference at batch 128, 4
     executions back to back under ``torch.profiler``, summarized (each
     execution's device ms, the gaps, the idle %, the device time by
     launching op, the top kernels and layout copies; each execution's
     busy time within its span, the categories adding up to the device
     total); (b) ``trace_train_step``: the bf16 train step at batch 128,
     3 steps, the same; (c) ``profile_train_step --remat`` at batch 64,
     10 iterations: each variant's ms and peak memory and the attribution
     block; (d) ``flops_train_step`` at batch 64: FLOPs and unfused bytes,
     and with (c)'s ``full`` ms the step's TFLOP/s against the dense bf16
     peak; (e) one eager fused-NMS serving batch of 32 and one int8
     forward under ``profile_trace``: the trace's calls of the op and its
     kernels by name for K1, the int8 conv and the quantize equal the
     wrappers' counts, 1, 26 and 26 (these launches count in the kernels
     line); (f) ``ops/nms.py:soft_nms`` on the card, linear, gaussian and
     hard on a seeded K = 200 set: indices and keep equal the CPU's and
     the kept set the host ``nms_native.soft_nms``'s, scores bitwise
     (gaussian within 20 ulps), ms a call and kernel launches a call;
 15. spatial sharding (``--spatial_shards``, ``parallel/spatial.py``),
     gloo ranks sharing the card (``tools/ddp_check.py``) against a
     reference process without a group: (a) two ranks at S = 2, each a
     band of every image's rows: 3 f32 steps of RefineDet320 at global
     batch 4 (12b's limits: the ranks bitwise equal, the JAX package's
     multi-process parameter limits, updates 2e-2, losses 1e-5) and one
     float64 step of RefineDet896-BN, 2 classes, five sources, batch 2
     (running statistics and updates 1e-9 relative, the float32 L2Norm
     scales 1e-6); (b) four ranks, data 2 x space 2: one f32 step of
     RefineDet320 at global batch 4 (12b's limits), and one with the
     on-device augmentation (staging 640) on the same draws, in f32
     (its updates printed, not held: cuDNN rounds a band's and the whole
     image's conv-bias gradients 3e-2 apart on these inputs) and in
     float64 (updates 1e-9), each against one process; (c) ``Trainer`` at S = 2 over two ranks, RefineDet320
     bf16, 3 steps into a temporary folder: every loss finite, rank 0's
     checkpoint, and a fresh Trainer on each rank resuming rank 0's state
     bitwise; (d) beside the card's name and power limit: each rank's
     peak memory in a bf16 RefineDet896-BN step at batch 8 at S = 2
     against one process's at batch 8, the halo and gather bytes a rank
     hands ``all_reduce`` a step, and the gloo step's host ms (a
     correctness run through the host, not a scaling figure). No
     hand-written kernel may launch in the phase;
 16. the space-to-depth stem twin (``models/stem_s2d.py``), the slice
     max-pool backward (``models/layers.py:POOL_BACKWARD``), their two
     bench tools and the demo core: (a) the ``stem_s2d`` twin against the
     standard model of the same seed at 320 and 512, batch 2: raw heads
     in f32 within JAX's 2e-3 of max(1, max |head|) and in bf16 within
     5e-2; at 320 the detect path with the loc heads scaled by 1e-3
     (boxes JAX's 1e-3 / 1e-4, scores 5e-4); fused-NMS serving through
     ``make_serving_fn`` in bf16 at batch 32 on ``separate_heads``'
     weights, 98% of each side's rows matched within rtol 2e-2
     (``matched_rows``), K1 once per batch; (b) the slice backward
     against ATen's, bitwise, f32 and bf16, channels-last: pool1's shape
     at batch 8, on normal and on tie-forcing quantized values, and an
     odd-sized ceil-mode input; one bf16 train step at batch 8 under each
     mode (cuDNN deterministic): loss, parameters and momentum bitwise
     equal; one ``--spatial_shards 2`` gloo run of 15a's steps under
     "slice" against one process under ATen's, 15a's limits (run in
     phase 15's spawn); (c) ``bench_stem_s2d`` and
     ``bench_pool_backward`` at their defaults (batch 128), each two
     variants in turns A, B, B, A with their peak memory, and each the
     part it changes alone (the stems; the five pools forward and
     backward, beside their bytes floor); (d)
     ``tools/demo.py:detect_image`` on a 320x320 BGR uint8 image, f32,
     on the card and on the CPU from the same weights
     (``separate_heads``), at least 99% of the rows above 0.2 matched
     within 6a's rtol 2e-4; K1's launches in 16a and 16d count in the
     kernels line;
 17. the convolution epilogue (``csrc/conv_epilogue.cu``, the op
     ``conv_bias_relu``: cuDNN's convolution without its bias, then the
     bias add and the ReLU in one pass in place), at the fused convs of
     each benchmark cell (RefineDet512 at batch 16, RefineDet320 at 64,
     the int8 twin's three at 32; ``tools/epilogue_bench.py``): (a) the op
     under bf16 autocast bitwise aten's conv with its bias and ``relu_``
     on seeded channels-last tensors at each distinct shape; (b) beside
     the card's name and power limit, per cell the epilogue's device ms
     over every fused output (graph replay), its bytes bound (each output
     read and written once at 3.35 TB/s) and share of it, aten's ``add_``
     + ``relu_`` on the same tensors, the wrapper's host us a call, and
     the share over the cell's outputs of 64 MiB or more alone.
     Its launches on the main paths count in the kernels line, each
     path's set to 0 just before it and checked just after against 25 a
     forward or graph replay (3 in the int8 twin, none in the BN
     variant): 3's serving, 6b's Trainer, 7a-c's eval, 8b's 896-BN
     serving, 10b's artifact, 11c's int8 artifact and 11e's int8 eval.

The line before the last is the card's name and power limit from
nvidia-smi; the last is {"ok": true, "device": {...}}. TF32 is off for
convolutions and matmuls, so f32 means f32.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

NUM_CLASSES = 21          # VOC table
SIZE = 320
SERVE_BATCH = 32          # G = 20 * 32 groups at the serving shape
NMS_TOP_K = 200           # fused serving default
DETECT_TOP_K = 1000       # DetectConfig.top_k
MAX_BATCH = 8             # BatchingEngine in phase 3
ENGINE_REQUESTS = 16      # from 4 client threads
HTTP_REQUESTS = 2
# Operations of one IoU test as the kernel computes it: 2 min, 2 max,
# 2 sub, 2 add, 2 clamp, mul, add, sub, div, compare.
IOU_OPS = 15
RAGGED_K = (1, 63, 64, 65, 129, 1000, 1024)  # one group each
LIMIT_GROUPS = 3                              # at K = the kernel's limit
H100_BYTES_PER_S = 3.35e12   # HBM3, data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, data sheet
H100_BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores, data sheet
TRAIN_BATCH = 32
TRAIN_MAX_BOXES = 60
TRAIN_STEPS = 10          # timed steps in 6d, steps of 6b and 6c
TRAIN_CLIP = 10.0         # from-scratch runs diverge without the clip
E2E_STEPS = 50            # the Trainer's timed epoch in 6d
PRELOAD_MS = 250          # card spin before each step of 6d's split
EVAL_BATCH = 8
VOC_EVAL_IMAGES = 128     # 7a: 16 batches, G = 8 * 20, K = 300
SSDD_EVAL_IMAGES = 64     # 7b: 8 batches, G = 8, K = 1000
SSDD_SIZE = 512
BN_STEP_SIZE = 512        # 8a: the reference's BN model
BN_SIZE = 896             # 8b, 8c: the five-source BN model, 2 classes
BN_PRIORS = 200508        # 3 * (224² + 112² + 56² + 28² + 14²)
BN_BATCH = 8              # G = 8 groups of K = NMS_TOP_K in serving
BN_SERVE_CALLS = 4        # 8b: serving batches on the main path
STAGING = 640             # 9: the on-device augmentation's canvas, 2 x 320
AUG_CHECK_BATCH = 8       # 9a: card against CPU
BN_STAGING = 1792         # 9c: 2 x 896
ARTIFACT_BATCHES = (1, 8, 32)  # 10a: artifact against the live function
ARTIFACT_REPS = 10        # 10d: timed calls of each path
ARTIFACT_SPIN_MS = 50     # 10d: card spin before each device-timed call
DETS_CARD_CPU_RTOL = 2e-4  # 10e: 6a's card-against-CPU rtol
PROFILE_INFER_BATCH, PROFILE_INFER_ITERS = 128, 4   # 14a: trace_infer's
PROFILE_TRAIN_BATCH, PROFILE_TRAIN_STEPS = 128, 3   # 14b: trace_train_step's
PROFILE_STEP_BATCH, PROFILE_STEP_ITERS = 64, 10     # 14c-d: the tools'
BF16_PEAK_TFLOPS = 989.0  # H100 SXM dense bf16, NVIDIA's data sheet
SOFT_NMS_K = 200          # 14f
# 14f: card against CPU; the CPU test's limits (tests/test_torch_port_nms)
SOFT_NMS_ULPS = {"linear": 0, "gaussian": 20, "hard": 0}
DDP_GLOBAL_BATCH = 4      # 12b: 2 gloo ranks x 2 rows on the one card
DDP_STEPS = 3             # 12b: f32 steps of RefineDet320
DDP_LR, DDP_CLIP = 1e-5, 5.0  # 12b: the JAX package's multi-process test's
SPATIAL_SHARDS = 2        # 15: image rows over 2 space ranks
SPATIAL_BN_BATCH = 2      # 15a: RefineDet896-BN, float64
SPATIAL_MEM_STEPS = 2     # 15d: bf16 896-BN steps at BN_BATCH
SPATIAL_TRAINER_BATCH = 8  # 15c
SPATIAL_TRAINER_STEPS = 3  # 15c: one step an epoch
STEM_SIZES = (320, 512)   # 16a
STEM_BATCH = 2            # 16a: raw heads and the detect path
STEM_F32_ATOL = 2e-3      # 16a: JAX's test's, of max(1, max |head|)
STEM_BF16_ATOL = 5e-2     # 16a: bf16 (stated; see PERF.md)
# 16a: the detect path's scores. JAX's test holds 1e-4 on flax's weights;
# the port's seed-0 ODM logits reach ~500 on pixel-scale images, where
# f32 re-association moves them ~1e-3 and the scores up to 2.1e-4 (CPU).
STEM_SCORE_ATOL = 5e-4
STEM_SERVE_BATCH = 32     # 16a: fused-NMS serving in bf16
STEM_SERVE_RTOL = 2e-2    # 16a: served rows, twin against standard, bf16
STEM_SERVE_MATCHED = 0.98  # 16a: share of rows matched
POOL_CHECK_BATCH = 8      # 16b: pool1's shape at this batch
POOL_STEP_BATCH = 8       # 16b: one bf16 train step in each mode
DEMO_THRESHOLD = 0.2      # 16d: separate_heads scores stay below 0.4
EPILOGUE_LARGE_BYTES = 64 << 20  # 17b: the epilogue's share on these alone
EPILOGUE_CONVS = 25       # conv_bias_relu launches a forward, 320 and 512
EPILOGUE_CONVS_INT8 = 3   # the same in the int8 twin (default quant_skip)
# the conv epilogue's launches on each main path that counts them (17)
EPILOGUE_PATHS: dict = {}
# 11a: kernels against plain, 320 set: every engine bucket up to 32 (13c)
INT8_CHECK_BATCHES = (1, 2, 4, 8, 16, 32)
INT8_CHECK_512_BATCH = 8      # 11a: the 512 set (SSDD eval) at this batch
INT8_CALIB_IMAGES = 8         # 11b: calibration images (batches of 4)
INT8_GPTQ_NAMES = ("extra_conv1", "tcb2_0_conv")  # 11b
INT8_TIME_BATCH = 32          # 11d
INT8_SSDD_IMAGES = 16         # 11e: 2 eval batches of 8
INT8_CONVS = 26               # quantized convs at the default quant_skip
TOOLS_LOSS_DROP = 10.0        # 13a: first logged loss / last
TOOLS_MIN_AP50 = 0.50         # 13a: train-set AP50 after 600 steps
TOOLS_INT8_MAX_DROP = 0.10    # 13b: the JAX repo's --int8_max_drop
TOOLS_ABLATE_STEPS, TOOLS_ABLATE_BATCH = 2500, 16  # 13b: ablate_int8 at 320
TOOLS_ARMS = ("bf16", "noise-ctl-default", "int8-default",
              "int8-default-gptq-bc")  # 13b
LOSS_KEYS = ("arm_loss_l", "arm_loss_c", "odm_loss_l", "odm_loss_c")
LOG_LOSSES = re.compile(r"ARM_L Loss: (\S+) ARM_C Loss: (\S+) ODM_L Loss: "
                        r"(\S+) ODM_C Loss: (\S+) loss: (\S+) \|\|")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_issue_ms(fn, reps: int) -> float:
    """Mean host time to issue ``fn()`` with no sync, the card idle at
    the start: the host's side of work the card queues."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def count_epilogue(path: str, forwards: int,
                   per_forward: int = EPILOGUE_CONVS) -> int:
    """The conv epilogue's launches on the main path ``path`` since
    ``conv_bias_relu.launches`` was set to 0 just before it, checked
    against ``per_forward`` for each of its ``forwards`` forwards or graph
    replays, and kept in ``EPILOGUE_PATHS`` for the kernels line."""
    from refinedet_tpu_torch.ops import conv_epilogue
    n = conv_epilogue.conv_bias_relu.launches
    check(n == per_forward * forwards,
          f"{path}: the conv epilogue launched {n} times for {forwards} "
          f"forwards of {per_forward} fused convs")
    log("epilogue", f"{path}: {n} conv epilogue launches, {per_forward} "
        f"for each of {forwards} forwards")
    EPILOGUE_PATHS[path] = n
    return n


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers, static shared memory and spill bytes
    from an ``nvcc -Xptxas -v`` log, by a short name (dynamic shared
    memory, the int8 conv's stages, is set at launch and not in it)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(int8_conv_kernel|int8_conv_reduce|"
                          r"int8_quantize_kernel|nms_sweep_kernel)(\w*)",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E", k.group(2)) if k else []
            if k and k.group(1) == "int8_quantize_kernel":
                args.insert(0, "f32" if k.group(2).startswith("If")
                            else "bf16")
            name = (k.group(1) if k else m.group(1)) + (
                f"<{','.join(args)}>" if args else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spills"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_static"] = int(smem.group(1)) if smem else 0
    return out


def sass_counts(path) -> dict:
    """``IGMMA`` (integer wgmma) and ``UTMALDG`` (TMA load) instructions
    in ``cuobjdump -sass`` of a built library, or why there are none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "absent"}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    lines = sass.splitlines()
    return {op: sum(op in line for line in lines)
            for op in ("IGMMA", "UTMALDG", "IMMA")}


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean host time of ``fn()``, which must end synchronized."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def spin_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that hold the card ~``ms``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return int(10 ** 7 / start.elapsed_time(end) * ms)


def device_ms(fn, reps: int, cycles: int) -> float:
    """Mean device time of ``fn()`` alone (CUDA events), the card held in
    a spin of ``cycles`` before each call, so the host has issued all of
    it before the card starts: the card's work, not its waits."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for i in range(reps + 1):  # the first is a warm-up
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if i else 0.0
    return total / reps


class Cycled:
    """``n`` items cycling over ``base``: an epoch of real length, with the
    same host work per item, without holding ``n`` images."""

    def __init__(self, base, n: int):
        self.base, self.n = base, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        return self.base[i % len(self.base)]


def train_phase(dev: torch.device, folder: str) -> dict:
    """Phase 6: the training slice on the card; returns its numbers. 6b's
    Trainer writes its checkpoints to ``folder``."""
    from refinedet_tpu_torch.config import TrainConfig
    from refinedet_tpu_torch.data.collate import detection_collate
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.ops import conv_epilogue
    from refinedet_tpu_torch.tools.train_check import (SyntheticDetection,
                                                       one_step,
                                                       separated_batch,
                                                       update_rel_errors)
    from refinedet_tpu_torch.train import (Trainer, create_train_state,
                                           make_optimizer, make_train_step,
                                           train_losses)

    out = {}
    bf16 = torch.bfloat16

    def build(dtype=torch.float32, device=dev, seed=0):
        return build_refinedet("train", SIZE, NUM_CLASSES, dtype=dtype,
                               device=device, seed=seed)

    def on_card(batch):
        return [torch.from_numpy(a).to(dev) for a in batch]

    # -- 6a. one f32 step, card against CPU ---------------------------------
    cfg = TrainConfig(max_boxes=TRAIN_MAX_BOXES)
    cpu_model = build(device="cpu")
    seed, batch = separated_batch(cpu_model, 2, TRAIN_MAX_BOXES, NUM_CLASSES,
                                  cfg.theta, cfg.overlap_thresh)
    gpu_model = build()
    want, want_up = one_step(cpu_model, batch, cfg, lr=cfg.lr)
    got, got_up = one_step(gpu_model, batch, cfg, lr=cfg.lr)
    loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in LOSS_KEYS)
    rel = update_rel_errors(got_up, want_up)
    worst = max(rel, key=rel.get)
    log("train", f"6a: batch seed {seed}, {int(batch.valid.sum())} GT "
        f"boxes; losses card {[round(got[k], 5) for k in LOSS_KEYS]} CPU "
        f"{[round(want[k], 5) for k in LOSS_KEYS]}, worst rel err "
        f"{loss_err:.3g} (limit 2e-4); positives ARM "
        f"{got['num_pos_arm']:g}/{want['num_pos_arm']:g} ODM "
        f"{got['num_pos_odm']:g}/{want['num_pos_odm']:g}")
    log("train", f"6a: {len(rel)} parameter updates, worst rel L2 err "
        f"{rel[worst]:.3g} ({worst}; limit 2e-2)")
    check(loss_err <= 2e-4, f"6a: card and CPU losses differ by {loss_err}")
    check(len(rel) > 50 and rel[worst] <= 2e-2,
          f"6a: {worst}'s update differs by {rel[worst]}")
    out["step_vs_cpu"] = {"loss_rel_err": loss_err,
                          "update_rel_err": rel[worst], "params": len(rel)}
    del cpu_model, gpu_model

    # -- 6b. the Trainer: bf16, batch 32, 10 epochs of one step --------------
    data = SyntheticDetection(TRAIN_BATCH, SIZE, NUM_CLASSES, seed=100)
    cfg = TrainConfig(batch_size=TRAIN_BATCH, max_boxes=TRAIN_MAX_BOXES,
                      max_epoch=TRAIN_STEPS, num_workers=4,
                      grad_clip_norm=TRAIN_CLIP)
    fixed = on_card(detection_collate([data[i] for i in range(len(data))],
                                      TRAIN_MAX_BOXES))
    lines = []
    live = Trainer(build(bf16), data, cfg, save_folder=folder,
                   dataset_name="SYN", log_fn=lines.append)
    conv_epilogue.conv_bias_relu.launches = 0
    state = live.train()
    count_epilogue("6b Trainer", TRAIN_STEPS)
    for line in lines:
        log("train", f"6b: {line}")
    losses = [float(v) for line in lines
              for v in LOG_LOSSES.search(line).groups()]
    check(len(lines) == TRAIN_STEPS and state.step == TRAIN_STEPS,
          f"6b: {len(lines)} log lines, step {state.step}")
    check(all(np.isfinite(losses)), "6b: a logged loss is not finite")
    for tag in ("final", TRAIN_STEPS):
        check(os.path.exists(live.ckpt.path(tag)),
              f"6b: no checkpoint {tag}")
    fresh = Trainer(build(bf16, seed=1), data, cfg, save_folder=folder,
                    dataset_name="SYN", log_fn=lines.append)
    rstate = fresh.resume(TRAIN_STEPS)
    check(rstate.step == state.step, f"6b: resumed step {rstate.step}")
    for (k, a), b in zip(live.model.net.state_dict().items(),
                         fresh.model.net.state_dict().values()):
        check(torch.equal(a, b), f"6b: resumed weight {k} differs")
    bufs = [(s["momentum_buffer"], r["momentum_buffer"]) for s, r in zip(
        live.optimizer.state_dict()["state"].values(),
        fresh.optimizer.state_dict()["state"].values())]
    check(len(bufs) > 50 and all(torch.equal(a, b) for a, b in bufs),
          "6b: resumed momentum buffers differ")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, _ = live.train_step(state, *fixed)
        rstate, _ = fresh.train_step(rstate, *fixed)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        live.model.net.state_dict().values(),
        fresh.model.net.state_dict().values()))
    log("train", f"6b: {TRAIN_STEPS} steps logged, all finite; resumed "
        f"epoch {TRAIN_STEPS}: step {rstate.step - 1}, weights and "
        f"{len(bufs)} momentum buffers exact; one more step from each "
        f"(cuDNN deterministic): max |live - resumed| {diff:g}")
    check(diff == 0.0, "6b: the step from the resumed state differs")
    del live, fresh, state, rstate

    # -- 6c. learning: 10 f32 steps on one batch -----------------------------
    model = build()
    opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                         grad_clip_norm=TRAIN_CLIP)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    falls = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, *fixed)
        falls.append(float(metrics["loss"]))
    log("train", f"6c: loss over {TRAIN_STEPS} f32 steps on one batch of "
        f"{TRAIN_BATCH}: {[round(v, 2) for v in falls]}")
    check(all(np.isfinite(falls)) and falls[-1] < falls[0],
          "6c: the loss did not fall")
    out["learning_losses"] = falls
    del model, opt, step, state

    # -- 6d. timings -----------------------------------------------------------
    flops = step_flops(NUM_CLASSES, SIZE, False, TRAIN_BATCH)
    log("time", f"train step work: {flops / 1e12:.4f} TFLOP per batch of "
        f"{TRAIN_BATCH} (convolutions: forward, and 2x for backward)")
    e2e_data = Cycled(SyntheticDetection(3 * TRAIN_BATCH, SIZE, NUM_CLASSES,
                                         seed=200), E2E_STEPS * TRAIN_BATCH)
    preload_cycles = spin_cycles(PRELOAD_MS)
    for dtype, peak in ((torch.float32, H100_F32_OPS_PER_S),
                        (bf16, H100_BF16_OPS_PER_S)):
        name = "f32" if dtype == torch.float32 else "bf16"
        model = build(dtype)
        opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                             grad_clip_norm=TRAIN_CLIP)
        step = make_train_step(model, opt, cfg)
        state = create_train_state(model, opt)
        for _ in range(3):
            state, _ = step(state, *fixed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: step(state, *fixed), TRAIN_STEPS, 0)
        peak_mem = torch.cuda.max_memory_allocated()
        # Each phase's device time (CUDA events) and the host's time to
        # launch it (no sync inside). The card first spins for PRELOAD_MS,
        # so the host has issued the whole step before the card reaches
        # it and the events time the card's work, not waits for the host.
        split, launch = np.zeros(4), np.zeros(4)
        for _ in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(preload_cycles)
            t = [time.perf_counter()]
            ev[0].record()
            heads = model.raw_forward(fixed[0], train=True)
            ev[1].record()
            t.append(time.perf_counter())
            loss, _ = train_losses(model, heads, *fixed[1:], cfg)
            ev[2].record()
            t.append(time.perf_counter())
            loss.backward()
            ev[3].record()
            t.append(time.perf_counter())
            opt.apply_gradients(0)
            ev[4].record()
            t.append(time.perf_counter())
            torch.cuda.synchronize()
            split += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
            launch += np.diff(t) * 1e3
        split /= TRAIN_STEPS
        launch /= TRAIN_STEPS
        tflops = flops / (step_ms / 1e3) / 1e12
        # The Trainer over an epoch of E2E_STEPS steps, after a warm-up
        # epoch; then the feed alone (the loader's collate, target check
        # and pinned copy, no step) over one more epoch.
        trainer = Trainer(model, e2e_data, dataclasses.replace(
            cfg, max_epoch=2, num_workers=8), log_fn=lambda line: None)
        tstate = trainer.train(max_epochs=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(tstate, start_epoch=1, max_epochs=1)
        torch.cuda.synchronize()
        e2e_ips = len(e2e_data) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        fed = sum(sb.wait().images.shape[0] for sb in trainer.loader)
        torch.cuda.synchronize()
        feed_ips = fed / (time.perf_counter() - t0)
        res = {"step_ms": step_ms, "forward_ms": float(split[0]),
               "losses_ms": float(split[1]),
               "backward_ms": float(split[2]),
               "optimizer_ms": float(split[3]),
               "host_launch_ms": [float(v) for v in launch],
               "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
               "trainer_images_per_s": e2e_ips,
               "feed_images_per_s": feed_ips,
               "peak_mem_bytes": peak_mem, "tflops": tflops,
               "peak_tflops": peak / 1e12,
               "share_of_peak": tflops / (peak / 1e12)}
        out[name] = res
        log("time", f"train {name} batch {TRAIN_BATCH}: step {step_ms:.2f} "
            f"ms = forward {split[0]:.2f} + losses {split[1]:.2f} + "
            f"backward {split[2]:.2f} + optimizer {split[3]:.2f} ms (split "
            f"timed apart, card preloaded {PRELOAD_MS} ms, sum "
            f"{split.sum():.2f}); {res['images_per_s']:.1f} images/s; "
            f"peak memory {peak_mem / 2**30:.2f} GiB; {tflops:.1f} TFLOP/s "
            f"of {peak / 1e12:g} peak ({100 * res['share_of_peak']:.1f}%)")
        log("time", f"train {name}: host time to launch forward "
            f"{launch[0]:.2f}, losses {launch[1]:.2f}, backward "
            f"{launch[2]:.2f}, optimizer {launch[3]:.2f} ms (sum "
            f"{launch.sum():.2f})")
        log("time", f"train {name}: Trainer end to end {e2e_ips:.1f} "
            f"images/s (host clock, an epoch of {E2E_STEPS} steps after a "
            f"warm-up epoch); its feed alone {feed_ips:.1f} images/s")
        del model, opt, step, state, trainer, tstate, heads, loss
        torch.cuda.empty_cache()
    out["step_tflop"] = flops / 1e12
    return out


def eval_phase(dev: torch.device, folder: str) -> tuple:
    """Phase 7: the eval slice on the card; returns its numbers and K1's
    launches on the two timed runs. 7a reads 6b's ``final`` checkpoint
    from ``folder``."""
    from refinedet_tpu_torch.config import MEANS, VOC_MEANS, DetectConfig
    from refinedet_tpu_torch.data import BaseTransform, VOC_CLASSES
    from refinedet_tpu_torch.data.loader import wait_for_copy
    from refinedet_tpu_torch.detect.detection import detect_refinedet
    from refinedet_tpu_torch.eval import Evaluator, evaluate_voc
    from refinedet_tpu_torch.eval import evaluator as evaluator_module
    from refinedet_tpu_torch.eval.cli_coco import make_loader
    from refinedet_tpu_torch.eval.evaluator import eval_postprocess
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.ops import conv_epilogue, nms_cuda
    from refinedet_tpu_torch.ops.nms import select_candidates
    from refinedet_tpu_torch.tools.eval_check import (SyntheticSSDD,
                                                      SyntheticVOC)
    from refinedet_tpu_torch.train.checkpoints import CheckpointManager

    ssdd_pth = os.path.join(folder, "ssdd512_seed0.pth")
    seed0 = build_refinedet("test", SSDD_SIZE, 2, device="cpu", seed=0)
    torch.save(seed0.net.state_dict(), ssdd_pth)  # bare reference keys
    del seed0
    runs = [
        # (name, size, classes, checkpoint, dataset, cfg, nms_top_k,
        #  plus_one, max_per_image, pixel mean), as the two eval CLIs
        ("voc", SIZE, NUM_CLASSES,
         CheckpointManager(folder, f"RefineDet{SIZE}_SYN").path("final"),
         SyntheticVOC(VOC_EVAL_IMAGES, SIZE, seed=300),
         DetectConfig(num_classes=NUM_CLASSES, top_k=1000, keep_top_k=1000,
                      nms_thresh=0.45), 300, False, 500, VOC_MEANS),
        ("ssdd", SSDD_SIZE, 2, ssdd_pth,
         SyntheticSSDD(SSDD_EVAL_IMAGES, SSDD_SIZE, seed=400),
         DetectConfig(num_classes=2, top_k=1000, keep_top_k=500,
                      nms_thresh=0.49), 1000, True, 500, MEANS),
    ]
    out, launches = {}, 0
    for (name, size, classes, ckpt, data, cfg, nms_top_k, plus_one,
         max_per_image, mean) in runs:
        model = build_refinedet("test", size, classes, dtype=torch.bfloat16,
                                device=dev, seed=1)
        state = make_loader()(ckpt)
        evaluator = Evaluator(model, data, cfg, BaseTransform(size, mean),
                              batch_size=EVAL_BATCH, nms_top_k=nms_top_k,
                              max_per_image=max_per_image, plus_one=plus_one,
                              log=lambda line: log("eval", line.strip()))
        n_batches = -(-len(data) // EVAL_BATCH)
        tag = (f"7{'a' if name == 'voc' else 'b'} {name}: RefineDet{size}, "
               f"{classes} classes, bf16, batch {EVAL_BATCH}, "
               f"{len(data)} images")
        # -- 7a/7b. the main path: K1 once per batch ------------------------
        nms_cuda.nms_sweep.launches = 0
        conv_epilogue.conv_bias_relu.launches = 0
        t0 = time.perf_counter()
        all_boxes = evaluator.run(state)
        e2e_ips = len(data) / (time.perf_counter() - t0)
        timing = dict(evaluator.timing)
        run_launches = nms_cuda.nms_sweep.launches
        count_epilogue(tag.split(":")[0], n_batches)
        launches += run_launches
        log("eval", f"{tag} from {os.path.basename(ckpt)}: K1 launches "
            f"{run_launches} for {n_batches} batches")
        check(run_launches == n_batches,
              f"{name}: K1 launched {run_launches} times in {n_batches} "
              f"batches")
        rows = [r for cls in all_boxes[1:] for r in cls]
        check(len(all_boxes) == classes and all(
            r.shape[1] == 5 and r.shape[0] <= max_per_image
            and np.isfinite(r).all() for r in rows),
            f"{name}: detections of the wrong shape or not finite")
        t0 = time.perf_counter()
        if name == "voc":
            aps = evaluate_voc(all_boxes, data, VOC_CLASSES, verbose=False)
            ap = {"mAP": aps["mAP"]}
            log("eval", f"{tag}: VOC07 mAP {aps['mAP']:.4f} (det_shift 1.0)")
            check(np.isfinite(aps["mAP"]), "voc: mAP is not finite")
        else:
            stats = data.evaluate_detections(all_boxes)
            ap = {"coco_stats": [float(v) for v in stats]}
            log("eval", f"{tag}: COCO stats {np.round(stats, 4).tolist()}")
            check(stats.shape == (12,) and np.isfinite(stats).all(),
                  "ssdd: COCO stats not 12 finite values")
        ap_s = time.perf_counter() - t0

        # -- 7c. a second run, every batch's heads against the plain path --
        recorded = []

        def recording(heads, priors, scales, *args):
            dets = eval_postprocess(heads, priors, scales, *args)
            recorded.append((heads, scales, dets))
            return dets

        evaluator_module.eval_postprocess = recording
        nms_cuda.nms_sweep.launches = 0
        conv_epilogue.conv_bias_relu.launches = 0
        try:
            evaluator.run()
        finally:
            evaluator_module.eval_postprocess = eval_postprocess
        count_epilogue(f"7c {name}", n_batches)
        check(nms_cuda.nms_sweep.launches == len(recorded) == n_batches,
              f"{name}: {nms_cuda.nms_sweep.launches} K1 launches for "
              f"{len(recorded)} recorded of {n_batches} batches")
        mismatched = 0
        with torch.inference_mode():
            for heads, scales, dets in recorded:
                plain = eval_postprocess(heads, model.priors, scales, cfg,
                                         nms_top_k, plus_one, plain=True)
                mismatched += not torch.equal(dets, plain)
        kept = int(sum(int((d[..., 4] > 0).sum()) for _, _, d in recorded))
        log("eval", f"7c {name}: kernel path against plain path on the same "
            f"heads: {n_batches} batches, {mismatched} differ; {kept} "
            f"detections")
        check(mismatched == 0, f"{name}: {mismatched} batches differ from "
              f"the plain post-process")

        # -- 7d. timings -------------------------------------------------------
        heads, scales, _ = recorded[0]
        with torch.inference_mode():
            _, (imgs, _), ready = next(iter(evaluator._staged_batches(
                EVAL_BATCH)))
            wait_for_copy([imgs], ready)
            fwd = cuda_ms(lambda: model.raw_forward(imgs), 10)
            post = cuda_ms(lambda: eval_postprocess(
                heads, model.priors, scales, cfg, nms_top_k, plus_one), 10)
            boxes, scores = detect_refinedet(
                heads[0], heads[1].softmax(-1), heads[2], heads[3].softmax(-1),
                model.priors, cfg.variance, cfg.objectness_thresh)
            _, _, cand, valid = select_candidates(
                (boxes * scales[:, None, :])[:, None],
                scores[..., 1:].movedim(-1, 1), nms_top_k, cfg.conf_thresh)
            cand = cand.reshape(-1, nms_top_k, 4).contiguous()
            valid = valid.reshape(-1, nms_top_k).contiguous()
        k1, k1_plain, bound, bound_by = time_sweep(
            cand, valid, f"eval {name}", cfg.nms_thresh, plus_one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = 0
        for idx, tensors, ready in evaluator._staged_batches(len(data)):
            wait_for_copy(tensors, ready)
            staged += len(idx)
        torch.cuda.synchronize()
        stage_ips = staged / (time.perf_counter() - t0)
        res = {"images": len(data), "batches": n_batches,
               "launches": run_launches, "fps": timing["fps"],
               "p50_batch_ms": timing["p50_batch_ms"],
               "run_images_per_s": e2e_ips,
               "forward_ms": fwd, "postprocess_ms": post,
               "k1_ms": k1, "k1_plain_ms": k1_plain, "k1_bound_ms": bound,
               "k1_bound_by": bound_by, "k1_groups": int(valid.shape[0]),
               "k1_k": int(valid.shape[1]), "ap_host_s": ap_s,
               "staging_images_per_s": stage_ips, **ap}
        out[name] = res
        log("time", f"eval {name}: Evaluator {res['fps']:.1f} images/s "
            f"from its p50 batch {res['p50_batch_ms']:.2f} ms, "
            f"{e2e_ips:.1f} images/s over the whole run incl. the first "
            f"batch (host clock); forward "
            f"{fwd:.2f} ms, eval post-process {post:.2f} ms per batch of "
            f"{EVAL_BATCH} (CUDA events); AP on the host {ap_s:.3f} s; "
            f"staging alone {stage_ips:.1f} images/s")
        del model, evaluator, recorded, heads, scales, imgs
        torch.cuda.empty_cache()
    return out, launches


def step_flops(num_classes: int, size: int, use_bn: bool, batch: int) -> int:
    """Convolution FLOPs of one train step (forward, and 2x for the
    backward), counted from the shapes of a net on the meta device."""
    from refinedet_tpu_torch.models import RefineDet
    from refinedet_tpu_torch.tools.train_check import conv_flops

    with torch.device("meta"):
        net = RefineDet(num_classes, size, use_bn).eval()
        images = torch.empty(batch, size, size, 3)
    return 3 * conv_flops(net, images)


def bn_phase(dev: torch.device, rng) -> tuple:
    """Phase 8: the BN variant and RefineDet896-BN on the card; returns
    its numbers and K1's launches on the 896 serving path (8b)."""
    from refinedet_tpu_torch.config import TrainConfig
    from refinedet_tpu_torch.data.collate import detection_collate
    from refinedet_tpu_torch.models import build_refinedet_bn
    from refinedet_tpu_torch.ops import conv_epilogue, nms_cuda
    from refinedet_tpu_torch.serve import make_serving_fn
    from refinedet_tpu_torch.serve.export import (fused_nms_settings,
                                                  fused_postprocess)
    from refinedet_tpu_torch.tools.k1_bench import (noise_images,
                                                    serving_candidates)
    from refinedet_tpu_torch.tools.train_check import (SyntheticDetection,
                                                       biases_before_bn,
                                                       one_step,
                                                       separated_batch,
                                                       update_rel_errors)
    from refinedet_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step)

    out = {}
    bf16 = torch.bfloat16

    # -- 8a. one f64 step of RefineDet512-BN, card against CPU --------------
    cfg = TrainConfig(max_boxes=TRAIN_MAX_BOXES)
    cpu_model = build_refinedet_bn("train", BN_STEP_SIZE, 2, device="cpu",
                                   seed=0)
    cpu_model.net.double()
    seed, batch = separated_batch(cpu_model, 2, TRAIN_MAX_BOXES, 2,
                                  cfg.theta, cfg.overlap_thresh)
    gpu_model = build_refinedet_bn("train", BN_STEP_SIZE, 2, device=dev,
                                   seed=0)
    gpu_model.net.double()
    want, want_up = one_step(cpu_model, batch, cfg, lr=cfg.lr)
    got, got_up = one_step(gpu_model, batch, cfg, lr=cfg.lr)
    loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in LOSS_KEYS)
    zero_grad = biases_before_bn(cpu_model.net)
    noise = max(float(u[k].abs().max()) for u in (got_up, want_up)
                for k in zero_grad)
    params = {k for k, _ in cpu_model.net.named_parameters()} - zero_grad
    # what a bias with a gradient moves: the BN biases right after them
    bn_bias = 0.0
    for k in zero_grad:
        mods, idx, _ = k.split(".")
        bn_bias = max(bn_bias, float(
            want_up[f"{mods}.{int(idx) + 1}.bias"].abs().max()))
    rel = update_rel_errors(got_up, {k: want_up[k] for k in params})
    worst = max(rel, key=rel.get)
    cpu_state = cpu_model.net.state_dict()
    stats_err, n_stats = 0.0, 0
    for k, v in gpu_model.net.state_dict().items():
        if ".running_" in k:
            w = cpu_state[k]
            stats_err = max(stats_err, float((v.cpu() - w).abs().max()
                                             / w.abs().max()))
            n_stats += 1
            check(torch.allclose(v.cpu(), w, rtol=1e-4,
                                 atol=1e-4 * float(w.abs().max())),
                  f"8a: running statistic {k} differs")
        elif "num_batches" in k:
            check(int(v) == int(cpu_state[k]) == 1, f"8a: {k} is {int(v)}")
    log("bn", f"8a: RefineDet{BN_STEP_SIZE}-BN f64 step, batch seed {seed}, "
        f"{int(batch.valid.sum())} GT boxes; losses card "
        f"{[round(got[k], 5) for k in LOSS_KEYS]} CPU "
        f"{[round(want[k], 5) for k in LOSS_KEYS]}, worst rel err "
        f"{loss_err:.3g} (limit 2e-4)")
    log("bn", f"8a: {len(rel)} parameter updates, worst rel L2 err "
        f"{rel[worst]:.3g} ({worst}; limit 2e-2); "
        f"{len(zero_grad)} BN-fed conv biases (zero gradient) moved at most "
        f"{noise:.3g}, the BN biases after them {bn_bias:.3g}; {n_stats} "
        f"running statistics, worst |card - CPU| "
        f"{stats_err:.3g} of the tensor's max (limit 1e-4)")
    check(loss_err <= 2e-4, f"8a: card and CPU losses differ by {loss_err}")
    check(len(rel) > 80 and rel[worst] <= 2e-2,
          f"8a: {worst}'s update differs by {rel[worst]}")
    check(noise <= 1e-2 * bn_bias,
          f"8a: a BN-fed conv bias moved by {noise} (BN biases {bn_bias})")
    check(n_stats == 2 * 17, f"8a: {n_stats} running statistics")
    out["step_vs_cpu"] = {"loss_rel_err": loss_err,
                          "update_rel_err": rel[worst],
                          "running_stats_err": stats_err, "params": len(rel)}
    del cpu_model, gpu_model

    # -- 8b. RefineDet896-BN: serving (the main path), then training --------
    opts = fused_nms_settings(2, {})
    model = build_refinedet_bn("test", BN_SIZE, 2, dtype=bf16, device=dev,
                               seed=0)
    check(tuple(model.priors.shape) == (BN_PRIORS, 4),
          f"8b: priors {tuple(model.priors.shape)}")
    serve = make_serving_fn(model, None, fused_nms={})
    imgs = noise_images(rng, BN_BATCH, BN_SIZE)
    serve(imgs)  # warm-up: the cuDNN plans of this shape
    nms_cuda.nms_sweep.launches = 0
    conv_epilogue.conv_bias_relu.launches = 0
    served = [serve(imgs) for _ in range(BN_SERVE_CALLS)]
    launches = nms_cuda.nms_sweep.launches
    count_epilogue("8b 896-BN serving", BN_SERVE_CALLS, 0)  # BN: no fusion
    check(launches == BN_SERVE_CALLS,
          f"8b: K1 launched {launches} times in {BN_SERVE_CALLS} batches")
    for dets in served:
        check(dets.shape == (BN_BATCH, 1, NMS_TOP_K, 5)
              and bool(np.isfinite(dets).all()),
              f"8b: dets {dets.shape}, or not finite")
    x = torch.from_numpy(imgs).to(dev)
    with torch.inference_mode():
        heads = model.raw_forward(x)
        dets_k = fused_postprocess(heads, model.priors, opts)
        dets_p = fused_postprocess(heads, model.priors, opts, plain=True)
    check(torch.equal(dets_k, dets_p),
          "8b: kernel-path and plain-path detections differ")
    kept = int((dets_k[..., 4] > 0).sum())
    log("bn", f"8b: RefineDet{BN_SIZE}-BN bf16 serving, batch {BN_BATCH}: "
        f"K1 launches {launches} for {BN_SERVE_CALLS} batches; kernel and "
        f"plain post-process equal on the same heads ({kept} detections)")

    # -- 8c. serving timings --------------------------------------------------
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model.raw_forward(x), 10)
        post = cuda_ms(lambda: fused_postprocess(heads, model.priors, opts),
                       10)
    e2e = host_ms(lambda: serve(imgs), 10)
    cand, valid = serving_candidates(model, imgs, (NMS_TOP_K,),
                                     opts.conf_thresh)[NMS_TOP_K]
    k1, k1_plain, bound, bound_by = time_sweep(cand, valid, "serving bn896",
                                               opts.nms_thresh)
    out["serve"] = {"forward_ms": fwd, "postprocess_ms": post,
                    "serve_ms": e2e, "k1_ms": k1, "k1_plain_ms": k1_plain,
                    "k1_bound_ms": bound, "k1_bound_by": bound_by,
                    "k1_groups": int(valid.shape[0]),
                    "k1_k": int(valid.shape[1]), "launches": launches}
    log("time", f"bn896 bf16 batch {BN_BATCH}: forward {fwd:.2f} ms, fused "
        f"post-process {post:.2f} ms (CUDA events), end-to-end serving "
        f"{e2e:.2f} ms (host clock)")
    del model, serve, heads, x, cand, valid
    torch.cuda.empty_cache()

    # -- 8b. 10 bf16 train steps on one batch --------------------------------
    data = SyntheticDetection(BN_BATCH, BN_SIZE, 2, seed=500)
    fixed = [torch.from_numpy(a).to(dev) for a in detection_collate(
        [data[i] for i in range(BN_BATCH)], TRAIN_MAX_BOXES)]
    model = build_refinedet_bn("train", BN_SIZE, 2, dtype=bf16, device=dev,
                               seed=0)
    opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                         grad_clip_norm=TRAIN_CLIP)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    stats0 = {k: v.clone() for k, v in model.net.state_dict().items()
              if ".running_" in k}
    nms_cuda.nms_sweep.launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, *fixed)
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in model.net.state_dict().items() if k in stats0)
    log("bn", f"8b: loss over {TRAIN_STEPS} bf16 steps on one batch of "
        f"{BN_BATCH} at {BN_SIZE}: {[round(v, 2) for v in losses]}; "
        f"{moved} of {len(stats0)} running statistics moved; K1 launches "
        f"{nms_cuda.nms_sweep.launches}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "8b: a loss is not finite, or the loss did not fall")
    check(moved == len(stats0) == 2 * 17, "8b: running statistics did not "
          "all move")
    check(nms_cuda.nms_sweep.launches == 0, "8b: the training path "
          "launched K1")
    out["learning_losses"] = losses

    # -- 8c. step timings -----------------------------------------------------
    flops = step_flops(2, BN_SIZE, True, BN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, *fixed), TRAIN_STEPS, 2)
    peak_mem = torch.cuda.max_memory_allocated()
    tflops = flops / (step_ms / 1e3) / 1e12
    out["train"] = {"step_ms": step_ms,
                    "images_per_s": BN_BATCH * 1e3 / step_ms,
                    "peak_mem_bytes": peak_mem, "step_tflop": flops / 1e12,
                    "tflops": tflops,
                    "share_of_peak": tflops / (H100_BF16_OPS_PER_S / 1e12)}
    log("time", f"bn896 train bf16 batch {BN_BATCH}: step {step_ms:.2f} ms, "
        f"{BN_BATCH * 1e3 / step_ms:.1f} images/s, peak memory "
        f"{peak_mem / 2**30:.2f} GiB, {flops / 1e12:.4f} TFLOP a step, "
        f"{tflops:.1f} TFLOP/s of {H100_BF16_OPS_PER_S / 1e12:g} peak "
        f"({100 * out['train']['share_of_peak']:.1f}%)")
    del model, opt, step, state, fixed
    torch.cuda.empty_cache()
    return out, launches


def augment_phase(dev: torch.device, smi: str, plain: dict) -> dict:
    """Phase 9: on-device augmentation on the card; returns its numbers.
    ``plain`` is 6d's bf16 step, printed beside the augmented one."""
    from refinedet_tpu_torch.config import MEANS, VOC_MEANS, TrainConfig
    from refinedet_tpu_torch.data import augment as aug
    from refinedet_tpu_torch.data.collate import detection_collate
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.tools.train_check import (
        CROP_MARGIN, StagedSyntheticDetection, crop_near_ties)
    from refinedet_tpu_torch.train import (Trainer, create_train_state,
                                           make_optimizer, make_train_step)

    out = {}
    bf16 = torch.bfloat16
    s0 = float(STAGING)

    def build(seed=0):
        return build_refinedet("train", SIZE, NUM_CLASSES, dtype=bf16,
                               device=dev, seed=seed)

    staged = StagedSyntheticDetection(TRAIN_BATCH, STAGING, NUM_CLASSES,
                                      seed=600)
    batch = detection_collate([staged[i] for i in range(len(staged))],
                              TRAIN_MAX_BOXES)
    fixed = [torch.from_numpy(a).to(dev) for a in batch]

    # -- 9a. augment_batch, card against CPU, on the same draws -------------
    n = AUG_CHECK_BATCH
    draws = aug.sample_draws(torch.Generator().manual_seed(9), n)
    cpu = [torch.from_numpy(a[:n]) for a in batch]
    card = [t.to(dev) for t in cpu]
    cdraws = draws.to(dev)
    got = aug.augment_batch(card[0], card[1], card[3], cdraws, SIZE,
                            VOC_MEANS)
    want = aug.augment_batch(cpu[0], cpu[1], cpu[3], draws, SIZE, VOC_MEANS)
    photo_err = float((aug.photometric_apply(card[0].float(), cdraws).cpu()
                       - aug.photometric_apply(cpu[0].float(), draws))
                      .abs().max())
    trial_g = aug.select_crop(card[1], card[3], cdraws, s0, s0).trial.cpu()
    trial_c = aug.select_crop(cpu[1], cpu[3], draws, s0, s0).trial
    differ = (trial_g != trial_c) | (got[2].cpu() != want[2]).any(1)
    near = crop_near_ties(cpu[1], cpu[3], draws, s0, s0)
    same = ~differ
    img_err = float((got[0].cpu() - want[0])[same].abs().max())
    box_err = float((got[1].cpu() - want[1])[same].abs().max())
    log("aug", f"9a: augment_batch batch {n}, staging {STAGING} -> {SIZE}: "
        f"modes {draws.mode.tolist()}, trials card "
        f"{trial_g.tolist()} CPU {trial_c.tolist()}; {int(differ.sum())} "
        f"images differ in the trial or a kept box, {int(near.sum())} "
        f"near-ties (a crop test within {CROP_MARGIN:g}), "
        f"{int((differ & ~near).sum())} differ without one")
    log("aug", f"9a: card vs CPU max abs err: images {img_err:.3g} (limit "
        f"1e-3), of which the photometric step {photo_err:.3g}; boxes "
        f"{box_err:.3g} (limit 1e-5)")
    check(not bool((differ & ~near).any()),
          "9a: the card and the CPU take another crop away from a tie")
    check(img_err <= 1e-3 and box_err <= 1e-5,
          f"9a: card and CPU differ: images {img_err}, boxes {box_err}")
    out["card_vs_cpu"] = {"images_abs_err": img_err,
                          "photometric_abs_err": photo_err,
                          "boxes_abs_err": box_err,
                          "differ": int(differ.sum()),
                          "near_ties": int(near.sum())}

    # -- 9b. the augmenting Trainer, resume, no host wait -----------------
    cfg = TrainConfig(batch_size=TRAIN_BATCH, max_boxes=TRAIN_MAX_BOXES,
                      max_epoch=TRAIN_STEPS, num_workers=4,
                      grad_clip_norm=TRAIN_CLIP, on_device_augment=True,
                      mean=VOC_MEANS)
    lines = []
    with tempfile.TemporaryDirectory() as folder:
        live = Trainer(build(), staged, cfg, save_folder=folder,
                       dataset_name="STAGED", log_fn=lines.append)
        state = live.train()
        fresh = Trainer(build(seed=1), staged, cfg, save_folder=folder,
                        dataset_name="STAGED", log_fn=lambda line: None)
        rstate = fresh.resume(TRAIN_STEPS)
    for line in lines:
        log("aug", f"9b: {line}")
    losses = [float(v) for line in lines
              for v in LOG_LOSSES.search(line).groups()]
    check(len(lines) == TRAIN_STEPS and state.step == TRAIN_STEPS,
          f"9b: {len(lines)} log lines, step {state.step}")
    check(all(np.isfinite(losses)), "9b: a logged loss is not finite")
    check(rstate.step == state.step, f"9b: resumed step {rstate.step}")

    def next_batch(step):
        return aug.augment_batch(
            fixed[0], fixed[1], fixed[3], aug.sample_draws(
                aug.step_generator(cfg.seed, step, dev), TRAIN_BATCH),
            SIZE, cfg.mean)

    check(all(torch.equal(a, b) for a, b in zip(next_batch(state.step),
                                                next_batch(rstate.step))),
          "9b: the resumed run augments its next batch otherwise")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, _ = live.train_step(state, *fixed)
        rstate, _ = fresh.train_step(rstate, *fixed)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        live.model.net.state_dict().values(),
        fresh.model.net.state_dict().values()))
    check(diff == 0.0, f"9b: the step from the resumed state differs by "
          f"{diff}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = live.train_step(state, *fixed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(np.isfinite(float(metrics["loss"])), "9b: loss not finite")
    log("aug", f"9b: {TRAIN_STEPS} augmented bf16 steps logged, all finite; "
        f"resumed epoch {TRAIN_STEPS} at step {TRAIN_STEPS}: the next "
        f"augmented batch equal, one step from each (cuDNN deterministic) "
        f"max |live - resumed| {diff:g}; 2 steps under "
        f"set_sync_debug_mode('error'), no host wait")
    out["learning_losses"] = losses
    del live, fresh, state, rstate

    # -- 9c. timings ------------------------------------------------------------
    log("aug", f"9c: {smi}")
    draws = aug.sample_draws(aug.step_generator(0, 0, dev), TRAIN_BATCH)
    img = fixed[0].float()
    crop = aug.select_crop(fixed[1], fixed[3], draws, s0, s0)
    scale, trans = aug.crop_scale_translation(crop, SIZE)
    whole = cuda_ms(lambda: aug.augment_batch(
        fixed[0], fixed[1], fixed[3], draws, SIZE, VOC_MEANS), 10)
    split = {
        "draws": cuda_ms(lambda: aug.sample_draws(
            aug.step_generator(0, 0, dev), TRAIN_BATCH), 10),
        "photometric": cuda_ms(lambda: aug.photometric_apply(img, draws),
                               10),
        "crop": cuda_ms(lambda: aug.select_crop(fixed[1], fixed[3], draws,
                                                s0, s0), 10),
        "resample": cuda_ms(lambda: aug.resample(img, scale, trans, SIZE),
                            10)}
    issue = {"augment": host_issue_ms(lambda: aug.augment_batch(
        fixed[0], fixed[1], fixed[3], draws, SIZE, VOC_MEANS), 10)}
    staged_bytes = sum(a.nbytes for a in batch)
    plain_bytes = (TRAIN_BATCH * SIZE * SIZE * 3 * 4
                   + sum(a.nbytes for a in batch[1:]))
    log("time", f"augment_batch batch {TRAIN_BATCH}, staging {STAGING} -> "
        f"{SIZE}: {whole:.3f} ms (CUDA events); draws {split['draws']:.3f}, "
        f"photometric {split['photometric']:.3f}, crop selection "
        f"{split['crop']:.3f}, resample {split['resample']:.3f} ms timed "
        f"apart; {smi}")
    log("time", f"augment_batch: host time to issue it {issue['augment']:.3f}"
        f" ms a call (no sync)")
    log("time", f"bytes copied to the card per batch: {staged_bytes} staged "
        f"uint8 at {STAGING} against {plain_bytes} for float32 at {SIZE}")

    model = build()
    opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                         grad_clip_norm=TRAIN_CLIP)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    for _ in range(3):
        state, _ = step(state, *fixed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, *fixed), TRAIN_STEPS, 0)
    peak_mem = torch.cuda.max_memory_allocated()
    issue["step"] = host_issue_ms(lambda: step(state, *fixed), TRAIN_STEPS)
    e2e_data = Cycled(StagedSyntheticDetection(
        3 * TRAIN_BATCH, STAGING, NUM_CLASSES, seed=700),
        E2E_STEPS * TRAIN_BATCH)
    trainer = Trainer(model, e2e_data, dataclasses.replace(
        cfg, max_epoch=2, num_workers=8), log_fn=lambda line: None)
    tstate = trainer.train(max_epochs=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(tstate, start_epoch=1, max_epochs=1)
    torch.cuda.synchronize()
    e2e_ips = len(e2e_data) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    fed = sum(sb.wait().images.shape[0] for sb in trainer.loader)
    torch.cuda.synchronize()
    feed_ips = fed / (time.perf_counter() - t0)
    log("time", f"augmented train bf16 batch {TRAIN_BATCH}: step "
        f"{step_ms:.2f} ms ({TRAIN_BATCH * 1e3 / step_ms:.1f} images/s, "
        f"peak memory {peak_mem / 2**30:.2f} GiB) against 6d's plain "
        f"{plain['step_ms']:.2f} ms ({plain['images_per_s']:.1f} images/s);"
        f" host time to issue it {issue['step']:.2f} ms (no sync)")
    log("time", f"augmented Trainer end to end {e2e_ips:.1f} images/s (host "
        f"clock, an epoch of {E2E_STEPS} steps after a warm-up epoch); its "
        f"feed alone {feed_ips:.1f} images/s; 6d's plain Trainer "
        f"{plain['trainer_images_per_s']:.1f}, feed "
        f"{plain['feed_images_per_s']:.1f}")
    del model, opt, step, state, trainer, tstate, img
    torch.cuda.empty_cache()

    big = StagedSyntheticDetection(BN_BATCH, BN_STAGING, 2, seed=800)
    big = [torch.from_numpy(a).to(dev) for a in detection_collate(
        [big[i] for i in range(BN_BATCH)], TRAIN_MAX_BOXES)]
    big_draws = aug.sample_draws(aug.step_generator(0, 0, dev), BN_BATCH)
    big_ms = cuda_ms(lambda: aug.augment_batch(big[0], big[1], big[3],
                                               big_draws, BN_SIZE, MEANS), 5)
    log("time", f"augment_batch batch {BN_BATCH}, staging {BN_STAGING} -> "
        f"{BN_SIZE}: {big_ms:.3f} ms (CUDA events)")
    out["time"] = {"augment_ms": whole, **{f"{k}_ms": v
                                           for k, v in split.items()},
                   "step_ms": step_ms,
                   "images_per_s": TRAIN_BATCH * 1e3 / step_ms,
                   "plain_step_ms": plain["step_ms"],
                   "peak_mem_bytes": peak_mem,
                   "staged_bytes": staged_bytes, "plain_bytes": plain_bytes,
                   "trainer_images_per_s": e2e_ips,
                   "feed_images_per_s": feed_ips,
                   "augment_1792_ms": big_ms,
                   **{f"{k}_host_issue_ms": v for k, v in issue.items()},
                   "card": smi}
    del big, fixed
    torch.cuda.empty_cache()
    return out


def serve_requests(engine, server, requests, label: str) -> tuple:
    """Drive ``server``: the last HTTP_REQUESTS of ``requests`` over HTTP,
    the others from 4 client threads through ``engine``, the kernels'
    counts set to 0 just before and K1's read just after (the int8
    kernels' stay in ``int8_conv.launches`` and ``int8_quantize.
    launches``, the conv epilogue's in ``conv_bias_relu.launches``).
    Checks every answer (no
    error, fused dets of the expected shape, finite) and returns (answers
    by request, the engine's stats, K1's launches)."""
    from refinedet_tpu_torch.ops import conv_epilogue, int8_conv, nms_cuda
    from refinedet_tpu_torch.serve import client_detect

    n_engine = len(requests) - HTTP_REQUESTS
    results, errors = {}, []

    def client(tid):
        try:
            futs = [(i, engine.submit(requests[i]))
                    for i in range(tid, n_engine, 4)]
            for i, f in futs:
                results[i] = f.result(timeout=300)[0]
        except Exception as e:  # noqa: BLE001 - reported and checked below
            errors.append(repr(e))

    wire = "u1" if requests.dtype == np.uint8 else "<f4"
    nms_cuda.nms_sweep.launches = 0
    int8_conv.int8_conv.launches = 0
    int8_conv.int8_quantize.launches = 0
    conv_epilogue.conv_bias_relu.launches = 0
    server.start()
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for i in range(n_engine, len(requests)):
            (results[i],) = client_detect("127.0.0.1", server.port,
                                          requests[i], timeout=300,
                                          dtype=wire)
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), f"{label}: a client thread did not "
                  "finish")
        stats = engine.stats()
    finally:
        server.stop()
    launches = nms_cuda.nms_sweep.launches
    log(label, f"stats {json.dumps(stats)}")
    check(not errors, f"{label}: client errors: {errors}")
    check(stats["errors"] == 0, f"{label}: engine errors: {stats['errors']}")
    n_req = len(requests)
    check(len(results) == n_req and stats["requests"] == n_req,
          f"{label}: {len(results)} results, {stats['requests']} served of "
          f"{n_req}")
    for i, dets in results.items():
        check(dets.shape == (NUM_CLASSES - 1, NMS_TOP_K, 5),
              f"{label}: request {i}: dets shape {dets.shape}")
        check(bool(np.isfinite(dets).all()),
              f"{label}: request {i}: non-finite")
    return results, stats, launches


def matched_rows(a: np.ndarray, b: np.ndarray, rtol: float) -> tuple:
    """Rows of fused detections ``[B, C-1, K, 5]`` kept in ``a`` (score
    above 0) that have a kept row of ``b`` in the same image and class
    within ``rtol`` of the larger magnitude (at least 1) on all five
    values, and the same for ``b`` against ``a``: ((matched in a, matched
    in b), (rows of a, rows of b)). Random weights decode boxes far
    outside 0-1, so the tolerance is relative."""
    matched, rows = [0, 0], [0, 0]
    for ra, rb in zip(a.reshape(-1, *a.shape[2:]),
                      b.reshape(-1, *b.shape[2:])):
        ra, rb = ra[ra[:, 4] > 0], rb[rb[:, 4] > 0]
        x, y = ra[:, None], rb[None]
        scale = np.maximum(1.0, np.maximum(np.abs(x), np.abs(y)))
        close = (np.abs(x - y) <= rtol * scale).all(-1)
        for i, (rows_i, hit) in enumerate(((ra, close.any(1)),
                                           (rb, close.any(0)))):
            rows[i] += len(rows_i)
            matched[i] += int(hit.sum())
    return tuple(matched), tuple(rows)


def separate_heads(model, rng) -> None:
    """10e's and 16d's weights, in place: the ODM confidence head at zero
    weights and biases uniform in [-4, 4) from ``rng`` (a score then
    depends on its anchor only, so two forwards order the candidates
    alike), the loc heads' weights scaled by 1/100 (random ones decode
    boxes up to 1e24, where the decode's exp turns a forward's drift into
    1e-3 relative differences)."""
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if name.startswith("odm_conf."):
                p.copy_(torch.from_numpy(rng.uniform(-4, 4, p.shape).astype(
                    np.float32)) if name.endswith("bias") else
                    torch.zeros_like(p))
            elif name.startswith(("arm_loc.", "odm_loc.")) and \
                    name.endswith("weight"):
                p.mul_(0.01)


def artifact_phase(dev: torch.device, smi: str, rng) -> tuple:
    """Phase 10: the serving artifact on the card; returns its numbers and
    K1's launches on its main path (10b: the engine and the HTTP server
    answering through the artifact, each bucket replaying its graph)."""
    from refinedet_tpu_torch.config import MEANS
    from refinedet_tpu_torch.models import build_refinedet, \
        build_refinedet_bn
    from refinedet_tpu_torch.ops import nms_cuda
    from refinedet_tpu_torch.serve import (BatchingEngine, Server,
                                           load_serving, make_serving_fn)
    from refinedet_tpu_torch.serve.export import (export_inference,
                                                  inference_module, model_on,
                                                  save_serving,
                                                  serving_metadata,
                                                  write_serving)
    from refinedet_tpu_torch.tools.k1_bench import noise_images

    out = {"card": smi}
    bf16 = torch.bfloat16
    folder = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")

    def artifact(model, name, **wire):
        """Export on the card, write, load in this process."""
        path = os.path.join(folder, f"{name}.rdtpu")
        t0 = time.perf_counter()
        program = export_inference(model, fused_nms={}, **wire)
        t1 = time.perf_counter()
        write_serving(path, {"cuda": program},
                      serving_metadata(model, None, {}, **wire))
        t2 = time.perf_counter()
        serving = load_serving(path)
        t3 = time.perf_counter()
        mb = os.path.getsize(path) / 1e6
        weights_mb = sum(t.numel() * t.element_size() for t in
                         model.net.state_dict().values()) / 1e6
        nhwc = [p.is_contiguous(memory_format=torch.channels_last)
                for p in serving.module.parameters() if p.dim() == 4]
        info = {"export_s": t1 - t0, "save_s": t2 - t1, "load_s": t3 - t2,
                "file_mb": mb, "weights_mb": weights_mb}
        log("artifact", f"{name}: export {t1 - t0:.2f} s, save "
            f"{t2 - t1:.2f} s, load {t3 - t2:.2f} s; {mb:.1f} MB for "
            f"{weights_mb:.1f} MB of weights; {sum(nhwc)} of {len(nhwc)} "
            f"conv weights NHWC after the load; meta "
            f"{json.dumps(serving.meta, sort_keys=True)}")
        check(serving.meta["device"] == str(model.priors.device) != "cpu",
              f"{name}: exported for {serving.meta['device']}")
        check(mb < 1.05 * weights_mb + 5, f"{name}: {mb:.1f} MB written "
              f"for {weights_mb:.1f} MB of weights (stored twice?)")
        check(all(nhwc), f"{name}: the loaded conv weights lost NHWC")
        return serving, info

    # -- 10a. RefineDet320 bf16 and f32 artifacts against the live function -
    for dtype in (bf16, torch.float32):
        name = "bf16" if dtype == bf16 else "f32"
        model = build_refinedet("test", SIZE, NUM_CLASSES, dtype=dtype,
                                device=dev, seed=0)
        serving, info = artifact(model, f"refinedet320_{name}")
        live = make_serving_fn(model, None, fused_nms={})
        kept = []
        for b in ARTIFACT_BATCHES:
            imgs = noise_images(rng, b)
            got, want = serving(imgs), live(imgs)
            check(got.shape == (b, NUM_CLASSES - 1, NMS_TOP_K, 5),
                  f"10a: {name} dets {got.shape}")
            check(np.array_equal(got, want), f"10a: the {name} artifact "
                  f"differs from the live function at batch {b} (max abs "
                  f"err {np.abs(got - want).max()})")
            kept.append(int((got[..., 4] > 0).sum()))
        log("artifact", f"10a: RefineDet320 {name} artifact (symbolic "
            f"batch) equals make_serving_fn exactly at batches "
            f"{list(ARTIFACT_BATCHES)} ({kept} detections)")
        out[f"320_{name}"] = info
        if dtype == bf16:
            m320, s320, live320 = model, serving, live
        else:
            del model, serving, live
    torch.cuda.empty_cache()

    # -- 10b. the bf16 artifact behind the engine and the server ------------
    engine = BatchingEngine(s320, (SIZE, SIZE, 3), max_batch=MAX_BATCH,
                            max_delay_ms=20.0,
                            input_dtype=s320.input_dtype)
    t0 = time.perf_counter()
    s320.warm_up(engine.buckets)
    out["320_bf16"]["capture_s"] = time.perf_counter() - t0
    check(sorted(s320.graphs) == list(engine.buckets),
          f"10b: graphs for {sorted(s320.graphs)}")
    for b in engine.buckets:
        imgs = noise_images(rng, b)
        before = nms_cuda.nms_sweep.launches
        got = s320(imgs)
        check(nms_cuda.nms_sweep.launches == before + 1
              and s320.graphs[b].launches == 1
              and s320.graphs[b].epilogue_launches == EPILOGUE_CONVS,
              f"10b: bucket {b}'s replay counted "
              f"{nms_cuda.nms_sweep.launches - before} K1 launches, its "
              f"graph holds {s320.graphs[b].epilogue_launches} conv "
              "epilogues")
        with torch.inference_mode():
            want = s320.module(torch.from_numpy(imgs).to(dev)).cpu().numpy()
        check(np.array_equal(got, want),
              f"10b: bucket {b}'s graph replay differs from eager")
    log("artifact", f"10b: one CUDA graph per bucket {list(engine.buckets)}"
        f", captured in {out['320_bf16']['capture_s']:.2f} s; each replay "
        "equals the eager artifact exactly and counts one K1 launch")
    server = Server(engine, s320.meta)
    requests = noise_images(rng, ENGINE_REQUESTS + HTTP_REQUESTS)
    results, stats, launches = serve_requests(engine, server, requests,
                                              "artifact")
    check(launches == stats["batches"] > 0,
          f"10b: K1 launched {launches} times for {stats['batches']} "
          "device batches through the graphs")
    count_epilogue("10b artifact", stats["batches"])
    kept = int(sum((d[..., 4] > 0).sum() for d in results.values()))
    log("artifact", f"10b: {len(requests)} requests ({HTTP_REQUESTS} over "
        f"HTTP) through the artifact in {stats['batches']} device batches, "
        f"0 errors, {kept} detections; K1 launches {launches}")
    out["served"] = {"requests": len(requests),
                     "batches": stats["batches"], "launches": launches}

    # -- 10c. RefineDet896-BN, uint8 wire, the SSDD mean ---------------------
    mbn = build_refinedet_bn("test", BN_SIZE, 2, dtype=bf16, device=dev,
                             seed=0)
    wire = {"uint8_input": True, "input_mean": MEANS}
    sbn, out["896_bn_uint8"] = artifact(mbn, "refinedet896_bn_uint8",
                                        **wire)
    check(sbn.meta["input_mean_bgr"] == list(MEANS)
          and sbn.meta["use_bn"], f"10c: meta {sbn.meta}")
    livebn = make_serving_fn(mbn, None, fused_nms={}, **wire)
    raw = rng.randint(0, 256, (BN_BATCH, BN_SIZE, BN_SIZE, 3)).astype(
        np.uint8)
    got, want = sbn(raw), livebn(raw)
    check(np.array_equal(got, want), "10c: the 896-BN uint8 artifact "
          f"differs from the live function (max abs err "
          f"{np.abs(got - want).max()})")
    log("artifact", f"10c: RefineDet896-BN bf16 uint8-wire artifact (mean "
        f"{MEANS[0]}) equals make_serving_fn exactly at batch {BN_BATCH} "
        f"({int((got[..., 4] > 0).sum())} detections)")

    # -- 10d. timings: live function, eager artifact, graph replay ----------
    cycles = spin_cycles(ARTIFACT_SPIN_MS)
    log("artifact", smi)
    for key, model, serving, live, imgs, w in (
            ("320_bf16", m320, s320, live320, noise_images(rng, SERVE_BATCH),
             {}),
            ("896_bn_uint8", mbn, sbn, livebn, raw, wire)):
        b = imgs.shape[0]
        module = inference_module(model, None, {}, **w)
        x = torch.from_numpy(imgs).to(dev)
        with torch.inference_mode():
            t = {"live": (host_ms(lambda: live(imgs), ARTIFACT_REPS),
                          device_ms(lambda: module(x), ARTIFACT_REPS,
                                    cycles)),
                 "eager": (host_ms(lambda: serving(imgs), ARTIFACT_REPS),
                           device_ms(lambda: serving.module(x),
                                     ARTIFACT_REPS, cycles))}
            check(b not in serving.graphs, f"10d: batch {b} captured early")
            t0 = time.perf_counter()
            serving.warm_up((b,))
            out[key]["capture_s"] = out[key].get("capture_s", 0.0) + \
                time.perf_counter() - t0
            graph = serving.graphs[b]
            check(np.array_equal(serving(imgs), live(imgs)),
                  f"10d: {key}'s batch-{b} graph replay differs from live")
            before = nms_cuda.nms_sweep.launches
            e2e = host_ms(lambda: serving(imgs), ARTIFACT_REPS)
            check(nms_cuda.nms_sweep.launches - before
                  == ARTIFACT_REPS + 2, f"10d: {key}: replays counted "
                  f"{nms_cuda.nms_sweep.launches - before} K1 launches")
            graph.static_in.copy_(x)
            t["graph"] = (e2e, device_ms(graph.graph.replay, ARTIFACT_REPS,
                                         cycles))
        for path, (e2e, dev_t) in t.items():
            share = 1.0 - dev_t / e2e
            out[key][f"{path}_e2e_ms"] = e2e
            out[key][f"{path}_device_ms"] = dev_t
            out[key][f"{path}_outside_share"] = share
            log("time", f"10d {key} batch {b}, {path}: end to end "
                f"{e2e:.2f} ms (host clock), device {dev_t:.2f} ms (CUDA "
                f"events, card preloaded), {100 * share:.1f}% outside the "
                "device")
        log("time", f"10d {key}: export {out[key]['export_s']:.2f} s, save "
            f"{out[key]['save_s']:.2f} s, load {out[key]['load_s']:.2f} s, "
            f"capture {out[key]['capture_s']:.2f} s, file "
            f"{out[key]['file_mb']:.1f} MB")
    del m320, s320, live320, mbn, sbn, livebn, engine, server
    torch.cuda.empty_cache()

    # -- 10e. one file, a program for the card and one for the CPU ---------
    # f32 (TF32 off), with ``separate_heads`` (its ODM confidence head as
    # the CPU export test's): only the boxes' drift can move an IoU test
    # across the threshold.
    m2 = build_refinedet("test", SIZE, NUM_CLASSES, device=dev, seed=0)
    separate_heads(m2, rng)
    path = os.path.join(folder, "refinedet320_cuda_cpu.rdtpu")
    t0 = time.perf_counter()
    meta = save_serving(m2, None, path, fused_nms={},
                        platforms=("cuda", "cpu"))
    t1 = time.perf_counter()
    card = load_serving(path)
    host = load_serving(path, device="cpu")
    t2 = time.perf_counter()
    mb = os.path.getsize(path) / 1e6
    weights_mb = sum(t.numel() * t.element_size()
                     for t in m2.net.state_dict().values()) / 1e6
    check(meta["platforms"] == ["cuda", "cpu"] and card.meta["device"]
          == str(m2.priors.device) and host.meta["device"] == "cpu",
          f"10e: platforms {meta['platforms']}, devices "
          f"{card.meta['device']} / {host.meta['device']}")
    check(1.9 * weights_mb < mb < 2 * 1.05 * weights_mb + 5,
          f"10e: {mb:.1f} MB for two programs of {weights_mb:.1f} MB of "
          "weights")
    imgs = noise_images(rng, 2)
    got_card, got_host = card(imgs), host(imgs)
    want_card = make_serving_fn(m2, None, fused_nms={})(imgs)
    want_host = make_serving_fn(model_on(m2, "cpu"), None,
                                fused_nms={})(imgs)
    check(np.array_equal(got_card, want_card),
          "10e: the cuda program differs from the live function")
    check(np.array_equal(got_host, want_host),
          "10e: the cpu program differs from the live function on the CPU")
    matched, rows = matched_rows(got_card, got_host, DETS_CARD_CPU_RTOL)
    same = (got_card[..., 4] > 0) == (got_host[..., 4] > 0)
    rel = np.abs(got_card - got_host) / np.maximum(
        1.0, np.maximum(np.abs(got_card), np.abs(got_host)))
    log("artifact", f"10e: card against CPU, row for row: kept masks equal "
        f"in {int(same.sum())} of {same.size} slots; largest relative "
        f"difference {float(rel.max()):.3g}, largest absolute "
        f"{float(np.abs(got_card - got_host).max()):.3g}, largest |value| "
        f"{float(np.abs(got_card).max()):.3g}")
    check(min(matched) >= 0.99 * max(rows) and min(rows) > 0,
          f"10e: card and CPU programs: {matched} of {rows} rows matched "
          f"within rtol {DETS_CARD_CPU_RTOL}")
    out["320_f32_cuda_cpu"] = {
        "export_s": t1 - t0, "load_s": t2 - t1, "file_mb": mb,
        "weights_mb": weights_mb, "program_bytes": meta["program_bytes"],
        "rows": rows, "matched": matched}
    log("artifact", f"10e: RefineDet320 f32, one file with a cuda and a cpu "
        f"program: {mb:.1f} MB for {weights_mb:.1f} MB of weights (once "
        f"per program; {meta['program_bytes']} bytes), export "
        f"{t1 - t0:.2f} s, both loads {t2 - t1:.2f} s; the cuda program "
        "equals the live function on the card exactly, the cpu program "
        "the live function on the CPU exactly; card against CPU: "
        f"{matched[0]} of {rows[0]} card rows and {matched[1]} of {rows[1]} "
        f"CPU rows with a counterpart within rtol {DETS_CARD_CPU_RTOL}")
    del m2, card, host
    shutil.rmtree(folder)
    torch.cuda.empty_cache()
    return out, launches


def int8_phase(dev: torch.device, smi: str, rng) -> tuple:
    """Phase 11: int8 PTQ on the card; returns its numbers, the int8 conv
    and K1 launches of its main paths (11c's serving run; K1 also 11e's
    eval run), and the int8 kernels' lines of the kernels table."""
    import torch.nn.functional as F

    from refinedet_tpu_torch.config import MEANS, VOC_MEANS, DetectConfig
    from refinedet_tpu_torch.data import BaseTransform
    from refinedet_tpu_torch.eval import Evaluator
    from refinedet_tpu_torch.eval import evaluator as evaluator_module
    from refinedet_tpu_torch.eval.evaluator import eval_postprocess
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.models.layers import QuantConv2d
    from refinedet_tpu_torch.ops import conv_epilogue, int8_conv, nms_cuda
    from refinedet_tpu_torch.quant import (DEFAULT_QUANT_SKIP,
                                           accumulate_hessians,
                                           calib_batches_from_dataset,
                                           calibrate_amax, gptq_round,
                                           quantize_model,
                                           quantize_variables)
    from refinedet_tpu_torch.quant.ptq import _hwio, flax_to_path
    from refinedet_tpu_torch.serve import (BatchingEngine, Server,
                                           load_serving, make_serving_fn)
    from refinedet_tpu_torch.serve.export import (export_inference,
                                                  serving_metadata,
                                                  write_serving)
    from refinedet_tpu_torch.tools import int8_bench
    from refinedet_tpu_torch.tools.eval_check import (SyntheticSSDD,
                                                      SyntheticVOC)
    from refinedet_tpu_torch.tools.k1_bench import graph_ms, noise_images

    out = {"card": smi}
    bf16 = torch.bfloat16
    op = int8_conv.int8_conv
    plain = int8_conv.int8_conv_reference
    quant = int8_conv.int8_quantize
    plain_quant = int8_conv.int8_quantize_reference
    # Random weights leave some channels dead on a few calibration images;
    # quantize_variables warns for each such conv (JAX's floor applies).
    warnings.filterwarnings("ignore", "PTQ: .*calibration-dead")

    # -- 11a. the kernels against their plain versions -----------------------
    t0 = time.perf_counter()
    every = int8_bench.distinct(int8_bench.conv_shapes(SIZE, NUM_CLASSES))
    every512 = int8_bench.distinct(int8_bench.conv_shapes(SSDD_SIZE, 2))
    worst, compared, split_cases = 0.0, 0, 0
    apart, f32_outputs = 0, 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sets = [(SIZE, b, every) for b in INT8_CHECK_BATCHES]
    sets.append((SSDD_SIZE, INT8_CHECK_512_BATCH, every512))
    for size, b, cases in sets:
        for i, case in enumerate(cases):
            xq, w, ws, bias = int8_bench.random_case(case, b, dev,
                                                     size + 100 * b + i)
            k, s, p, d = case["geom"]
            split_cases += int8_conv.plan(
                b, *case["hwc"], case["o"], k, s, p, d, sms).splits > 1
            for dtype in (torch.int32, torch.float32, bf16):
                got = op(xq, w, ws, bias, s, p, d, dtype)
                want = plain(xq, w, ws, bias, s, p, d, dtype)
                err = float((got.double() - want.double()).abs().max())
                worst = max(worst, err)
                compared += 1
                check(torch.equal(got, want), f"11a: int8 conv {size} "
                      f"{case['names']} batch {b} {dtype}: max abs err "
                      f"{err} against the plain version")
                if dtype == torch.int32:
                    sums = got
                elif dtype == torch.float32:
                    # the product and the sum rounded apart: where that
                    # differs, only one rounding (the FMA) matches
                    twice = sums.float() * ws + bias
                    apart += int((twice != want).sum())
                    f32_outputs += want.numel()
    del xq, w, ws, bias, got, want, sums, twice
    check(apart > 0, "11a: no float32 output tells one rounding from two")
    log("int8", f"11a: {len(every)} distinct convs of the 320 set "
        f"(quant_skip=()) at batches {list(INT8_CHECK_BATCHES)} and "
        f"{len(every512)} of the 512 set at batch {INT8_CHECK_512_BATCH}: "
        f"int32 sums, float32 and bf16 outputs bitwise equal to the plain "
        f"version ({compared} comparisons, {split_cases} of "
        f"{compared // 3} shapes with K split; {apart} of {f32_outputs} "
        f"float32 outputs ({100 * apart / f32_outputs:.2f}%) differ from "
        f"the product and sum rounded apart; "
        f"{time.perf_counter() - t0:.1f} s)")
    out["int8_conv_f32_apart"] = [apart, f32_outputs]
    t0 = time.perf_counter()
    served_convs = int8_bench.conv_shapes(SIZE, NUM_CLASSES,
                                          DEFAULT_QUANT_SKIP)
    inputs = list(dict.fromkeys(c["hwc"] for c in served_convs))
    worst_q, compared_q = 0.0, 0
    for b in INT8_CHECK_BATCHES:
        for i, hwc in enumerate(inputs):
            for dtype in (bf16, torch.float32):
                x, scale = int8_bench.quantize_case(hwc, b, dtype, dev,
                                                    10 * b + i)
                got, want = quant(x, scale), plain_quant(x, scale)
                err = float((got.int() - want.int()).abs().max())
                worst_q = max(worst_q, err)
                compared_q += 1
                check(torch.equal(got, want), f"11a: quantize {hwc} batch "
                      f"{b} {dtype}: max abs err {err} against the plain "
                      "version")
    del x, scale, got, want
    log("int8", f"11a: the quantize at the {len(inputs)} served input "
        f"shapes at batches {list(INT8_CHECK_BATCHES)}, bf16 and f32, edge "
        f"values included: bitwise equal to the plain version "
        f"({compared_q} comparisons, {time.perf_counter() - t0:.1f} s)")

    # -- 11b. PTQ on the card --------------------------------------------------
    data = SyntheticVOC(INT8_CALIB_IMAGES, SIZE, seed=500)
    calib = list(calib_batches_from_dataset(
        data, BaseTransform(SIZE, VOC_MEANS), INT8_CALIB_IMAGES, 4))
    f32_card = build_refinedet("test", SIZE, NUM_CLASSES, device=dev, seed=0)
    f32_cpu = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu",
                              seed=0)
    stats_card = calibrate_amax(f32_card, calib[:1])
    stats_cpu = calibrate_amax(f32_cpu, calib[:1])
    worst_rel, same = 0.0, []
    for name, want in stats_cpu.items():
        got = stats_card[name]
        # cuDNN and oneDNN sum in different orders (phase 4's limit)
        rel = float(np.abs(got - want).max() / want.max())
        worst_rel = max(worst_rel, rel)
        check(rel <= 1e-4, f"11b: {name}: card stats {rel:.3g} of the "
              "largest off the CPU's")
        if np.array_equal(got, want):
            same.append(name)
    twin = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu",
                           quant=True, quant_skip=DEFAULT_QUANT_SKIP)
    state = f32_cpu.net.state_dict()
    q_card = quantize_variables(twin, state, stats_card)
    q_cpu = quantize_variables(twin, state, stats_cpu)
    paths = flax_to_path(twin.net)
    equal_q = [n for n in same if n in twin.net.calibrated and torch.equal(
        q_card[paths[n] + ".kernel_q"], q_cpu[paths[n] + ".kernel_q"])]
    check(len(equal_q) == len([n for n in same
                               if n in twin.net.calibrated]),
          "11b: kernel_q differs where the stats are equal")
    near = sum(float((q_card[paths[n] + ".kernel_q"].int()
                      - q_cpu[paths[n] + ".kernel_q"].int()).abs().max()) <= 1
               for n in twin.net.calibrated)
    log("int8", f"11b: f32 calibration on the card against the CPU (4 "
        f"images): stats within {worst_rel:.3g} of each conv's largest "
        f"(limit 1e-4); "
        f"{len(same)} of {len(stats_cpu)} convs' stats bitwise equal, "
        f"their kernel_q equal; {near} of {len(twin.net.calibrated)} "
        "kernel_q within one step")
    t0 = time.perf_counter()
    hessians = accumulate_hessians(f32_card, calib, names=INT8_GPTQ_NAMES)
    hess_s = time.perf_counter() - t0
    name = INT8_GPTQ_NAMES[0]
    w = _hwio(state[paths[name] + ".weight"])
    in_scale = (q_card[paths[name] + ".in_scale"]).numpy()
    w_scale = (q_card[paths[name] + ".w_scale"]).numpy()
    t0 = time.perf_counter()
    g_card = gptq_round(w, in_scale, w_scale, hessians[name], device=dev)
    gptq_card_s = time.perf_counter() - t0
    g_cpu = gptq_round(w, in_scale, w_scale, hessians[name], device="cpu")
    g_equal = float((g_card == g_cpu).mean())
    check(g_equal == 1.0, f"11b: GPTQ on the card equals the CPU's on "
          f"{100 * g_equal:.3f}% of {name}'s weights")
    del f32_cpu, twin, q_card, q_cpu
    t0 = time.perf_counter()
    _, state_gptq = quantize_model(f32_card, calib, dtype=bf16,
                                   bias_correct=True, weight_opt="gptq",
                                   weight_opt_names=INT8_GPTQ_NAMES)
    gptq_model_s = time.perf_counter() - t0
    check(sum(k.endswith(".kernel_q") for k in state_gptq) == INT8_CONVS,
          "11b: the GPTQ twin's quantized convs")
    del f32_card, state_gptq
    model = build_refinedet("test", SIZE, NUM_CLASSES, dtype=bf16,
                            device=dev, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_q, _ = quantize_model(model, calib, dtype=bf16)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    n_q = sum(isinstance(m, QuantConv2d) for m in model_q.net.modules())
    check(n_q == INT8_CONVS, f"11b: {n_q} quantized convs")
    log("int8", f"11b: GPTQ of {name} on the card equals the CPU's on the "
        f"same Hessian ({gptq_card_s:.2f} s on the card); Hessians of "
        f"{list(INT8_GPTQ_NAMES)} {hess_s:.2f} s; calibration, bias "
        f"correction and GPTQ on them {gptq_model_s:.2f} s; the served twin "
        f"(bf16, round to nearest, {INT8_CALIB_IMAGES} images) quantized in "
        f"{calib_s:.2f} s")
    out.update({"stats_worst_rel": worst_rel, "stats_equal": len(same),
                "gptq_equal": g_equal, "hessians_s": hess_s,
                "gptq_card_s": gptq_card_s, "gptq_model_s": gptq_model_s,
                "calibrate_quantize_s": calib_s})

    # -- 11c. the int8 artifact, exact, then served --------------------------
    folder = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    path = os.path.join(folder, "refinedet320_int8.rdtpu")
    t0 = time.perf_counter()
    program = export_inference(model_q, fused_nms={})
    write_serving(path, {"cuda": program},
                  serving_metadata(model_q, None, {}))
    serving = load_serving(path)
    out["export_save_load_s"] = time.perf_counter() - t0
    check(serving.meta["int8"] and serving.meta["quant_skip"]
          == list(DEFAULT_QUANT_SKIP), f"11c: meta {serving.meta}")
    live = make_serving_fn(model_q, None, fused_nms={})
    kept = []
    for b in ARTIFACT_BATCHES:
        imgs = noise_images(rng, b)
        got, want = serving(imgs), live(imgs)
        check(np.array_equal(got, want), f"11c: the int8 artifact differs "
              f"from the live int8 function at batch {b} (max abs err "
              f"{np.abs(got - want).max()})")
        kept.append(int((got[..., 4] > 0).sum()))
    log("int8", f"11c: int8 artifact ({os.path.getsize(path) / 1e6:.1f} "
        f"MB) equals the live int8 function exactly at batches "
        f"{list(ARTIFACT_BATCHES)} ({kept} detections)")
    engine = BatchingEngine(serving, (SIZE, SIZE, 3), max_batch=MAX_BATCH,
                            max_delay_ms=20.0,
                            input_dtype=serving.input_dtype)
    serving.warm_up(engine.buckets)
    for b in engine.buckets:
        g = serving.graphs[b]
        check((g.int8_launches, g.quant_launches, g.launches,
               g.epilogue_launches)
              == (INT8_CONVS, INT8_CONVS, 1, EPILOGUE_CONVS_INT8),
              f"11c: bucket {b}'s graph holds {g.int8_launches} int8 conv, "
              f"{g.quant_launches} quantize, {g.launches} K1 and "
              f"{g.epilogue_launches} conv epilogue launches")
    server = Server(engine, serving.meta)
    requests = noise_images(rng, ENGINE_REQUESTS + HTTP_REQUESTS)
    copies = quant.copies
    _, stats, k1_launches = serve_requests(engine, server, requests, "int8")
    int8_launches, quant_launches = op.launches, quant.launches
    check(k1_launches == stats["batches"] > 0
          and int8_launches == quant_launches
          == INT8_CONVS * stats["batches"],
          f"11c: {int8_launches} int8 conv, {quant_launches} quantize and "
          f"{k1_launches} K1 launches for {stats['batches']} device batches")
    count_epilogue("11c int8 artifact", stats["batches"], EPILOGUE_CONVS_INT8)
    log("int8", f"11c: {len(requests)} requests ({HTTP_REQUESTS} over HTTP) "
        f"through the int8 artifact's graphs (buckets "
        f"{list(engine.buckets)}, each holding {INT8_CONVS} int8 conv, "
        f"{INT8_CONVS} quantize and 1 K1 launch) in {stats['batches']} "
        f"device batches: int8 conv launches {int8_launches}, quantize "
        f"launches {quant_launches}, K1 launches {k1_launches}")
    out["served"] = {"requests": len(requests), "batches": stats["batches"],
                     "int8_launches": int8_launches,
                     "quantize_launches": quant_launches,
                     "k1_launches": k1_launches}

    # -- 11d. timings ------------------------------------------------------------
    log("int8", smi)
    b = INT8_TIME_BATCH
    served = {(c["hwc"], c["o"], c["geom"]): c for c in int8_bench.distinct(
        served_convs)}
    rows, sums = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "cudnn_bf16_ms": 0.0}
    with torch.inference_mode():
        for i, case in enumerate(every):
            xq, w, ws, bias = int8_bench.random_case(case, b, dev, 7000 + i)
            k, s, p, d = case["geom"]
            x16 = xq.to(bf16).permute(0, 3, 1, 2)
            w16 = w.to(bf16).permute(0, 3, 1, 2)
            b16 = bias.to(bf16)
            pl = int8_conv.plan(b, *case["hwc"], case["o"], k, s, p, d, sms)
            row = {"names": case["names"], "hwc": case["hwc"],
                   "o": case["o"], "geom": case["geom"],
                   "plan": {"box": pl.box, "bn": pl.bn, "bk": pl.bk,
                            "splits": pl.splits, "grid": pl.grid,
                            "stages": pl.stages},
                   "ms": graph_ms(lambda: op(xq, w, ws, bias, s, p, d, bf16),
                                  n=20),
                   "plain_ms": cuda_ms(lambda: plain(
                       xq, w, ws, bias, s, p, d, bf16), 2, warmup=1),
                   "library_ms": cuda_ms(lambda: int8_bench.int_mm_conv(
                       xq, w, ws, bias, s, p, d, bf16), 5, warmup=2),
                   "cudnn_bf16_ms": cuda_ms(lambda: F.conv2d(
                       x16, w16, b16, s, p, d), 5, warmup=2)}
            row["bound_ms"], row["bound_by"] = int8_bench.bound_ms(case, b)
            ops, nbytes = int8_bench.work(case, b)
            row["tops"] = ops / row["ms"] / 1e9
            key = (case["hwc"], case["o"], case["geom"])
            row["per_forward"] = served[key]["count"] if key in served else 0
            for kk in sums:
                sums[kk] += row["per_forward"] * row[kk]
            rows.append(row)
            log("time", f"11d int8 conv {'/'.join(case['names'])} "
                f"{case['hwc']}->{case['o']} k{k}s{s}p{p}d{d} batch {b}: "
                f"kernel {row['ms']:.4f} ms ({row['tops']:.1f} TOPS), "
                f"plain {row['plain_ms']:.3f}, bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}), _int_mm {row['library_ms']:.4f}, "
                f"cuDNN bf16 {row['cudnn_bf16_ms']:.4f} ms; "
                f"{row['per_forward']} a forward; plan box {pl.box} BN "
                f"{pl.bn} BK {pl.bk} splits {pl.splits} grid {pl.grid}")
            del xq, w, ws, bias, x16, w16, b16
        log("time", f"11d int8 convs of one forward at batch {b} "
            f"({INT8_CONVS} launches): kernel {sums['ms']:.3f} ms, plain "
            f"{sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.4f} ms, "
            f"_int_mm {sums['library_ms']:.3f} ms, cuDNN bf16 "
            f"{sums['cudnn_bf16_ms']:.3f} ms")
        q_rows, q_sums = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        for i, hwc in enumerate(inputs):
            x, scale = int8_bench.quantize_case(hwc, b, bf16, dev, 8000 + i)
            row = {"hwc": hwc, "per_forward": sum(
                       c["hwc"] == hwc for c in served_convs),
                   "ms": graph_ms(lambda: quant(x, scale), n=20),
                   "plain_ms": cuda_ms(lambda: plain_quant(x, scale), 5,
                                       warmup=2),
                   "bound_ms": int8_bench.quantize_bound_ms(hwc, b, bf16)}
            for kk in q_sums:
                q_sums[kk] += row["per_forward"] * row[kk]
            q_rows.append(row)
            log("time", f"11d quantize {hwc} bf16 batch {b}: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, bound "
                f"{row['bound_ms']:.4f} ms (bytes); {row['per_forward']} a "
                "forward")
        log("time", f"11d quantize launches of one forward at batch {b} "
            f"({INT8_CONVS}): kernel {q_sums['ms']:.3f} ms, plain "
            f"{q_sums['plain_ms']:.3f} ms, bound {q_sums['bound_ms']:.4f} "
            "ms; library_ms: n/a, no single PyTorch call computes it "
            "(quantize_per_channel divides by the scale instead of "
            "multiplying by its IEEE reciprocal, and clamps at -128)")
        # the wrappers' host cost a call: checks, plan (cached),
        # allocation, tensor maps, ctypes launch
        host = {}
        for label, case in (("conv, K split", every[-7]),
                            ("conv, whole K", every[6])):
            xq, w, ws, bias = int8_bench.random_case(case, b, dev, 1)
            k, s, p, d = case["geom"]
            host[label] = 1e3 * host_issue_ms(
                lambda: op(xq, w, ws, bias, s, p, d, bf16), 200)
            log("time", f"11d int8 conv wrapper ({label}, "
                f"{'/'.join(case['names'])}): {host[label]:.1f} us host "
                "time a call")
        x, scale = int8_bench.quantize_case(inputs[0], b, bf16, dev, 1)
        host["quantize"] = 1e3 * host_issue_ms(lambda: quant(x, scale),
                                               200)
        log("time", f"11d quantize wrapper: {host['quantize']:.1f} us host "
            "time a call")
        del xq, w, ws, bias, x, scale
        imgs = noise_images(rng, b)
        x = torch.from_numpy(imgs).to(dev)
        fwd_q = cuda_ms(lambda: model_q.raw_forward(x), 10)
        fwd_bf16 = cuda_ms(lambda: model.raw_forward(x), 10)
    check(quant.copies == copies, f"11c-d: the quantize copied "
          f"{quant.copies - copies} strided inputs on the 320 path")
    log("int8", f"11c-d: strided inputs the quantize copied on the 320 "
        f"path: {quant.copies - copies}")
    out["quantize"] = q_rows
    out["quantize_per_forward"] = q_sums
    out["host_us"] = host
    live_bf16 = make_serving_fn(model, None, fused_nms={})
    e2e_q = host_ms(lambda: live(imgs), 10)
    e2e_bf16 = host_ms(lambda: live_bf16(imgs), 10)
    serving.warm_up((b,))
    e2e_graph = host_ms(lambda: serving(imgs), 10)
    log("time", f"11d batch {b}: int8 forward {fwd_q:.2f} ms against bf16 "
        f"{fwd_bf16:.2f} ms (CUDA events); end to end int8 {e2e_q:.2f} ms "
        f"(live), {e2e_graph:.2f} ms (artifact graph) against bf16 "
        f"{e2e_bf16:.2f} ms (host clock)")
    out["convs"] = rows
    out["per_forward"] = sums
    lib8 = int8_conv.load_kernel()
    out["sass"] = sass_counts(lib8.path)
    log("int8", f"11d SASS of {lib8.path.name}: {out['sass']}")
    out["ptxas"] = ptxas_summary(lib8.build_log)
    for name, row in out["ptxas"].items():
        log("int8", f"11d ptxas {name}: {row}")
    if not out["ptxas"]:
        log("int8", "11d ptxas: the library was built by an earlier "
            "process (no -Xptxas -v log in this one)")
    out.update({"forward_int8_ms": fwd_q, "forward_bf16_ms": fwd_bf16,
                "serve_int8_ms": e2e_q, "serve_int8_graph_ms": e2e_graph,
                "serve_bf16_ms": e2e_bf16})
    del model, model_q, serving, live, live_bf16, engine, server, x
    shutil.rmtree(folder)
    torch.cuda.empty_cache()

    # -- 11e. int8 eval on the SSDD set ----------------------------------------
    data = SyntheticSSDD(INT8_SSDD_IMAGES, SSDD_SIZE, seed=600)
    transform = BaseTransform(SSDD_SIZE, MEANS)
    model512 = build_refinedet("test", SSDD_SIZE, 2, dtype=bf16, device=dev,
                               seed=0)
    q512, state512 = quantize_model(model512, calib_batches_from_dataset(
        data, transform, EVAL_BATCH, EVAL_BATCH), dtype=bf16)
    cfg = DetectConfig(num_classes=2, top_k=1000, keep_top_k=500,
                       nms_thresh=0.49)
    evaluator = Evaluator(q512, data, cfg, transform, batch_size=EVAL_BATCH,
                          nms_top_k=1000, max_per_image=500, plus_one=True,
                          log=lambda line: log("int8", line.strip()))
    recorded = []

    def recording(heads, priors, scales, *args):
        dets = eval_postprocess(heads, priors, scales, *args)
        recorded.append((heads, scales, dets))
        return dets

    n_batches = -(-len(data) // EVAL_BATCH)
    evaluator_module.eval_postprocess = recording
    nms_cuda.nms_sweep.launches = 0
    op.launches = 0
    quant.launches = 0
    conv_epilogue.conv_bias_relu.launches = 0
    try:
        all_boxes = evaluator.run(state512)
    finally:
        evaluator_module.eval_postprocess = eval_postprocess
    count_epilogue("11e int8 eval", n_batches, EPILOGUE_CONVS_INT8)
    eval_k1, eval_int8 = nms_cuda.nms_sweep.launches, op.launches
    eval_quant = quant.launches
    check(eval_k1 == len(recorded) == n_batches
          and eval_int8 == eval_quant == INT8_CONVS * n_batches,
          f"11e: {eval_k1} K1, {eval_int8} int8 conv and {eval_quant} "
          f"quantize launches for {n_batches} batches")
    mismatched = 0
    with torch.inference_mode():
        for heads, scales, dets in recorded:
            ref = eval_postprocess(heads, q512.priors, scales, cfg, 1000,
                                   True, plain=True)
            mismatched += not torch.equal(dets, ref)
    check(mismatched == 0, f"11e: {mismatched} batches differ from the "
          "plain post-process")
    coco = data.evaluate_detections(all_boxes)
    check(coco.shape == (12,) and np.isfinite(coco).all(),
          "11e: COCO stats not 12 finite values")
    log("int8", f"11e: int8 RefineDet512 (2 classes) eval on "
        f"{len(data)} SSDD images: K1 {eval_k1}, int8 conv {eval_int8} and "
        f"quantize {eval_quant} launches for {n_batches} batches, kernel "
        f"post-process equal to "
        f"the plain one on every batch; COCO stats "
        f"{np.round(coco, 4).tolist()}")
    out["eval"] = {"batches": n_batches, "k1_launches": eval_k1,
                   "int8_launches": eval_int8,
                   "quantize_launches": eval_quant,
                   "coco_stats": [float(v) for v in coco]}
    del model512, q512, evaluator, recorded
    torch.cuda.empty_cache()
    entries = [{"name": "int8_conv", "route": "cuda",
                "source": "refinedet_tpu_torch/csrc/int8_conv.cu",
                "replaces": "refinedet_tpu/models/layers.py:83",
                "launches": int8_launches, "max_abs_err": worst,
                "ms": sums["ms"], "plain_ms": sums["plain_ms"],
                "bound_ms": sums["bound_ms"], "bound_by": "operations",
                "library_ms": sums["library_ms"]},
               {"name": "int8_quantize", "route": "cuda",
                "source": "refinedet_tpu_torch/csrc/int8_conv.cu",
                "replaces": "refinedet_tpu/models/layers.py:79",
                "launches": quant_launches, "max_abs_err": worst_q,
                "ms": q_sums["ms"], "plain_ms": q_sums["plain_ms"],
                "bound_ms": q_sums["bound_ms"], "bound_by": "bytes",
                "library_ms": None}]
    return out, int8_launches, k1_launches + eval_k1, entries


def ddp_phase(dev: torch.device, smi: str) -> tuple:
    """Phase 12: data parallelism on the card; returns its numbers and
    K1's launches in 12b's ranks and their reference process."""
    import torch.distributed as dist
    from refinedet_tpu_torch.config import TrainConfig
    from refinedet_tpu_torch.data.collate import detection_collate
    from refinedet_tpu_torch.models import RefineDet, build_refinedet
    from refinedet_tpu_torch.parallel import distributed
    from refinedet_tpu_torch.tools import ddp_check
    from refinedet_tpu_torch.tools.train_check import (SyntheticDetection,
                                                       biases_before_bn,
                                                       one_step,
                                                       update_rel_errors)
    from refinedet_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step)

    out = {}
    bf16 = torch.bfloat16

    def build(size, classes, use_bn, dtype):
        model = build_refinedet("train", size, classes, use_bn=use_bn,
                                dtype=bf16 if dtype == bf16 else
                                torch.float32, device=dev, seed=0)
        if dtype == torch.float64:
            model.net.double()
        return model

    def meta_net(classes, size, use_bn):  # the layout, no weights
        with torch.device("meta"):
            return RefineDet(classes, size, use_bn)

    def batch_of(n, size, classes, seed):
        data = SyntheticDetection(n, size, classes, seed=seed)
        return detection_collate([data[i] for i in range(n)],
                                 TRAIN_MAX_BOXES)

    # -- 12a. NCCL at world size 1: the grouped step against today's -------
    check(distributed.maybe_initialize(
        f"tcp://localhost:{distributed.free_port()}", 1, 0),
        "12a: no process group")
    group = distributed.default_group()
    check(dist.get_backend(group) == "nccl"
          and distributed.local_device("cuda") == torch.device("cuda", 0),
          f"12a: backend {dist.get_backend(group)}, local device "
          f"{distributed.local_device('cuda')}")
    try:
        cfg = TrainConfig(max_boxes=TRAIN_MAX_BOXES,
                          grad_clip_norm=TRAIN_CLIP)
        for label, size, classes, use_bn, dtype, n in (
                (f"RefineDet{SIZE} bf16", SIZE, NUM_CLASSES, False, bf16,
                 TRAIN_BATCH),
                (f"RefineDet{BN_STEP_SIZE}-BN f64", BN_STEP_SIZE, 2, True,
                 torch.float64, 2)):
            batch = batch_of(n, size, classes, 500)
            (want, want_up), (got, got_up) = [
                one_step(build(size, classes, use_bn, dtype), batch, cfg,
                         lr=cfg.lr, group=g) for g in (None, group)]
            loss_err = max(abs(got[k] - want[k]) / abs(want[k])
                           for k in LOSS_KEYS)
            net = meta_net(classes, size, use_bn)
            params = ({k for k, _ in net.named_parameters()}
                      - biases_before_bn(net))
            rel = update_rel_errors(got_up, {k: want_up[k] for k in params})
            worst = max(rel, key=rel.get)
            stats = [k for k in want_up if ".running_" in k]
            stats_err = max([float((got_up[k] - want_up[k]).abs().max()
                                   / want_up[k].abs().max())
                             for k in stats] or [0.0])
            log("ddp", f"12a: {label}, batch {n}, NCCL world 1, grouped "
                f"(DDP, all-reduced N{', synced BN' if use_bn else ''}) "
                f"against ungrouped: worst loss rel err {loss_err:.3g} "
                f"(limit 2e-4), worst update rel L2 err {rel[worst]:.3g} "
                f"({worst}; limit 2e-2), {len(stats)} running statistics' "
                f"updates worst {stats_err:.3g} of their largest (limit "
                f"1e-4); positives ODM {got['num_pos_odm']:g}/"
                f"{want['num_pos_odm']:g}")
            check(loss_err <= 2e-4 and rel[worst] <= 2e-2
                  and stats_err <= 1e-4
                  and got["num_pos_odm"] == want["num_pos_odm"],
                  f"12a: {label}: the grouped step differs")
            check(len(stats) == (34 if use_bn else 0),
                  f"12a: {len(stats)} running statistics")
            out[f"world1_{'bn' if use_bn else 'plain'}"] = {
                "loss_rel_err": loss_err, "update_rel_err": rel[worst],
                "running_stats_err": stats_err}

        # -- 12c. timings at world size 1 ------------------------------------
        fixed = [torch.from_numpy(a).to(dev)
                 for a in batch_of(TRAIN_BATCH, SIZE, NUM_CLASSES, 501)]
        steps = {}
        for name, g in (("plain", None), ("ddp", group)):
            model = build(SIZE, NUM_CLASSES, False, bf16)
            opt = make_optimizer(model.net.parameters(), lambda t: 1e-3,
                                 grad_clip_norm=TRAIN_CLIP)
            step = make_train_step(model, opt, cfg, g)
            state = create_train_state(model, opt)
            for _ in range(3):
                state, _ = step(state, *fixed)
            steps[name] = (step, state, model)
        times = {"plain": [], "ddp": []}
        issue = {"plain": [], "ddp": []}
        for name in ("plain", "ddp", "ddp", "plain"):
            step, state, _ = steps[name]
            times[name].append(cuda_ms(lambda: step(state, *fixed),
                                       TRAIN_STEPS, 0))
            issue[name].append(host_issue_ms(lambda: step(state, *fixed),
                                             TRAIN_STEPS))
        grads = torch.zeros(sum(p.numel() for p in
                                steps["ddp"][2].net.parameters()),
                            device=dev)
        reduce_ms = cuda_ms(lambda: dist.all_reduce(grads, group=group), 20)
        log("ddp", f"12c: {smi}: bf16 step, batch {TRAIN_BATCH}, CUDA "
            f"events over {TRAIN_STEPS} steps, in turns: ungrouped "
            f"{times['plain'][0]:.3f} / {times['plain'][1]:.3f} ms, DDP "
            f"at world 1 {times['ddp'][0]:.3f} / {times['ddp'][1]:.3f} ms "
            f"(overhead {np.mean(times['ddp']) - np.mean(times['plain']):.3f}"
            f" ms); the host's time to issue a step (no sync): ungrouped "
            f"{issue['plain'][0]:.3f} / {issue['plain'][1]:.3f} ms, DDP "
            f"{issue['ddp'][0]:.3f} / {issue['ddp'][1]:.3f} ms; NCCL "
            f"all-reduce of {grads.numel()} f32 gradients alone at world 1: "
            f"{reduce_ms:.4f} ms")
        out["step_ms"] = times
        out["issue_ms"] = issue
        out["allreduce_ms"] = reduce_ms
        out["grad_elems"] = grads.numel()
        del steps, grads, fixed
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # -- 12b. two gloo ranks on the one card, against one process ----------
    plain = dict(kind="steps", name="plain", size=SIZE, classes=NUM_CLASSES,
                 batch=DDP_GLOBAL_BATCH, steps=DDP_STEPS, lr=DDP_LR,
                 clip=DDP_CLIP, save=(DDP_STEPS,))
    bn = dict(kind="steps", name="bn", size=BN_STEP_SIZE, classes=2, bn=True,
              dtype="float64", batch=DDP_GLOBAL_BATCH, steps=1, lr=DDP_LR,
              data_seed=11, save=(1,))
    evals = dict(kind="eval", name="eval", size=SIZE, images=VOC_EVAL_IMAGES,
                 data_seed=300, rank_batch=EVAL_BATCH, nms_top_k=300,
                 dtype="bfloat16", seed=1)
    jobs = [plain, bn, evals]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        results = ddp_check.start(2, jobs, [jobs], folder, backend="gloo",
                                  device="cuda:0", threads=2).results(900)
    log("ddp", f"12b: 2 gloo ranks and 1 reference process on "
        f"{torch.cuda.get_device_name(0)}, spawned, ran in "
        f"{time.perf_counter() - t0:.1f} s")
    ranks, ref = (results["rank0"], results["rank1"]), results["reference0"]
    for name in ("plain", "bn"):
        check(ranks[0][name]["digest"] == ranks[1][name]["digest"]
              and ranks[0][name]["metrics"] == ranks[1][name]["metrics"],
              f"12b: the ranks' {name} states differ")
    loss_err = max(abs(g[k] - w[k]) / abs(w[k]) for name in ("plain", "bn")
                   for g, w in zip(ranks[0][name]["metrics"],
                                   ref[name]["metrics"]) for k in LOSS_KEYS)
    got, want = ranks[0]["plain"]["saved"][DDP_STEPS], \
        ref["plain"]["saved"][DDP_STEPS]
    sums, heads = ddp_check.summary_errors(got["params"], want["params"])
    rel = update_rel_errors(got["momentum"], want["momentum"])
    worst = max(rel, key=rel.get)
    log("ddp", f"12b: RefineDet{SIZE} f32 (TF32 off), {DDP_STEPS} steps "
        f"at global batch {DDP_GLOBAL_BATCH}, lr {DDP_LR}, clip {DDP_CLIP}: "
        f"ranks bitwise equal; against one process: parameters' sums "
        f"{sums:.3g} (limit 1e-6) and first elements {heads:.3g} (limit "
        f"1e-5), worst update (momentum) rel L2 err {rel[worst]:.3g} "
        f"({worst}; limit 2e-2)")
    check(sums <= 1e-6 and heads <= 1e-5 and rel[worst] <= 2e-2,
          "12b: the plain steps differ from one process's")
    got, want = ranks[0]["bn"]["saved"][1], ref["bn"]["saved"][1]
    stats = [k for k in want["buffers"] if ".running_" in k]
    stats_err = max(float((got["buffers"][k] - want["buffers"][k]).abs()
                          .max() / want["buffers"][k].abs().max())
                    for k in stats)
    net = meta_net(2, BN_STEP_SIZE, True)
    l2 = {k for k in want["momentum"] if "L2Norm" in k}
    skip = biases_before_bn(net) | l2
    rel = update_rel_errors(got["momentum"], {
        k: v for k, v in want["momentum"].items() if k not in skip})
    rel_l2 = update_rel_errors(got["momentum"],
                               {k: want["momentum"][k] for k in l2})
    worst = max(rel, key=rel.get)
    log("ddp", f"12b: RefineDet{BN_STEP_SIZE}-BN f64, one step at global "
        f"batch {DDP_GLOBAL_BATCH}: ranks bitwise equal; against one "
        f"process: {len(stats)} running statistics worst "
        f"{stats_err:.3g} of their largest (limit 1e-9), worst update rel "
        f"L2 err {rel[worst]:.3g} ({worst}; limit 1e-9), the L2Norm scales "
        f"(float32) {max(rel_l2.values()):.3g} (limit 1e-6); worst loss "
        f"rel err of both runs {loss_err:.3g} (float32 heads; limit 1e-5)")
    check(len(stats) == 34 and stats_err <= 1e-9 and rel[worst] <= 1e-9
          and max(rel_l2.values()) <= 1e-6 and loss_err <= 1e-5,
          "12b: the BN step differs from one process's")
    got, want = ranks[0]["eval"]["all_boxes"], ref["eval"]["all_boxes"]
    check(ranks[1]["eval"]["all_boxes"] is None, "12b: rank 1 returned "
          "detections")
    diff, rows = 0.0, 0
    for cls_got, cls_want in zip(got, want):
        for a, b in zip(cls_got, cls_want):
            check(a.shape == b.shape, f"12b: detection counts differ: "
                  f"{a.shape} against {b.shape}")
            if a.size:
                diff = max(diff, float(np.abs(a - b).max()))
            rows += len(b)
    launches = sum(r["eval"]["launches"] for r in (*ranks, ref))
    n_batches = VOC_EVAL_IMAGES // EVAL_BATCH
    log("ddp", f"12b: Evaluator, RefineDet{SIZE} bf16, "
        f"{VOC_EVAL_IMAGES} images of 7a's VOC set, 2 ranks x batch "
        f"{EVAL_BATCH} against one process at batch {EVAL_BATCH}: "
        f"{rows} detections, max |difference| {diff:g} (limit 0); K1 "
        f"launches {ranks[0]['eval']['launches']} + "
        f"{ranks[1]['eval']['launches']} in the ranks, "
        f"{ref['eval']['launches']} in the reference")
    check(diff == 0.0 and len(got) == len(want) == NUM_CLASSES
          and rows > 0, "12b: the 2-rank Evaluator differs from one process")
    check(launches == 2 * n_batches, f"12b: K1 launched {launches} times "
          f"for {2 * n_batches} batches")
    log("ddp", f"12c: {smi}: the 2-rank gloo step through the host, a "
        f"correctness run and not a scaling figure: RefineDet{SIZE} f32 at "
        f"2 rows a rank {[round(v, 2) for v in ranks[0]['plain']['ms']]} "
        f"ms (host clock, synchronised), one process at "
        f"{DDP_GLOBAL_BATCH} rows {[round(v, 2) for v in ref['plain']['ms']]}"
        f" ms")
    out["gloo_step_ms"] = ranks[0]["plain"]["ms"]
    out["reference_step_ms"] = ref["plain"]["ms"]
    out["eval_launches"] = launches
    return out, launches


def tools_phase(dev: torch.device) -> tuple:
    """Phase 13: the trained-fixture tools (``tools/smoke_e2e``,
    ``ablate_int8``, ``bench_serve``) on the card. Returns its numbers and
    the launches of K1, the int8 conv and the quantize on its main path."""
    from refinedet_tpu_torch.detect.detection import detect_refinedet
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.ops import int8_conv, nms_cuda
    from refinedet_tpu_torch.ops.nms import (nms_sweep_reference,
                                             select_candidates)
    from refinedet_tpu_torch.tools import ablate_int8, bench_serve
    from refinedet_tpu_torch.tools import fixture_train as ft
    from refinedet_tpu_torch.tools import smoke_e2e
    from refinedet_tpu_torch.tools.fixtures import coco_fixture

    counters = (nms_cuda.nms_sweep, int8_conv.int8_conv,
                int8_conv.int8_quantize)
    for c in counters:
        c.launches = 0
    out = {}
    # -- 13a. learnability: smoke_e2e at its defaults ------------------------
    t0 = time.perf_counter()
    e2e = smoke_e2e.run(dev, log=lambda line: log("tools", f"13a {line}"))
    first, last = e2e["logged"][0][1], e2e["logged"][-1][1]
    out["smoke_e2e"] = {"ap": e2e["ap"], "ap50": e2e["ap50"],
                        "logged": e2e["logged"],
                        "seconds": time.perf_counter() - t0}
    log("tools", f"13a smoke_e2e ({smoke_e2e.STEPS} steps, RefineDet{SIZE} "
        f"bf16): loss {first:.3f} -> {last:.3f} ({first / last:.1f}x, limit "
        f">= {TOOLS_LOSS_DROP:g}x), train-set AP {e2e['ap']:.4f} AP50 "
        f"{e2e['ap50']:.4f} (limit >= {TOOLS_MIN_AP50}), "
        f"{out['smoke_e2e']['seconds']:.1f} s")
    check(first >= TOOLS_LOSS_DROP * last,
          f"13a: the loss fell {first / last:.2f}x, not {TOOLS_LOSS_DROP}x")
    check(e2e["ap50"] >= TOOLS_MIN_AP50,
          f"13a: AP50 {e2e['ap50']:.4f} < {TOOLS_MIN_AP50}")
    # -- 13b. int8 arms ------------------------------------------------------
    # On the protocol where the JAX repo measured int8 accuracy:
    # ablate_int8's seed 0, trained here. (13a's 16 memorized images at
    # the peak lr lose AP50 to the matched weight noise alone.)
    t0 = time.perf_counter()
    ds = coco_fixture(ablate_int8.N_IMAGES, 0, SIZE, dev)
    model, _ = ft.train_from_scratch(
        0, SIZE, 2, TOOLS_ABLATE_STEPS, TOOLS_ABLATE_BATCH, ds,
        ft.decay_schedule(TOOLS_ABLATE_STEPS), dev,
        log=lambda line: log("tools", f"13b ablate_int8 seed 0: {line}"))
    trained = ft.net_state(model.net)
    del model
    arms = ablate_int8.score_arms(trained, ds, SIZE, TOOLS_ARMS, seed=0,
                                  device=dev)
    out["arms"] = arms
    for tag, ap in arms.items():
        d50 = ap["ap50"] - arms["bf16"]["ap50"]
        log("tools", f"13b ablate_int8 seed 0 ({TOOLS_ABLATE_STEPS} "
            f"steps), {tag}: AP {ap['ap']:.4f} AP50 {ap['ap50']:.4f} (dAP "
            f"{ap['ap'] - arms['bf16']['ap']:+.4f}, dAP50 {d50:+.4f})")
        if tag.startswith("int8"):
            check(d50 >= -TOOLS_INT8_MAX_DROP,
                  f"13b: {tag} dAP50 {d50:+.4f} < -{TOOLS_INT8_MAX_DROP}")
    log("tools", f"13b: {len(arms)} arms in {time.perf_counter() - t0:.1f} "
        "s with the training (one calibration of 16 images, GPTQ on every "
        "quantized conv)")
    # -- 13c. the serving host under load ------------------------------------
    out["bench_serve"] = {}
    for flags in (["--fused_nms"], ["--int8", "--fused_nms"]):
        t0 = time.perf_counter()
        res = bench_serve.main(flags)
        tag = " ".join(flags)
        out["bench_serve"][tag] = res
        for leg, r in res["results"].items():
            log("tools", f"13c bench_serve {tag} ({res['dtype']}), leg "
                f"{leg}: {r['ok']} ok, {r['errors']} errors, "
                f"{r['req_per_s']} req/s, p50 {r.get('p50_ms')} ms, p99 "
                f"{r.get('p99_ms')} ms")
            check(r["errors"] == 0 and r["ok"] == res["requests"],
                  f"13c: bench_serve {tag} leg {leg}: {r}")
        log("tools", f"13c bench_serve {tag}: batches "
            f"{res['batch_size_hist']}, launches {res['launches']}, "
            f"{time.perf_counter() - t0:.1f} s")
    # -- 13d. the kernels' launches on the phase's main path ----------------
    launches = tuple(c.launches for c in counters)
    out["launches"] = dict(zip(("nms_sweep", "int8_conv", "int8_quantize"),
                               launches))
    log("tools", f"13d launches in phase 13: K1 {launches[0]}, int8 conv "
        f"{launches[1]}, quantize {launches[2]}")
    check(all(n > 0 for n in launches), f"13d: launches {launches}")
    # K1 at the tools' eval shapes, on 13a's trained heads (not counted):
    # the keep mask against the plain version's, then the times
    model = build_refinedet("test", SIZE, 2, dtype=torch.bfloat16,
                            device=dev)
    model.net.load_state_dict(e2e["state"], strict=True)
    with torch.inference_mode():
        imgs = torch.from_numpy(ft.eval_images(e2e["ds"], ft.EVAL_BATCH))
        heads = model.raw_forward(imgs.to(dev))
        boxes, scores = detect_refinedet(
            heads[0], heads[1].softmax(-1), heads[2], heads[3].softmax(-1),
            model.priors)
        _, _, cand, valid = select_candidates(
            (boxes * SIZE)[:, None], scores[..., 1:].movedim(-1, 1),
            ft.EVAL_NMS_TOP_K, 0.01)
        cand = cand.reshape(-1, ft.EVAL_NMS_TOP_K, 4).contiguous()
        valid = valid.reshape(-1, ft.EVAL_NMS_TOP_K).contiguous()
    k1 = {}
    for label, c, v in (("tools eval", cand, valid),
                        ("tools eval, 13a's groups x3",
                         cand.repeat(3, 1, 1), valid.repeat(3, 1))):
        with torch.inference_mode():
            got = nms_cuda.nms_sweep(c, v, 0.49, True)
            want = nms_sweep_reference(c, v, 0.49, True)
        check(torch.equal(got, want), f"13d: K1 {label} G={v.shape[0]}: "
              f"{int((got != want).sum())} keep flags differ from the plain "
              "version")
        log("tools", f"13d K1 {label} G={v.shape[0]} K={v.shape[1]}: keep "
            f"mask equal to the plain version's ({int(got.sum())} kept)")
        ms, plain, bound, bound_by = time_sweep(c, v, label, 0.49, True)
        k1[f"G={v.shape[0]}"] = {"ms": ms, "plain_ms": plain,
                                 "bound_ms": bound, "bound_by": bound_by,
                                 "k": int(v.shape[1])}
    out["k1"] = k1
    del model, heads
    torch.cuda.empty_cache()
    return out, launches


def profile_phase(dev: torch.device, smi: str, rng) -> tuple:
    """Phase 14: the profiling tools on the card; returns their numbers
    and the hand-written kernels' launches on 14e's main path (K1, the
    int8 conv, the quantize)."""
    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.ops import int8_conv, nms_cuda
    from refinedet_tpu_torch.ops import nms_native
    from refinedet_tpu_torch.ops.nms import soft_nms
    from refinedet_tpu_torch.quant import (DEFAULT_QUANT_SKIP,
                                           quantize_variables)
    from refinedet_tpu_torch.serve import make_serving_fn
    from refinedet_tpu_torch.tools import (flops_train_step, int8_bench,
                                           profile_train_step, trace_infer,
                                           trace_train_step)
    from refinedet_tpu_torch.tools.k1_bench import noise_images
    from refinedet_tpu_torch.utils.timer import profile_trace, span
    from refinedet_tpu_torch.utils.trace_summary import (format_summary,
                                                         trace_stats)

    out = {"card": smi}
    folder = tempfile.mkdtemp(prefix="chip_smoke_traces_")

    def traced(name, capture, batch, runs):
        logdir = os.path.join(folder, name)
        t0 = time.perf_counter()
        capture(logdir, batch, runs, dev)
        t1 = time.perf_counter()
        stats = trace_stats(logdir)
        t2 = time.perf_counter()
        for line in format_summary(stats, batch).splitlines():
            log("profile", f"{name}: {line}")
        ex = stats["executions"]
        check(len(ex) == runs, f"{name}: {len(ex)} executions traced")
        check(all(x["busy_ms"] <= x["span_ms"] for x in ex)
              and stats["busy_ms"] <= stats["span_ms"],
              f"{name}: device busy above its span")
        cat_sum = sum(stats["categories_ms"].values())
        check(abs(cat_sum - stats["device_total_ms"]) <= 1e-9,
              f"{name}: categories sum to {cat_sum} of "
              f"{stats['device_total_ms']} ms")
        log("profile", f"{name}: capture {t1 - t0:.1f} s, summary "
            f"{t2 - t1:.1f} s; categories sum to the device total "
            f"({stats['device_total_ms']:.3f} ms); busy <= span per "
            "execution")
        return {k: stats[k] for k in ("executions", "gaps_ms", "busy_ms",
                                      "span_ms", "idle_pct",
                                      "categories_ms")}

    # -- 14a. trace_infer: RefineDet320 bf16 inference, batch 128 ----------
    log("profile", smi)
    out["infer"] = traced("14a trace_infer", trace_infer.capture,
                          PROFILE_INFER_BATCH, PROFILE_INFER_ITERS)
    torch.cuda.empty_cache()

    # -- 14b. trace_train_step: the train step, batch 128 ------------------
    out["train"] = traced("14b trace_train_step", trace_train_step.capture,
                          PROFILE_TRAIN_BATCH, PROFILE_TRAIN_STEPS)
    torch.cuda.empty_cache()

    # -- 14c. profile_train_step --remat: the attribution ------------------
    t0 = time.perf_counter()
    prof = profile_train_step.main([str(PROFILE_STEP_BATCH),
                                    str(PROFILE_STEP_ITERS), "--remat"])
    check(all(np.isfinite(v) and v > 0 for v in prof["ms"].values()),
          f"14c: times {prof['ms']}")
    log("profile", "14c: " + "; ".join(
        f"{k} {v:.2f} ms, peak {prof['peak_gib'][k]:.2f} GiB"
        for k, v in prof["ms"].items()) +
        f" ({time.perf_counter() - t0:.1f} s)")
    out["attribution"] = prof
    torch.cuda.empty_cache()

    # -- 14d. flops_train_step: FLOPs and the step's TFLOP/s -----------------
    flops = flops_train_step.main([str(PROFILE_STEP_BATCH)])
    step_flops_ = flops["full step"][0]
    tflops = step_flops_ / (prof["ms"]["full"] * 1e-3) / 1e12
    log("profile", f"14d: {smi}: full step at batch {PROFILE_STEP_BATCH} "
        f"{step_flops_ / 1e12:.3f} TFLOP (FlopCounterMode) in "
        f"{prof['ms']['full']:.2f} ms (14c) = {tflops:.1f} TFLOP/s, "
        f"{100 * tflops / BF16_PEAK_TFLOPS:.1f}% of the dense bf16 peak "
        f"{BF16_PEAK_TFLOPS} TFLOP/s (NVIDIA's H100 SXM data sheet, at "
        "700 W)")
    out["flops"] = {k: list(v) if isinstance(v, tuple) else v
                    for k, v in flops.items()}
    out["step_tflops"] = tflops
    torch.cuda.empty_cache()

    # -- 14e. the hand-written kernels in a trace --------------------------
    model = build_refinedet("test", SIZE, NUM_CLASSES, dtype=torch.bfloat16,
                            device=dev, seed=0)
    serve = make_serving_fn(model, None, fused_nms={})
    model_q = build_refinedet("test", SIZE, NUM_CLASSES,
                              dtype=torch.bfloat16, device=dev, quant=True,
                              quant_skip=DEFAULT_QUANT_SKIP)
    model_q.net.load_state_dict(quantize_variables(
        model_q, model.net.state_dict(),
        int8_bench.made_up_stats(model_q.net, 0)))
    imgs = noise_images(rng, SERVE_BATCH)
    x = torch.from_numpy(imgs).to(dev)
    with torch.inference_mode():
        serve(imgs)
        model_q.raw_forward(x)  # builds, plans, warm-up
        torch.cuda.synchronize()
        logdir = os.path.join(folder, "14e")
        counters = (nms_cuda.nms_sweep, int8_conv.int8_conv,
                    int8_conv.int8_quantize)
        for c in counters:
            c.launches = 0
        with profile_trace(logdir, dev):
            with span("serve/fused_nms"):
                serve(imgs)
            with span("int8/forward"):
                model_q.raw_forward(x)
        launched = [c.launches for c in counters]
    stats = trace_stats(logdir)
    calls = [stats["handwritten_calls"].get(n, 0) for n in
             ("nms_sweep (K1)", "int8_conv", "int8_quantize")]
    named = [stats["handwritten_kernels"][n] for n in
             ("nms_sweep (K1)", "int8_conv", "int8_quantize")]
    log("profile", f"14e: launches counted by the wrappers (K1, int8 conv, "
        f"quantize) {launched}; op calls in the trace {calls}; kernels by "
        f"name {named}; device ms by op " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(
                stats["categories_ms"].items(), key=lambda kv: -kv[1])))
    check(launched == [1, 26, 26] and calls == launched and named == launched,
          f"14e: wrappers {launched}, trace op calls {calls}, kernels by "
          f"name {named}, expected [1, 26, 26]")
    out["handwritten"] = {"launches": launched, "trace_calls": calls,
                          "trace_kernels": named,
                          "categories_ms": stats["categories_ms"]}
    del model, serve, model_q, x
    torch.cuda.empty_cache()

    # -- 14f. soft_nms on the card ------------------------------------------
    xy = rng.uniform(0, 240, (SOFT_NMS_K, 2))
    wh = rng.uniform(8, 60, (SOFT_NMS_K, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, SOFT_NMS_K).astype(np.float32)
    b, s = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    out["soft_nms"] = {}
    for method in ("linear", "gaussian", "hard"):
        want = soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        method=method)
        got = soft_nms(b, s, method=method)
        keep = got.keep.cpu()
        kept = got.indices.cpu()[keep]
        ulps = int(np.abs(
            got.scores.cpu().numpy().view(np.int32).astype(np.int64)
            - want.scores.numpy().view(np.int32).astype(np.int64)).max())
        dets = np.concatenate([boxes, scores[:, None]], 1)
        host = nms_native.soft_nms(dets, method=method)
        host_scores = {i: dets[i, 4] for i in host}
        gap = max(abs(float(got.scores[j]) - float(host_scores[int(i)]))
                  for j, i in zip(np.nonzero(keep.numpy())[0],
                                  kept.numpy()))
        check(torch.equal(got.indices.cpu(), want.indices)
              and torch.equal(keep, want.keep),
              f"14f {method}: indices or keep differ from the CPU")
        check(sorted(host) == sorted(kept.tolist()),
              f"14f {method}: kept set differs from nms_native.soft_nms")
        check(ulps <= SOFT_NMS_ULPS[method],
              f"14f {method}: scores {ulps} ulps from the CPU's")
        ms = cuda_ms(lambda: soft_nms(b, s, method=method), 5, warmup=1)
        logdir = os.path.join(folder, f"14f_{method}")
        with profile_trace(logdir, dev):
            with span(f"soft_nms/{method}"):
                soft_nms(b, s, method=method)
        kernels = sum(trace_stats(logdir)["kernel_counts"].values())
        out["soft_nms"][method] = {"kept": int(keep.sum()), "ulps": ulps,
                                   "host_gap": gap, "ms": ms,
                                   "kernels_per_call": kernels}
        log("profile", f"14f soft_nms {method}, K={SOFT_NMS_K}: "
            f"{int(keep.sum())} kept; indices and keep equal the CPU's "
            f"and nms_native's kept set; scores {ulps} ulps from the CPU's "
            f"(limit {SOFT_NMS_ULPS[method]}), {gap:.3g} from the host's; "
            f"{ms:.3f} ms a call (CUDA events), {kernels} kernel launches "
            "a call (trace)")
    shutil.rmtree(folder)
    return out, launched


def spatial_phase(dev: torch.device, smi: str) -> dict:
    """Phase 15: spatial sharding (``--spatial_shards``) on the card, gloo
    ranks sharing it; no hand-written kernel may launch."""
    from refinedet_tpu_torch.models import RefineDet
    from refinedet_tpu_torch.tools import ddp_check
    from refinedet_tpu_torch.tools.train_check import (biases_before_bn,
                                                       update_rel_errors)

    out = {"card": smi}
    sp = SPATIAL_SHARDS

    def spatial(job):
        return {**job, "spatial_shards": sp}

    def ranks_equal(results, n, name):
        got = [results[f"rank{i}"][name] for i in range(n)]
        check(all(g["digest"] == got[0]["digest"]
                  and g["metrics"] == got[0]["metrics"] for g in got),
              f"15: the ranks' {name} states differ")

    def plain_close(label, got, want, steps, limit=2e-2):
        """The ranks' state against one process's: losses, the JAX
        package's multi-process parameter limits, each update within
        ``limit`` (the float32 L2Norm scales 1e-6 when it is tighter);
        ``limit`` None prints the updates' error without holding it."""
        loss_err = max(abs(g[k] - w[k]) / abs(w[k])
                       for g, w in zip(got["metrics"], want["metrics"])
                       for k in LOSS_KEYS)
        g, w = got["saved"][steps], want["saved"][steps]
        sums, heads = ddp_check.summary_errors(g["params"], w["params"])
        rel = update_rel_errors(g["momentum"], w["momentum"])
        l2 = max(v for k, v in rel.items() if "L2Norm" in k)
        worst = max((k for k in rel if "L2Norm" not in k), key=rel.get)
        held = "not held" if limit is None else f"limit {limit:g}"
        log("spatial", f"{label}: ranks bitwise equal; against one "
            f"process: worst loss rel err {loss_err:.3g} (limit 1e-5), "
            f"parameters' sums {sums:.3g} (limit 1e-6) and first elements "
            f"{heads:.3g} (limit 1e-5), worst update (momentum) rel L2 err "
            f"{rel[worst]:.3g} ({worst}; {held}), the L2Norm scales "
            f"{l2:.3g}")
        check(loss_err <= 1e-5 and sums <= 1e-6 and heads <= 1e-5
              and (limit is None or (rel[worst] <= limit
                                     and l2 <= max(limit, 1e-6))),
              f"{label}: differs from one process")
        return {"loss_rel_err": loss_err, "param_sums_err": sums,
                "param_heads_err": heads, "update_rel_err": rel[worst],
                "l2norm_rel_err": l2}

    plain = dict(kind="steps", name="plain", size=SIZE, classes=NUM_CLASSES,
                 batch=DDP_GLOBAL_BATCH, steps=DDP_STEPS, lr=DDP_LR,
                 clip=DDP_CLIP, save=(DDP_STEPS,))
    bn = dict(kind="steps", name="bn896", size=BN_SIZE, classes=2, bn=True,
              dtype="float64", batch=SPATIAL_BN_BATCH, steps=1, lr=DDP_LR,
              data_seed=11, save=(1,))
    mem = dict(kind="steps", name="mem896", size=BN_SIZE, classes=2,
               bn=True, dtype="bfloat16", batch=BN_BATCH,
               steps=SPATIAL_MEM_STEPS, lr=DDP_LR, clip=TRAIN_CLIP,
               data_seed=21)
    # 16b rides here: the sharded step under the slice pool backward
    plain_slice = {**plain, "name": "plain_slice", "pool_backward": "slice"}
    one = {**plain, "steps": 1, "save": (1,)}
    augmented = {**one, "name": "augmented", "staging": STAGING}
    augmented64 = {**augmented, "name": "augmented64", "dtype": "float64"}
    with tempfile.TemporaryDirectory() as folder:
        trainer = dict(kind="trainer", name="trainer", size=SIZE,
                       classes=NUM_CLASSES, dtype="bfloat16",
                       batch=SPATIAL_TRAINER_BATCH,
                       steps=SPATIAL_TRAINER_STEPS, lr=1e-3,
                       clip=TRAIN_CLIP, spatial_shards=sp,
                       checkpoint=os.path.join(folder, "trainer"))
        runs = {}
        for label, n, rank_jobs, refs, threads in (
                ("15a/c", sp, [spatial(mem), spatial(plain),
                               spatial(plain_slice), spatial(bn), trainer],
                 [mem, plain, bn], 2),
                ("15b", 2 * sp, [spatial(one), spatial(augmented),
                                 spatial(augmented64)],
                 [one, augmented, augmented64], 1)):
            sub = os.path.join(folder, label.replace("/", ""))
            os.mkdir(sub)
            t0 = time.perf_counter()
            runs[label] = ddp_check.start(
                n, rank_jobs, [refs], sub, backend="gloo", device="cuda:0",
                threads=threads).results(600)
            log("spatial", f"{label}: {n} gloo ranks (data "
                f"{n // sp} x space {sp}) and 1 reference process on "
                f"{torch.cuda.get_device_name(0)}, spawned, ran in "
                f"{time.perf_counter() - t0:.1f} s")
    a, b = runs["15a/c"], runs["15b"]
    ref = a["reference0"]

    # -- 15a. two ranks, S = 2, against one process -------------------------
    for name in ("plain", "plain_slice", "bn896"):
        ranks_equal(a, sp, name)
    out["plain"] = plain_close(
        f"15a: RefineDet{SIZE} f32 (TF32 off), S = {sp}, {DDP_STEPS} steps "
        f"at global batch {DDP_GLOBAL_BATCH}, lr {DDP_LR}, clip {DDP_CLIP}",
        a["rank0"]["plain"], ref["plain"], DDP_STEPS)
    out["plain_slice"] = plain_close(
        f"16b (in this spawn): the same under POOL_BACKWARD 'slice' "
        f"against one process under 'select_scatter'",
        a["rank0"]["plain_slice"], ref["plain"], DDP_STEPS)
    got, want = a["rank0"]["bn896"], ref["bn896"]
    g, w = got["saved"][1], want["saved"][1]
    stats = [k for k in w["buffers"] if ".running_" in k]
    stats_err = max(float((g["buffers"][k] - w["buffers"][k]).abs().max()
                          / w["buffers"][k].abs().max()) for k in stats)
    with torch.device("meta"):
        net = RefineDet(2, BN_SIZE, use_bn=True)
    l2 = {k for k in w["momentum"] if "L2Norm" in k}
    skip = biases_before_bn(net) | l2
    rel = update_rel_errors(g["momentum"], {
        k: v for k, v in w["momentum"].items() if k not in skip})
    rel_l2 = update_rel_errors(g["momentum"],
                               {k: w["momentum"][k] for k in l2})
    worst = max(rel, key=rel.get)
    loss_err = max(abs(got["metrics"][0][k] - want["metrics"][0][k])
                   / abs(want["metrics"][0][k]) for k in LOSS_KEYS)
    log("spatial", f"15a: RefineDet{BN_SIZE}-BN f64, 2 classes, "
        f"{len(net.arm_loc)} sources, S = {sp}, one step at batch "
        f"{SPATIAL_BN_BATCH}: ranks "
        f"bitwise equal; against one process: {len(stats)} running "
        f"statistics worst {stats_err:.3g} of their largest (limit 1e-9), "
        f"worst update rel L2 err {rel[worst]:.3g} ({worst}; limit 1e-9), "
        f"the L2Norm scales (float32) {max(rel_l2.values()):.3g} (limit "
        f"1e-6), worst loss rel err {loss_err:.3g} (float32 heads; limit "
        f"1e-5)")
    check(len(stats) == 34 and stats_err <= 1e-9 and rel[worst] <= 1e-9
          and len(l2) == (3 if BN_SIZE == 896 else 2)
          and max(rel_l2.values()) <= 1e-6
          and loss_err <= 1e-5, "15a: the 896-BN step differs from one "
          "process's")
    out["bn896"] = {"running_stats_err": stats_err,
                    "update_rel_err": rel[worst],
                    "l2norm_rel_err": max(rel_l2.values()),
                    "loss_rel_err": loss_err}

    # -- 15b. four ranks, data 2 x space 2 -----------------------------------
    # The augmented step in f32 is printed, not held: on these image-like
    # inputs the conv biases' gradients cancel down to ~2e-4 of norm, and
    # cuDNN's algorithms for a band's shape and the whole image's round
    # them 3e-2 apart. In float64, as 8a compares card and CPU, the same
    # step agrees to ~1e-14 and is held to 1e-9.
    aug = f"on-device augmentation, staging {STAGING}"
    for name, label, limit in (("plain", "f32, plain", 2e-2),
                               ("augmented", f"f32, {aug}", None),
                               ("augmented64", f"float64, {aug}", 1e-9)):
        ranks_equal(b, 2 * sp, name)
        out[f"grid_{name}"] = plain_close(
            f"15b: RefineDet{SIZE} {label}, data 2 x space {sp}, one step "
            f"at global batch {DDP_GLOBAL_BATCH}",
            b["rank0"][name], b["reference0"][name], 1, limit)

    # -- 15c. the Trainer at S = 2, then resume -----------------------------
    r0, r1 = a["rank0"]["trainer"], a["rank1"]["trainer"]
    losses = r0["losses"]
    log("spatial", f"15c: Trainer, RefineDet{SIZE} bf16, S = {sp} over 2 "
        f"ranks, batch {SPATIAL_TRAINER_BATCH}, {SPATIAL_TRAINER_STEPS} "
        f"steps: losses {[round(v, 4) for v in losses]}; rank 0's final "
        f"checkpoint written: {r0['checkpoint']}; resumed on both ranks: "
        f"step {r0['step']} / {r1['step']}, states equal to the trained "
        f"one: {r0['resumed'] == r1['resumed'] == r0['digest']}")
    check(len(losses) == SPATIAL_TRAINER_STEPS
          and all(np.isfinite(losses)) and r1["losses"] == []
          and r0["checkpoint"] and r0["digest"] == r1["digest"]
          and r0["resumed"] == r1["resumed"] == r0["digest"]
          and r0["step"] == r1["step"] == SPATIAL_TRAINER_STEPS,
          "15c: the spatial Trainer or its resume failed")
    out["trainer_losses"] = losses

    # -- 15d. what spatial sharding buys, and what it moves ------------------
    launched = {}
    for results in (a, b):
        for jobs in results.values():
            for job in jobs.values():
                for k, v in job.get("launches", {}).items():
                    launched[k] = launched.get(k, 0) + v
    check(set(launched) == {"nms_sweep", "int8_conv", "int8_quantize"}
          and not any(launched.values()),
          f"15: hand-written kernels launched: {launched}")
    gib = 2.0 ** 30
    peaks = [a[f"rank{i}"]["mem896"]["peak_bytes"] / gib for i in range(sp)]
    one_peak = ref["mem896"]["peak_bytes"] / gib
    traffic = {name: a["rank0"][name]["traffic"]
               for name in ("mem896", "plain", "bn896")}
    log("spatial", f"15d: {smi}: RefineDet{BN_SIZE}-BN bf16 step at batch "
        f"{BN_BATCH}: peak memory {[round(v, 3) for v in peaks]} GiB a rank "
        f"at S = {sp} against {one_peak:.3f} GiB in one process")
    for name, t in traffic.items():
        log("spatial", f"15d: {smi}: {name} (S = {sp}): bytes a rank hands "
            f"all_reduce a step, forward and backward: halo {t['halo']}, "
            f"gather {t['gather']}")
    log("spatial", f"15d: {smi}: the 2-rank gloo step through the host, a "
        f"correctness run and not a scaling figure: RefineDet{SIZE} f32 at "
        f"S = {sp} {[round(v, 2) for v in a['rank0']['plain']['ms']]} ms, "
        f"one process {[round(v, 2) for v in ref['plain']['ms']]} ms; "
        f"RefineDet{BN_SIZE}-BN bf16 at batch {BN_BATCH} "
        f"{[round(v, 2) for v in a['rank0']['mem896']['ms']]} ms, one "
        f"process {[round(v, 2) for v in ref['mem896']['ms']]} ms (host "
        f"clock, synchronised); hand-written kernel launches in the "
        f"phase: {launched}")
    out.update(peak_gib=peaks, one_process_peak_gib=one_peak,
               traffic=traffic, launches=launched,
               step_ms=a["rank0"]["plain"]["ms"],
               reference_step_ms=ref["plain"]["ms"],
               mem896_step_ms=a["rank0"]["mem896"]["ms"],
               mem896_reference_ms=ref["mem896"]["ms"])
    return out


def as_dtype(model, dtype: torch.dtype):
    """A shallow copy of ``model`` sharing its net, run in ``dtype``."""
    other = copy.copy(model)
    other.dtype = dtype
    return other


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same bits (-0 and +0 differ, equal NaNs too)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(view), b.view(view))


def s2d_phase(dev: torch.device, smi: str, rng) -> tuple:
    """Phase 16: the space-to-depth stem twin, the slice max-pool
    backward, their two benches and the demo core on the card; returns
    its numbers and K1's launches on its paths (16a's serving, 16d)."""
    from refinedet_tpu_torch.config import VOC_MEANS
    from refinedet_tpu_torch.data import BaseTransform
    from refinedet_tpu_torch.models import (build_refinedet,
                                            fold_stem_state_dict, layers)
    from refinedet_tpu_torch.ops import nms_cuda
    from refinedet_tpu_torch.serve import make_serving_fn
    from refinedet_tpu_torch.serve.export import model_on
    from refinedet_tpu_torch.tools import (bench_pool_backward,
                                           bench_stem_s2d, demo)
    from refinedet_tpu_torch.tools.k1_bench import noise_images
    from refinedet_tpu_torch.tools.profile_train_step import train_setup
    from refinedet_tpu_torch.train import create_train_state, make_train_step

    out = {"card": smi}
    launches = 0

    # -- 16a. the stem twin against the standard model ----------------------
    for size in STEM_SIZES:
        m0 = build_refinedet("test", size, NUM_CLASSES, device=dev, seed=0)
        m1 = build_refinedet("test", size, NUM_CLASSES, device=dev, seed=0,
                             stem_s2d=True)
        x = torch.from_numpy(rng.uniform(-120, 130, (
            STEM_BATCH, size, size, 3)).astype(np.float32)).to(dev)
        for dtype, limit in ((torch.float32, STEM_F32_ATOL),
                             (torch.bfloat16, STEM_BF16_ATOL)):
            with torch.inference_mode():
                h0 = as_dtype(m0, dtype).raw_forward(x)
                h1 = as_dtype(m1, dtype).raw_forward(x)
            errs = [float((b - a).abs().max()) / max(1.0, float(
                a.abs().max())) for a, b in zip(h0, h1)]
            name = "f32" if dtype == torch.float32 else "bf16"
            out[f"heads_{size}_{name}"] = errs
            log("s2d", f"16a: RefineDet{size} stem_s2d twin against the "
                f"standard model, {name}, batch {STEM_BATCH}: raw heads' "
                f"max abs err over max(1, max |head|) "
                f"{[f'{e:.3g}' for e in errs]} (limit {limit:g})")
            check(max(errs) <= limit and all(
                bool(torch.isfinite(h).all()) for h in h1),
                f"16a: the {size} {name} twin's heads differ")
        if size != SIZE:
            del m0, m1
            continue
        # the detect path, loc heads damped as JAX's test damps them
        with torch.no_grad():
            for name, p in m0.net.named_parameters():
                if name.startswith(("arm_loc.", "odm_loc.")):
                    p.mul_(1e-3)
        m1.net.load_state_dict(fold_stem_state_dict(m0.net.state_dict()))
        with torch.inference_mode():
            b0, s0 = m0.apply(x)
            b1, s1 = m1.apply(x)
        box_err = float(((b1 - b0).abs() - 1e-4 * b0.abs()).max())
        score_err = float((s1 - s0).abs().max())
        out["detect_320_f32"] = {"boxes": box_err, "scores": score_err}
        log("s2d", f"16a: RefineDet{size} f32 detect path, loc heads x 1e-3: "
            f"boxes' |err| - 1e-4 |box| max {box_err:.3g} (limit 1e-3), "
            f"scores' max abs err {score_err:.3g} (limit "
            f"{STEM_SCORE_ATOL:g})")
        check(box_err <= 1e-3 and score_err <= STEM_SCORE_ATOL,
              "16a: the twin's detect path differs")
        # fused-NMS serving, bf16, through make_serving_fn, on 10e's heads:
        # the scores order the candidates alike in both nets
        separate_heads(m0, rng)
        m1.net.load_state_dict(fold_stem_state_dict(m0.net.state_dict()))
        imgs = noise_images(rng, STEM_SERVE_BATCH)
        fns = [make_serving_fn(as_dtype(m, torch.bfloat16), None,
                               fused_nms={}) for m in (m0, m1)]
        nms_cuda.nms_sweep.launches = 0
        d0, d1 = (fn(imgs) for fn in fns)
        served = nms_cuda.nms_sweep.launches
        launches += served
        matched, rows = matched_rows(d1, d0, STEM_SERVE_RTOL)
        out["serve_320_bf16"] = {"matched": matched, "rows": rows,
                                 "k1_launches": served}
        log("s2d", f"16a: fused-NMS serving, RefineDet{size} bf16, batch "
            f"{STEM_SERVE_BATCH}, separate_heads: {matched[0]} of "
            f"{rows[0]} twin rows and {matched[1]} of {rows[1]} standard "
            f"rows with a counterpart within rtol {STEM_SERVE_RTOL} (limit "
            f"{STEM_SERVE_MATCHED:.0%}); K1 launches {served}")
        check(served == 2 and min(rows) > 0
              and min(matched) >= STEM_SERVE_MATCHED * max(rows),
              "16a: the twin's served detections differ")
        del m0, m1, fns
    torch.cuda.empty_cache()

    # -- 16b. the slice backward against ATen's -----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    pool1 = (POOL_CHECK_BATCH, 64, SIZE, SIZE)
    cases = (("pool1", pool1, False, False), ("pool1, ties", pool1, False,
                                               True),
             ("odd, ceil mode, ties", (POOL_CHECK_BATCH, 256, 75, 75), True,
              True))
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, ceil, ties in cases:
            x = torch.randn(shape, generator=gen, device=dev)
            if ties:  # quantized values force ties inside the windows
                x = torch.round(x * 2) / 2
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            pool = layers.MaxPool2x2(ceil)
            with torch.no_grad():
                g = torch.randn(pool(x).shape, generator=gen, device=dev,
                                dtype=dtype)
            got = {}
            for mode in layers.POOL_BACKWARDS:
                xx = x.detach().clone().requires_grad_()
                with layers.pool_backward(mode):
                    y = pool(xx)
                y.backward(g)
                got[mode] = (y.detach(), xx.grad)
            (ya, ga), (yb, gb) = got.values()
            same = bitwise_equal(ya, yb) and bitwise_equal(ga, gb)
            log("s2d", f"16b: {label} {tuple(shape)} {dtype}, channels-last: "
                f"slice against ATen: output and gradient bitwise equal: "
                f"{same}; the slice gradient channels-last: "
                f"{gb.is_contiguous(memory_format=torch.channels_last)}")
            check(same and gb.is_contiguous(
                memory_format=torch.channels_last),
                f"16b: {label} {dtype}: the slice backward differs")
    del x, xx, y, g, got, ga, gb
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps = []
        for mode in ("select_scatter", "slice", "select_scatter"):
            model, opt, cfg, images, boxes, labels, valid = train_setup(
                POOL_STEP_BATCH, dev)
            step = make_train_step(model, opt, cfg)
            state = create_train_state(model, opt)
            with layers.pool_backward(mode):
                state, metrics = step(state, images, boxes, labels, valid)
            steps.append((metrics["loss"].detach(), [
                t.detach().clone() for p in model.net.parameters()
                for t in (p, opt.state[p]["momentum_buffer"])]))
            del model, opt, state, step
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def equal(a, b):
        return bitwise_equal(a[0], b[0]) and all(
            bitwise_equal(x, y) for x, y in zip(a[1], b[1]))

    repeat, across = equal(steps[0], steps[2]), equal(steps[0], steps[1])
    out["step_bitwise"] = across
    log("s2d", f"16b: RefineDet{SIZE} bf16 train step, batch "
        f"{POOL_STEP_BATCH}, cuDNN deterministic: ATen's step twice "
        f"bitwise equal: {repeat}; the slice step's loss "
        f"{float(steps[1][0]):.6f}, parameters and momentum against ATen's: "
        f"bitwise equal: {across}")
    check(repeat, "16b: the step is not deterministic; nothing to compare")
    check(across, "16b: the slice step differs from ATen's")
    del steps
    torch.cuda.empty_cache()

    # -- 16c. the two benches at their defaults -------------------------------
    for name, tool in (("bench_stem_s2d", bench_stem_s2d),
                       ("bench_pool_backward", bench_pool_backward)):
        log("s2d", f"16c: {name} at its defaults, {smi}")
        res = tool.main([])
        parts = {part: res[part] for part in ("results", "stems", "pools")
                 if part in res}
        check(all(ms > 0 and np.isfinite(ms) for runs in parts.values()
                  for r in runs.values() for ms in r["ms"]),
              f"16c: {name} timed nothing")
        out[name] = {part: {k: {"ms": r["ms"], "peak_gib": [
            b / 2 ** 30 for b in r["peak_bytes"]]} for k, r in runs.items()}
            for part, runs in parts.items()}
        out[name]["pools_bound_ms"] = res.get("pools_bound_ms")
        torch.cuda.empty_cache()

    # -- 16d. the demo core on the card against the CPU -----------------------
    model = build_refinedet("test", SIZE, NUM_CLASSES, device=dev, seed=0)
    separate_heads(model, rng)
    host = model_on(model, "cpu")
    img = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)  # BGR
    x = BaseTransform(SIZE, VOC_MEANS)(img)[None]
    nms_cuda.nms_sweep.launches = 0
    rows = demo.detect_image(model, img, DEMO_THRESHOLD)
    card = demo.detections(model, x)
    shown = nms_cuda.nms_sweep.launches
    launches += shown
    cpu = demo.detections(host, x)
    drawn = []
    for d in (card, cpu):  # the rows detect_image keeps, score last
        d = np.roll(d[:, 1:], -1, axis=-1)
        d[d[..., 4] < DEMO_THRESHOLD] = 0.0
        drawn.append(d)
    matched, kept = matched_rows(*drawn, DETS_CARD_CPU_RTOL)
    out["demo"] = {"rows": len(rows), "matched": matched, "kept": kept,
                   "k1_launches": shown}
    log("s2d", f"16d: demo.detect_image on a {SIZE}x{SIZE} BGR uint8 image, "
        f"f32, threshold {DEMO_THRESHOLD}: {len(rows)} rows; card against "
        f"CPU, same weights: {matched[0]} of {kept[0]} card rows and "
        f"{matched[1]} of {kept[1]} CPU rows matched within rtol "
        f"{DETS_CARD_CPU_RTOL}; K1 launches {shown}")
    check(shown == 2 and len(rows) == kept[0] > 0
          and min(matched) >= 0.99 * max(kept),
          "16d: the demo's rows on the card differ from the CPU's")
    del model, host
    torch.cuda.empty_cache()
    return out, launches


def epilogue_phase(dev: torch.device, smi: str) -> tuple:
    """Phase 17: the convolution epilogue at each cell's fused convs."""
    from refinedet_tpu_torch.ops import conv_epilogue
    from refinedet_tpu_torch.quant.ptq import DEFAULT_QUANT_SKIP
    from refinedet_tpu_torch.tools import epilogue_bench

    cells = {"ssdd512-detect-b16": (512, 2, 16, None),
             "voc320-train-b64": (320, 21, 64, None),
             "voc320-int8-detect-b32": (320, 21, 32, DEFAULT_QUANT_SKIP)}
    g = torch.Generator(dev).manual_seed(17)
    out, compared, worst = {}, 0, 0.0
    for cell, (size, classes, batch, skip) in cells.items():
        shapes = epilogue_bench.fused_shapes(size, classes, batch,
                                             quant_skip=skip)
        for sh in epilogue_bench.distinct(shapes):
            geom = (sh["stride"], sh["padding"], sh["dilation"])
            x, w, b = epilogue_bench.conv_inputs(sh, g, dev)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = conv_epilogue.conv_bias_relu(x, w, b, *geom)
                want = torch.nn.functional.conv2d(x, w, b, *geom).relu_()
            check(bitwise_equal(got, want),
                  f"17a {cell}: conv_bias_relu at {sh} is not aten's")
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            compared += 1
            del x, w, got, want
        t = epilogue_bench.time_ms(shapes)
        large = [sh for sh in shapes
                 if 2 * torch.Size(sh["y"]).numel() >= EPILOGUE_LARGE_BYTES]
        t_large = epilogue_bench.time_ms(large)
        t["large"] = dict(t_large, count=len(large),
                          share=100.0 * t_large["bound_ms"] / t_large["ms"])
        y, bias = epilogue_bench.outputs(shapes[-1:], torch.bfloat16, dev)[0]
        host_us = 1e3 * host_issue_ms(
            lambda: conv_epilogue.bias_relu_(y, bias), 200)
        t.update(cell=cell, share=100.0 * t["bound_ms"] / t["ms"],
                 host_us=host_us)
        out[cell] = t
        log("epilogue", f"{smi} | {cell}: {t['launches']} fused convs, "
            f"{t['bytes'] / 1e9:.3f} GB; epilogue {t['ms']:.4f} ms, "
            f"{t['share']:.1f}% of its {t['bound_ms']:.4f} ms bound; aten "
            f"add_ + relu_ {t['library_ms']:.4f} ms; wrapper "
            f"{host_us:.1f} us a call (host); its {len(large)} outputs of "
            f"64 MiB or more: {t_large['ms']:.4f} ms, "
            f"{t['large']['share']:.1f}% of {t_large['bound_ms']:.4f} ms")
        torch.cuda.empty_cache()
    log("epilogue", f"17a: {compared} distinct shapes bitwise aten's (max "
        f"abs err {worst:g})")
    launches = sum(EPILOGUE_PATHS.values())
    log("epilogue", f"launches on the main paths: {launches} "
        f"({json.dumps(EPILOGUE_PATHS)})")
    entry = {"name": "conv_bias_relu", "route": "cuda",
             "source": "refinedet_tpu_torch/csrc/conv_epilogue.cu",
             "replaces": "aten's bias add inside _convolution and the ReLU "
                         "after it (XLA fuses both into the conv)",
             "launches": launches,
             "max_abs_err": worst,
             "ms": {c: t["ms"] for c, t in out.items()},
             "plain_ms": None,
             "bound_ms": {c: t["bound_ms"] for c, t in out.items()},
             "bound_by": "bytes",
             "library_ms": {c: t["library_ms"] for c, t in out.items()}}
    return out, entry


def time_sweep(cand, valid, label, thresh, plus_one=False):
    """K1's device ms per launch and the plain version's ms on these
    candidates at IoU ``thresh``, and K1's bound."""
    from refinedet_tpu_torch.ops import nms_cuda
    from refinedet_tpu_torch.ops.nms import nms_sweep_reference
    from refinedet_tpu_torch.tools.k1_bench import graph_ms

    g, k = valid.shape
    with torch.inference_mode():
        ms = graph_ms(lambda: nms_cuda.nms_sweep(
            cand, valid, thresh, plus_one))
        plain = cuda_ms(lambda: nms_sweep_reference(
            cand, valid, thresh, plus_one), 3, warmup=1)
        keep = nms_cuda.nms_sweep(cand, valid, thresh, plus_one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            nms_cuda.nms_sweep(cand, valid, thresh, plus_one)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    kept_g = keep.sum(1).double()
    valid_g = valid.sum(1).double()
    kept = int(kept_g.sum())
    nbytes = g * k * (16 + 1 + 1)  # boxes + valid in, keep out
    # The least greedy NMS can test: each kept column against every
    # earlier kept row, each suppressed column at least once.
    tests = int((kept_g * (kept_g - 1) / 2 + (valid_g - kept_g)).sum())
    ops = IOU_OPS * tests
    all_ops = IOU_OPS * kept * k  # every column against every kept row
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    all_bound = max(bytes_ms, all_ops / H100_F32_OPS_PER_S * 1e3)
    log("time", f"K1 {label} G={g} K={k}: {ms:.4f} ms a launch (device, "
        f"graph of 50); plain {plain:.3f} ms; kept {kept}; bound "
        f"{max(bytes_ms, ops_ms):.6f} ms ({nbytes} B, {tests} IoU "
        f"tests, {ops} ops); counting every column against every kept "
        f"row: {all_bound:.6f} ms ({all_ops} ops)")
    log("time", f"K1 {label} wrapper: {host_us:.1f} us host time a call "
        f"(checks, allocation, ctypes launch)")
    return ms, plain, max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs "
              "one card", file=sys.stderr)
        return 1

    from refinedet_tpu_torch.models import build_refinedet
    from refinedet_tpu_torch.ops import conv_epilogue, int8_conv, nms_cuda
    from refinedet_tpu_torch.ops.nms import nms_sweep_reference
    from refinedet_tpu_torch.serve import (BatchingEngine, Server,
                                           make_serving_fn)
    from refinedet_tpu_torch.serve.export import (fused_nms_settings,
                                                  fused_postprocess)
    from refinedet_tpu_torch.tools.k1_bench import (graph_ms, noise_images,
                                                    serving_candidates,
                                                    uniform_candidates)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{count}")
    log("device", f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    # the kernels' builds, one nvcc each, started together
    t0 = time.perf_counter()
    builds = {}
    threads = [threading.Thread(target=lambda n=n, f=f: builds.__setitem__(
        n, f())) for n, f in (("K1", nms_cuda.load_kernel),
                              ("int8_conv", int8_conv.load_kernel),
                              ("conv_epilogue", conv_epilogue.load_kernel))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(set(builds) == {"K1", "int8_conv", "conv_epilogue"},
          f"builds: {sorted(builds)}")
    kernel = builds["K1"]
    log("device", f"kernels built in {time.perf_counter() - t0:.2f} s")
    log("device", f"K1 built in {kernel.build_seconds:.2f} s -> "
        f"{kernel.path.name} (max K {kernel.max_k})")
    for line in kernel.build_log.splitlines():
        log("device", f"  {line}")
    for name in ("int8_conv", "conv_epilogue"):
        lib = builds[name]
        log("device", f"{name} built in {lib.build_seconds:.2f} s -> "
            f"{lib.path.name}")
        for line in lib.build_log.splitlines():
            log("device", f"  {line}")

    # -- 2. K1 against its plain version ------------------------------------
    model = build_refinedet("test", SIZE, NUM_CLASSES, device=dev, seed=0)
    check(model.priors.shape == (6375, 4), f"priors {model.priors.shape}")
    opts = fused_nms_settings(NUM_CLASSES, {})
    mismatches, compared, max_err = 0, 0, 0.0

    def compare(boxes, valid, plus_one, label):
        nonlocal mismatches, compared, max_err
        got = nms_cuda.nms_sweep(boxes, valid, opts.nms_thresh, plus_one)
        want = nms_sweep_reference(boxes, valid, opts.nms_thresh, plus_one)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        mismatches += bad
        compared += 1
        max_err = max(max_err, float(bad > 0))  # |keep - keep'| of 0/1
        log("k1", f"{label} G={boxes.shape[0]} K={boxes.shape[1]} "
            f"plus_one={plus_one}: kept {int(got.sum())}, "
            f"mismatches {bad}")

    with torch.inference_mode():
        for name, imgs in (("noise", noise_images(rng, SERVE_BATCH)),
                           ("randn", rng.randn(SERVE_BATCH, SIZE, SIZE, 3)
                            .astype(np.float32))):
            cands = serving_candidates(model, imgs,
                                       (NMS_TOP_K, 256, DETECT_TOP_K),
                                       opts.conf_thresh)
            for top_k, (cand, valid) in cands.items():
                for plus_one in (False, True):
                    # +1 areas are pixel-space: scale to the image first.
                    b = cand * SIZE if plus_one else cand
                    compare(b, valid, plus_one, f"model/{name}")
                if name == "noise" and top_k == NMS_TOP_K:
                    serve_cand, serve_valid = cand, valid  # timed in 5.
                elif name == "noise" and top_k == DETECT_TOP_K:
                    detect_cand, detect_valid = cand, valid
        shapes = [("uniform", 20 * SERVE_BATCH, 256),
                  ("uniform", 20 * 8, 1024)]
        shapes += [("ragged", 1, k) for k in RAGGED_K]
        shapes += [("limit", LIMIT_GROUPS, kernel.max_k)]
        for label, g, k in shapes:
            for plus_one in (False, True):
                b, valid = uniform_candidates(g, k, 0.8, seed=g + k,
                                              scale=SIZE if plus_one else 1.0)
                compare(b, valid, plus_one, label)
        same = torch.tensor([10.0, 10.0, 50.0, 60.0], device=dev).expand(
            4, 256, 4).contiguous()
        zero = torch.tensor([5.0, 5.0, 5.0, 5.0], device=dev).expand(
            4, 256, 4).contiguous()
        # widths of -0 and +0: the plain version's + 0.0 makes them +0
        signed = torch.tensor([[-0.0, -0.0, 0.0, 0.0], [0.0, 0.0, -0.0, 1.0],
                               [-0.0, 0.0, 1.0, -0.0], [0.0, -0.0, 0.0, 2.0]],
                              device=dev).repeat(4, 64, 1)
        idx = torch.arange(256, device=dev)
        masks = {"all": torch.ones(4, 256, dtype=torch.bool, device=dev),
                 "none": torch.zeros(4, 256, dtype=torch.bool, device=dev),
                 "sparse": (idx % 7 == 3).expand(4, 256).contiguous()}
        for bname, b in (("identical", same), ("zero-area", zero),
                         ("signed-zero", signed)):
            for mname, m in masks.items():
                for plus_one in (False, True):
                    compare(b, m, plus_one, f"edge/{bname}/{mname}")
        one = nms_cuda.nms_sweep(same, masks["all"], 0.45)
        check(int(one.sum()) == 4 and bool(one[:, 0].all()),
              "identical boxes must keep exactly the first of each group")
    check(mismatches == 0, f"K1 disagrees with its plain version in "
          f"{mismatches} entries")
    log("k1", f"{compared} comparisons, all keep masks equal")

    # -- 3. the serving slice -------------------------------------------------
    fn = make_serving_fn(model, None, fused_nms={})
    for b in (1, 2, 4, 8):  # warm every bucket: cuDNN picks per shape
        fn(np.zeros((b, SIZE, SIZE, 3), np.float32))
    engine = BatchingEngine(fn, (SIZE, SIZE, 3), max_batch=MAX_BATCH,
                            max_delay_ms=20.0)
    server = Server(engine, {"format": "refinedet-tpu-torch-serving",
                             "input_size": SIZE,
                             "num_classes": NUM_CLASSES})
    requests = noise_images(rng, ENGINE_REQUESTS + HTTP_REQUESTS)
    results, stats, launches = serve_requests(engine, server, requests,
                                              "serve")
    n_req = ENGINE_REQUESTS + HTTP_REQUESTS
    kept = int(sum((d[..., 4] > 0).sum() for d in results.values()))
    check(launches >= stats["batches"] > 0,
          f"K1 launched {launches} times for {stats['batches']} batches")
    count_epilogue("3 serve", launches)  # a forward and a K1 launch a call
    log("serve", f"{n_req} requests ({HTTP_REQUESTS} over HTTP) in "
        f"{stats['batches']} device batches, 0 errors, {kept} detections; "
        f"K1 launches {launches}")

    # -- 4. kernel path against plain path, same heads -----------------------
    imgs = noise_images(rng, SERVE_BATCH)
    x = torch.from_numpy(imgs).to(dev)
    with torch.inference_mode():
        heads = model.raw_forward(x)
        dets_k = fused_postprocess(heads, model.priors, opts)
        dets_p = fused_postprocess(heads, model.priors, opts, plain=True)
        check(torch.equal(dets_k, dets_p),
              "kernel-path and plain-path detections differ")
        log("e2e", f"kernel and plain post-process equal on the same heads "
            f"({int((dets_k[..., 4] > 0).sum())} detections, batch "
            f"{SERVE_BATCH})")
        cpu_model = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu",
                                    seed=0)
        small = torch.from_numpy(rng.randn(1, SIZE, SIZE, 3).astype(
            np.float32))
        h_cpu = cpu_model.raw_forward(small)
        h_gpu = model.raw_forward(small.to(dev))
        worst = 0.0
        for a, b in zip(h_cpu, h_gpu):
            err = float((b.cpu() - a).abs().max())
            scale = float(a.abs().max())
            worst = max(worst, err / scale)
            # cuDNN and oneDNN sum in different orders.
            check(err <= 1e-4 * scale, f"card vs CPU heads: max abs err "
                  f"{err} for max |head| {scale}")
        log("e2e", f"f32 heads on the card match the CPU's: max abs err "
            f"{worst:.3g} of max |head| (limit 1e-4)")
    check(all(bool(torch.isfinite(h).all()) for h in heads),
          "non-finite heads")

    # -- 5. timings ----------------------------------------------------------
    k1_ms, plain_ms, bound_ms, bound_by = time_sweep(
        serve_cand, serve_valid, "serving", opts.nms_thresh)
    k1_detect, plain_detect, bound_detect, _ = time_sweep(
        detect_cand, detect_valid, "detect", opts.nms_thresh)

    timings = {"k1_serve_ms": k1_ms, "plain_serve_ms": plain_ms,
               "bound_serve_ms": bound_ms, "k1_detect_ms": k1_detect,
               "plain_detect_ms": plain_detect,
               "bound_detect_ms": bound_detect}
    for dtype in (torch.float32, torch.bfloat16):
        m = model if dtype == torch.float32 else build_refinedet(
            "test", SIZE, NUM_CLASSES, device=dev, dtype=dtype, seed=0)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: m.raw_forward(x), 10)
            h = m.raw_forward(x)
            post = cuda_ms(lambda: fused_postprocess(h, m.priors, opts), 10)
        serve_fn = make_serving_fn(m, None, fused_nms={})
        before = nms_cuda.nms_sweep.launches
        e2e = host_ms(lambda: serve_fn(imgs), 10)
        per_call = (nms_cuda.nms_sweep.launches - before) / 12
        name = "f32" if dtype == torch.float32 else "bf16"
        timings[f"forward_{name}_ms"] = fwd
        timings[f"postprocess_{name}_ms"] = post
        timings[f"serve_{name}_ms"] = e2e
        log("time", f"{name}: forward {fwd:.2f} ms, fused post-process "
            f"{post:.2f} ms, end-to-end serving {e2e:.2f} ms per batch of "
            f"{SERVE_BATCH}; K1 launches per batch {per_call:g}")
        check(per_call == 1, f"expected one K1 launch per batch, got "
              f"{per_call}")
    log("time", "library_ms: n/a, no single PyTorch call computes greedy "
        "NMS (torchvision is absent, and its NMS would be a library "
        "kernel)")
    print(json.dumps({"timings": timings}), flush=True)

    # -- 6. the training slice ----------------------------------------------
    del model, m, serve_fn, fn, engine, server, heads, h
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as folder:
        nms_cuda.nms_sweep.launches = 0
        train = train_phase(dev, folder)
        check(nms_cuda.nms_sweep.launches == 0,
              "the training path launched K1")
        log("train", "K1 launches on the training path: 0")
        print(json.dumps({"train": train}), flush=True)

        # -- 7. the eval slice -----------------------------------------------
        torch.cuda.empty_cache()
        log("eval", smi)
        t7 = time.perf_counter()
        evals, eval_launches = eval_phase(dev, folder)
        log("time", f"phase 7 took {time.perf_counter() - t7:.1f} s")
    launches += eval_launches
    print(json.dumps({"eval": evals}), flush=True)

    # -- 8. the BN variant and RefineDet896 ---------------------------------
    t8 = time.perf_counter()
    bn, bn_launches = bn_phase(dev, rng)
    launches += bn_launches
    log("time", f"phase 8 took {time.perf_counter() - t8:.1f} s")
    print(json.dumps({"bn": bn}), flush=True)

    # -- 9. on-device augmentation -------------------------------------------
    t9 = time.perf_counter()
    nms_cuda.nms_sweep.launches = 0
    augmented = augment_phase(dev, smi, train["bf16"])
    check(nms_cuda.nms_sweep.launches == 0,
          "the augmented training path launched K1")
    log("aug", "K1 launches on the augmented training path: 0")
    log("time", f"phase 9 took {time.perf_counter() - t9:.1f} s")
    print(json.dumps({"augment": augmented}), flush=True)

    # -- 10. the serving artifact ---------------------------------------------
    t10 = time.perf_counter()
    artifact, artifact_launches = artifact_phase(dev, smi, rng)
    launches += artifact_launches
    log("time", f"phase 10 took {time.perf_counter() - t10:.1f} s")
    print(json.dumps({"artifact": artifact}), flush=True)

    # -- 11. int8 PTQ ----------------------------------------------------------
    t11 = time.perf_counter()
    int8, _, int8_k1, int8_entries = int8_phase(dev, smi, rng)
    launches += int8_k1
    log("time", f"phase 11 took {time.perf_counter() - t11:.1f} s")
    print(json.dumps({"int8": int8}), flush=True)

    # -- 12. data parallelism ---------------------------------------------
    t12 = time.perf_counter()
    ddp, ddp_k1 = ddp_phase(dev, smi)
    launches += ddp_k1
    log("time", f"phase 12 took {time.perf_counter() - t12:.1f} s")
    print(json.dumps({"ddp": ddp}), flush=True)

    # -- 13. the trained-fixture tools ----------------------------------------
    t13 = time.perf_counter()
    log("tools", smi)
    tools, tools_launches = tools_phase(dev)
    launches += tools_launches[0]
    for entry, n in zip(int8_entries, tools_launches[1:]):
        entry["launches"] += n
    log("time", f"phase 13 took {time.perf_counter() - t13:.1f} s")
    print(json.dumps({"tools": tools}), flush=True)

    # -- 14. profiling on the card ----------------------------------------
    t14 = time.perf_counter()
    profiled, profile_launches = profile_phase(dev, smi, rng)
    launches += profile_launches[0]
    for entry, n in zip(int8_entries, profile_launches[1:]):
        entry["launches"] += n
    log("time", f"phase 14 took {time.perf_counter() - t14:.1f} s")
    print(json.dumps({"profile": profiled}), flush=True)

    # -- 15. spatial sharding -------------------------------------------------
    t15 = time.perf_counter()
    spatial = spatial_phase(dev, smi)
    log("time", f"phase 15 took {time.perf_counter() - t15:.1f} s")
    print(json.dumps({"spatial": spatial}), flush=True)

    # -- 16. the stem twin, the slice backward, the benches, the demo --------
    t16 = time.perf_counter()
    s2d, s2d_launches = s2d_phase(dev, smi, rng)
    launches += s2d_launches
    log("time", f"phase 16 took {time.perf_counter() - t16:.1f} s")
    print(json.dumps({"s2d": s2d}), flush=True)

    # -- 17. the convolution epilogue -----------------------------------------
    t17 = time.perf_counter()
    epilogue, epilogue_entry = epilogue_phase(dev, smi)
    log("time", f"phase 17 took {time.perf_counter() - t17:.1f} s")
    log("time", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"epilogue": epilogue}), flush=True)

    print(json.dumps({"kernels": [{
        "name": "nms_sweep",
        "route": "cuda",
        "source": "refinedet_tpu_torch/csrc/nms_sweep.cu",
        "replaces": "refinedet_tpu/ops/nms_pallas.py:40",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, *int8_entries, epilogue_entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
