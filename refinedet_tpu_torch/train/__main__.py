"""RefineDet training CLI: ``python -m refinedet_tpu_torch.train``.

The flags and defaults of the JAX package's ``train_refinedet.py`` (the
reference's ``train_refinedet.py``), plus ``--device`` (the card unless
``--device cpu``). Flow: dataset + SSDAugmentation on the host, or with
``--on_device_augment`` (or ``--staging_size``) a StagingTransform to a
uint8 canvas of ``--staging_size`` (default twice the input size) and the
SSD chain on the card inside the step -> build_refinedet (plain or
``--bn``, 320/512/896) -> optional pretrained backbone or full net ->
Trainer (warmup + step lr, SGD with momentum and weight decay, checkpoints
every 10 epochs, 5 after 200) -> ``<save_folder>/log.txt`` in the
reference's log format -> ``<save_folder>/loss_curve.png``, and with
``--visdom`` ``<save_folder>/live_loss.png`` while it trains.

Several GPUs: ``--ngpu N`` (default: every visible GPU; one with
``--device cpu``) starts N ranks on this host, one process on one device
each (gloo ranks with ``--device cpu``); under ``torchrun`` the
launcher's environment gives the ranks instead. ``--batch_size`` is the
global batch; rank 0 writes the log, the checkpoints and the plots.
``--spatial_shards S`` lays the N ranks out as N // S data-parallel
groups of S ranks, each holding a band of every image's rows
(``parallel/spatial.py``); N must divide by S and the batch by N // S,
checked before anything is written or started.
"""

from __future__ import annotations

import argparse
import importlib
import os
from typing import Dict, List, Optional

import torch

from refinedet_tpu_torch import config as C
from refinedet_tpu_torch.config import TrainConfig
from refinedet_tpu_torch.data import (COCODetection, SSDAugmentation,
                                      VOCDetection)
from refinedet_tpu_torch.data.augment import StagingTransform
from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.models import RefineDet, build_refinedet
from refinedet_tpu_torch.models.convert import module_names
from refinedet_tpu_torch.parallel import distributed
from refinedet_tpu_torch.parallel.mesh import check_grid
from refinedet_tpu_torch.train.checkpoints import CheckpointManager
from refinedet_tpu_torch.train.trainer import Trainer
from refinedet_tpu_torch.utils import logger as log_util
from refinedet_tpu_torch.utils.plot import LivePlotter, plot_loss


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="RefineDet training (PyTorch/CUDA port)")
    p.add_argument("--dataset", default="COCO", choices=["VOC", "COCO"])
    p.add_argument("--input_size", default="512",
                   choices=["320", "512", "896"],
                   help="896 is the five-source large-input variant")
    p.add_argument("--dataset_root", default=None,
                   help="VOCdevkit or SSDD_coco root")
    p.add_argument("--basenet", default=None,
                   help="pretrained VGG .pth (vgg16_reducedfc), or a full "
                        "plain RefineDet .pth")
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume from")
    p.add_argument("--resume_epoch", default=0, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--worker_processes", action="store_true",
                   help="load/augment in spawned worker processes instead "
                        "of threads")
    p.add_argument("--lr", "--learning-rate", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--gamma", default=0.1, type=float)
    p.add_argument("--max_epoch", default=300, type=int)
    p.add_argument("--ngpu", default=None, type=int,
                   help="data-parallel ranks started on this host, one "
                        "per device (default: every visible GPU; 1 with "
                        "--device cpu); under torchrun the launcher's")
    p.add_argument("--save_folder", default="weights/")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--bn", action="store_true",
                   help="use the BatchNorm model variant")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the convolutions")
    p.add_argument("--on_device_augment", action="store_true",
                   help="run the SSD augmentation on the device")
    p.add_argument("--staging_size", default=0, type=int,
                   help="staging canvas of the on-device augmentation "
                        "(0 = twice the input size); setting it turns "
                        "that augmentation on")
    p.add_argument("--grad_clip", default=0.0, type=float)
    p.add_argument("--ema_decay", default=0.0, type=float,
                   help="keep an EMA of the weights for serving (0 = off); "
                        "checkpoints then carry it")
    p.add_argument("--spatial_shards", default=1, type=int,
                   help="shard image height over devices (devices = "
                        "data_parallel x spatial_shards); for very large "
                        "inputs, e.g. the 896 variant")
    p.add_argument("--visdom", "--live_plot", dest="live_plot",
                   action="store_true",
                   help="live loss plot, <save_folder>/live_loss.png")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def load_basenet(net: RefineDet, path: str) -> None:
    """Load pretrained weights by layer name, as the JAX package's
    ``torch_import.load_weights`` does, into either variant:

    * a full plain RefineDet ``.pth`` (``vgg.`` keys) gives every layer
      the JAX importer reads (trunk, extras, L2Norms, four sources' heads
      and TCB);
    * a ``vgg16_reducedfc`` file (a bare plain VGG ModuleList state_dict,
      ``0.weight`` ... ``33.bias``) gives the 15 trunk convs.

    BN layers keep their values. A layer the file lacks raises
    ``RuntimeError`` and a shape that differs from the net's raises
    ``ValueError``; the net is left unchanged then."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    # the file's layers, by Flax name: a plain four-source net's
    sources = module_names()
    if not any(k.startswith("vgg.") for k in state):  # a bare VGG list
        sources = {k: (m[len("vgg."):], kind)
                   for k, (m, kind) in sources.items()
                   if m.startswith("vgg.")}
    targets = module_names(net.use_bn, len(net.arm_loc))
    own = net.state_dict()
    loaded: Dict[str, torch.Tensor] = {}
    for flax_name, (src, kind) in sources.items():
        params = ("weight",) if kind == "l2norm" else ("weight", "bias")
        missing = [f"{src}.{p}" for p in params if f"{src}.{p}" not in state]
        if missing:
            raise RuntimeError(f"{path}: Missing key(s) {missing}")
        for p in params:
            dst = f"{targets[flax_name][0]}.{p}"
            got = state[f"{src}.{p}"]
            if own[dst].shape != got.shape:
                raise ValueError(
                    f"shape mismatch importing {flax_name}: {src}.{p} "
                    f"{tuple(got.shape)} vs the net's {tuple(own[dst].shape)}")
            loaded[dst] = got
    net.load_state_dict({**own, **loaded}, strict=True)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
    ngpu = args.ngpu
    if ngpu is None:
        ngpu = 1 if backend == "gloo" else torch.cuda.device_count()
    world = int(os.environ["WORLD_SIZE"]) if distributed.env_rendezvous() \
        else ngpu
    check_grid(max(world, 1), args.spatial_shards, args.batch_size)
    if ngpu > 1 and not distributed.env_rendezvous():
        # The ranks unpickle ``train`` by module: this one under its own
        # name, since the ``__main__`` of ``python -m`` is not importable.
        rank_train = importlib.import_module(__spec__.name).train
        distributed.spawn(rank_train, ngpu, (args,), backend)
        return
    grouped = distributed.maybe_initialize(backend=backend)  # torchrun
    try:
        train(args)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


def train(args: argparse.Namespace) -> None:
    """Build, train and plot in this process: the whole run, or this
    rank's part of it under an initialised process group."""
    if distributed.default_group() is not None:
        device = distributed.local_device(torch.device(args.device).type)
    else:
        device = resolve_device(args.device)
    lead = distributed.process_index() == 0
    say = print if lead else (lambda *a: None)
    if lead:
        os.makedirs(args.save_folder, exist_ok=True)
        log_util.install(os.path.join(args.save_folder, "log.txt"))

    size = int(args.input_size)
    means = C.VOC_MEANS if args.dataset == "VOC" else C.MEANS
    on_device = args.on_device_augment or args.staging_size > 0
    if on_device:
        transform = StagingTransform(args.staging_size or 2 * size)
    else:
        transform = SSDAugmentation(size, means)
    if args.dataset == "VOC":
        root = args.dataset_root or C.VOC_ROOT
        dataset = VOCDetection(root, transform=transform, seed=args.seed)
        num_classes = 21
    else:
        root = args.dataset_root or C.COCOroot
        dataset = COCODetection(root, [("sarship", "train")], transform,
                                seed=args.seed)
        num_classes = dataset.num_classes

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_refinedet("train", size, num_classes, use_bn=args.bn,
                            dtype=dtype, device=device, seed=args.seed)
    cfg = TrainConfig(
        batch_size=args.batch_size, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, gamma=args.gamma,
        max_epoch=args.max_epoch, num_workers=args.num_workers,
        worker_processes=args.worker_processes, seed=args.seed,
        grad_clip_norm=args.grad_clip, ema_decay=args.ema_decay,
        on_device_augment=on_device, mean=tuple(means),
        spatial_shards=args.spatial_shards)
    live = LivePlotter(args.save_folder) if args.live_plot and lead \
        else None
    trainer = Trainer(model, dataset, cfg, save_folder=args.save_folder,
                      dataset_name=args.dataset, live_plotter=live)

    start_epoch = 0
    state = None
    if args.resume_epoch > 0:
        state = trainer.resume(args.resume_epoch)
        start_epoch = args.resume_epoch
        say(f"resumed from epoch {start_epoch}")
    elif args.resume:
        state = trainer.load_state(
            CheckpointManager.restore_path(args.resume), args.resume)
        start_epoch = state.step // trainer.epoch_size
        say(f"resumed from {args.resume} (epoch {start_epoch})")
    elif args.basenet:
        load_basenet(model.net, args.basenet)
        state = trainer.init_state()  # the EMA starts from these weights
        say(f"loaded pretrained backbone from {args.basenet}")

    say("Loading the dataset...")
    say(f"Training RefineDet{size} on {dataset.name} ({len(dataset)} "
        f"images, {model.device}, {distributed.process_count()} rank(s))")
    trainer.train(state, start_epoch=start_epoch)
    if lead:
        plot_loss(os.path.join(args.save_folder, "log.txt"),
                  os.path.join(args.save_folder, "loss_curve.png"))


if __name__ == "__main__":
    main()
