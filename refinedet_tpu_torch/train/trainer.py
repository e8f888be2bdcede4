"""High-level training loop, on one device or data-parallel.

Port of ``refinedet_tpu/train/trainer.py``: the epoch loop over the
prefetching loader, warmup + step lr, per-iteration loss logging in the
reference's log line format, epoch checkpoints (every 10, every 5 after
epoch 200), resume, and a preemption checkpoint on SIGTERM/SIGINT, and an
optional live loss plot. The loader's producer thread checks the targets
and stages each batch on the device (uint8 staged images stay uint8); the
loop only launches steps and logs.

Under an initialised process group (``parallel.distributed``), each rank
runs this loop on its device: ``batch_size`` is the global batch, each
rank loads its shard of the data (``batch_size // world`` rows a step),
the state starts as rank 0's, and rank 0 alone writes checkpoints, log
lines and the live plot. With ``spatial_shards`` S the W ranks form the
``(W // S, S)`` grid of ``parallel.mesh.make_grid``: the data shards go
by data index (``batch_size // (W // S)`` rows a step, the same rows on
every space rank of a data group), and the step takes each rank's band
of image rows.
"""

from __future__ import annotations

import datetime
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from refinedet_tpu_torch.config import TrainConfig
from refinedet_tpu_torch.data.loader import DataLoader, DeviceStager
from refinedet_tpu_torch.parallel import distributed, replicate
from refinedet_tpu_torch.parallel.mesh import check_grid, grid_position
from refinedet_tpu_torch.train.checkpoints import CheckpointManager
from refinedet_tpu_torch.train.schedule import make_lr_schedule
from refinedet_tpu_torch.train.train_step import (TrainState,
                                                  create_train_state,
                                                  ema_copy, make_optimizer,
                                                  make_train_step)


class Trainer:
    """Trains ``model`` (a train-phase RefineDetModel, on its device: under
    a process group, the rank's ``distributed.local_device``) on
    ``dataset`` (``dataset[i]`` -> (image, boxes, labels))."""

    def __init__(self, model, dataset, train_cfg: TrainConfig,
                 save_folder: Optional[str] = None,
                 dataset_name: str = "COCO",
                 log_fn: Callable[[str], None] = print,
                 live_plotter=None):
        """``live_plotter`` (a ``utils.plot.LivePlotter``, or None) gets
        every logged step's losses and each epoch's end."""
        self.group = distributed.default_group()
        self.rank = distributed.process_index()
        world = distributed.process_count()
        shards = max(1, train_cfg.spatial_shards)
        check_grid(world, shards, train_cfg.batch_size)
        data_index, _ = grid_position(self.rank, shards)
        data_world = world // shards
        self.model = model
        self.cfg = train_cfg
        self.dataset = dataset
        lead = self.rank == 0
        self.log = log_fn if lead else (lambda line: None)
        self.live_plotter = live_plotter if lead else None
        self._preempted = False
        # The stop flag is all-reduced on the host, over gloo, so that no
        # rank waits for its card at a step boundary.
        self._control = None
        if self.group is not None:
            self._control = (self.group if dist.get_backend(self.group)
                             == "gloo" else dist.new_group(backend="gloo"))

        # Target validation and the copy to the device both run in the
        # loader's producer thread: the guard sees host arrays, and the
        # copy overlaps the previous step.
        stager = DeviceStager(model.device)

        def stage(batch):
            self._validate_batch(batch)
            return stager(batch)

        self.loader = DataLoader(
            dataset, train_cfg.batch_size // data_world,
            max_boxes=train_cfg.max_boxes,
            num_workers=train_cfg.num_workers, shuffle=True,
            seed=train_cfg.seed, device_put=stage,
            shard_id=data_index, num_shards=data_world,
            use_processes=train_cfg.worker_processes, drop_last=False)
        # The reference keeps the trailing partial batch (a ceil epoch);
        # the loader pads it with all-invalid samples, which add zero loss
        # and zero gradient (collate.pad_batch).
        self.epoch_size = len(self.loader)
        self.max_iter = train_cfg.max_epoch * self.epoch_size
        self.lr_schedule = make_lr_schedule(
            train_cfg.lr, train_cfg.gamma, self.epoch_size,
            train_cfg.max_epoch, train_cfg.warmup_epochs,
            train_cfg.warmup_init_lr)
        self.optimizer = make_optimizer(
            model.net.parameters(), self.lr_schedule, train_cfg.momentum,
            train_cfg.weight_decay, train_cfg.grad_clip_norm)
        self.train_step = make_train_step(model, self.optimizer, train_cfg,
                                          self.group)
        self.ckpt = (CheckpointManager(
            save_folder, f"RefineDet{model.size}_{dataset_name}")
            if save_folder else None)

    def init_state(self) -> TrainState:
        """Step 0 on the net's current weights (rank 0's, under a
        group)."""
        if self.group is not None:
            replicate(self.model.net, self.group)
        return create_train_state(self.model, self.optimizer,
                                  ema=self.cfg.ema_decay > 0)

    def load_state(self, payload: Dict[str, Any], source: str) -> TrainState:
        """Load a checkpoint dict into the net and the optimizer, in place,
        reconciling an EMA on/off mismatch with ``ema_decay``. Only the
        momentum buffers come from the checkpoint: the hyperparameters
        (momentum, weight decay) stay this run's, as the JAX Trainer
        rebuilds its optax chain from the config and restores the trace.
        Under a group every rank then takes rank 0's state."""
        net = self.model.net
        net.load_state_dict(payload["model"], strict=True)
        self.optimizer.load_state_dict({
            "state": payload["optimizer"]["state"],
            "param_groups": self.optimizer.state_dict()["param_groups"]})
        ema = payload["ema"]
        if self.cfg.ema_decay > 0 and ema is None:
            self.log(f"{source} has no EMA state; initializing EMA from "
                     "the restored params (--ema_decay turned on at "
                     "resume)")
            ema = ema_copy(net)
        elif self.cfg.ema_decay <= 0 and ema is not None:
            self.log(f"{source} carries EMA state but --ema_decay is 0; "
                     "dropping it (pass --ema_decay to keep tracking)")
            ema = None
        elif ema is not None:
            names = [n for n, _ in net.named_parameters()]
            if list(ema) != names:
                raise ValueError(f"{source}: EMA entries do not match the "
                                 "net's parameters")
            ema = {n: ema[n].to(self.model.device) for n in names}
        if self.group is not None:
            buffers = [self.optimizer.state[p]["momentum_buffer"]
                       for p in net.parameters()
                       if "momentum_buffer" in self.optimizer.state[p]]
            replicate([*net.parameters(), *net.buffers(), *buffers,
                       *(ema.values() if ema is not None else ())],
                      self.group)
        return TrainState(step=int(payload["step"]), net=net,
                          optimizer=self.optimizer, ema=ema)

    def resume(self, epoch: int) -> TrainState:
        return self.load_state(self.ckpt.restore(epoch),
                               f"checkpoint epoch {epoch}")

    def _save(self, state, tag) -> Optional[str]:
        """Rank 0 writes the checkpoint; returns its path (None elsewhere
        or without a save folder)."""
        if self.ckpt is None or self.rank != 0:
            return None
        return self.ckpt.save(state, tag)

    def _maybe_checkpoint(self, state, epoch: int):
        if epoch <= 0:
            return
        # Reference cadence: every 10 epochs, every 5 after 200.
        if epoch % 10 == 0 or (epoch > 200 and epoch % 5 == 0):
            self._save(state, epoch)

    def _validate_batch(self, batch) -> None:
        """Target sanity guard (the reference's coordinate check), raising
        a descriptive error instead of silently ending the iteration.
        Skipped with on-device augmentation: its targets are staging
        pixels."""
        if self.cfg.on_device_augment:
            return
        coords = batch.boxes[batch.valid]
        if coords.size and (coords.min() < -1e-3 or coords.max() > 1 + 1e-3):
            raise ValueError(
                f"target coords outside [0, 1]: min {coords.min():.4f} "
                f"max {coords.max():.4f} — dataset/transform mismatch?")

    def _install_preemption_handler(self):
        """SIGTERM/SIGINT set a flag; the epoch loop checkpoints and
        returns at the next step boundary, so a kill on a preemptible
        host leaves a resumable '<prefix>_epoches_preempt_e<N>'
        checkpoint. Returns a function that restores the old handlers."""
        self._preempted = False
        prev = {}

        def mark(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, mark)
            except ValueError:  # not the main thread — skip
                return lambda: None

        def restore():
            for sig, h in prev.items():
                signal.signal(sig, h)

        return restore

    def _stop(self) -> bool:
        """Whether to stop at this step boundary: a preemption signal
        reached this rank, or under a group any rank."""
        if self._control is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._control)
        self._preempted = bool(flag.item())
        return self._preempted

    def train(self, state: Optional[TrainState] = None,
              start_epoch: int = 0,
              max_epochs: Optional[int] = None) -> TrainState:
        state = state if state is not None else self.init_state()
        end_epoch = min(self.cfg.max_epoch,
                        (start_epoch + max_epochs) if max_epochs
                        else self.cfg.max_epoch)
        iteration = start_epoch * self.epoch_size
        # A resumed run continues the shuffle/augmentation stream.
        self.loader.epoch = start_epoch
        # Metrics are logged one step late: reading step i's values right
        # after launching it would stall the host behind the device, so
        # they are read after step i+1 is launched.
        pending = None  # (iteration, epoch, device metrics)
        last_t = time.time()
        last_iter = iteration

        def flush(pending):
            nonlocal last_t, last_iter
            it, ep, dev_metrics = pending
            values = torch.stack(list(dev_metrics.values())).tolist()
            metrics = dict(zip(dev_metrics, values))
            now = time.time()
            bt = (now - last_t) / max(1, it - last_iter)
            last_t, last_iter = now, it
            lr = float(self.lr_schedule(it - 1))
            eta = int(bt * (self.max_iter - it))
            self.log(
                f"Epoch:{ep}/{self.cfg.max_epoch} || "
                f"Epochiter: {((it - 1) % self.epoch_size) + 1}"
                f"/{self.epoch_size} || Iter: {it}"
                f"/{self.max_iter} || "
                f"ARM_L Loss: {metrics['arm_loss_l']:.4f} "
                f"ARM_C Loss: {metrics['arm_loss_c']:.4f} "
                f"ODM_L Loss: {metrics['odm_loss_l']:.4f} "
                f"ODM_C Loss: {metrics['odm_loss_c']:.4f} "
                f"loss: {metrics['loss']:.4f} || "
                f"LR: {lr:.8f} || Batchtime: {bt:.4f} s || "
                f"ETA: {datetime.timedelta(seconds=eta)}")
            if self.live_plotter is not None:
                self.live_plotter.update(it, metrics)

        restore_signals = self._install_preemption_handler()
        try:
            for epoch in range(start_epoch + 1, end_epoch + 1):
                self._maybe_checkpoint(state, epoch - 1)
                for sb in self.loader:  # checked and staged
                    if self._stop():
                        break
                    sb = sb.wait()
                    state, metrics = self.train_step(
                        state, sb.images, sb.boxes, sb.labels, sb.valid)
                    iteration += 1
                    if pending is not None:
                        flush(pending)
                    if self.rank == 0:  # the other ranks log nothing
                        pending = (iteration, epoch, metrics)
                if self.live_plotter is not None:
                    if pending is not None:
                        flush(pending)
                        pending = None
                    self.live_plotter.end_epoch(epoch)
                if self._preempted:
                    if pending is not None:
                        flush(pending)
                    path = self._save(state, f"preempt_e{epoch}")
                    if path is not None:
                        self.log(f"preemption signal: checkpointed to "
                                 f"{path}")
                    return state
            if pending is not None:
                flush(pending)
        finally:
            restore_signals()
        # The last epoch's numbered checkpoint (the check at the top of
        # each epoch covers only epoch - 1), then the 'final' alias.
        self._maybe_checkpoint(state, end_epoch)
        self._save(state, "final")
        return state
