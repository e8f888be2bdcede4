"""High-level training loop on one device.

Port of ``refinedet_tpu/train/trainer.py`` (single device; multi-GPU comes
later): the epoch loop over the prefetching loader, warmup + step lr,
per-iteration loss logging in the reference's log line format, epoch
checkpoints (every 10, every 5 after epoch 200), resume, and a preemption
checkpoint on SIGTERM/SIGINT. The loader's producer thread checks the
targets and stages each batch on the device; the loop only launches steps
and logs.
"""

from __future__ import annotations

import datetime
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from refinedet_tpu_torch.config import TrainConfig
from refinedet_tpu_torch.data.loader import DataLoader, DeviceStager
from refinedet_tpu_torch.train.checkpoints import CheckpointManager
from refinedet_tpu_torch.train.schedule import make_lr_schedule
from refinedet_tpu_torch.train.train_step import (TrainState,
                                                  create_train_state,
                                                  ema_copy, make_optimizer,
                                                  make_train_step)


class Trainer:
    """Trains ``model`` (a train-phase RefineDetModel, on its device) on
    ``dataset`` (``dataset[i]`` -> (image, boxes, labels))."""

    def __init__(self, model, dataset, train_cfg: TrainConfig,
                 save_folder: Optional[str] = None,
                 dataset_name: str = "COCO",
                 log_fn: Callable[[str], None] = print):
        if train_cfg.spatial_shards > 1:
            raise NotImplementedError(
                "spatial sharding needs several GPUs, which are not ported "
                "yet (ROADMAP.md §1, item 5)")
        self.model = model
        self.cfg = train_cfg
        self.dataset = dataset
        self.log = log_fn
        self._preempted = False

        # Target validation and the copy to the device both run in the
        # loader's producer thread: the guard sees host arrays, and the
        # copy overlaps the previous step.
        stager = DeviceStager(model.device)

        def stage(batch):
            self._validate_batch(batch)
            return stager(batch)

        self.loader = DataLoader(
            dataset, train_cfg.batch_size, max_boxes=train_cfg.max_boxes,
            num_workers=train_cfg.num_workers, shuffle=True,
            seed=train_cfg.seed, device_put=stage,
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
        self.train_step = make_train_step(model, self.optimizer, train_cfg)
        self.ckpt = (CheckpointManager(
            save_folder, f"RefineDet{model.size}_{dataset_name}")
            if save_folder else None)

    def init_state(self) -> TrainState:
        return create_train_state(self.model, self.optimizer,
                                  ema=self.cfg.ema_decay > 0)

    def load_state(self, payload: Dict[str, Any], source: str) -> TrainState:
        """Load a checkpoint dict into the net and the optimizer, in place,
        reconciling an EMA on/off mismatch with ``ema_decay``. Only the
        momentum buffers come from the checkpoint: the hyperparameters
        (momentum, weight decay) stay this run's, as the JAX Trainer
        rebuilds its optax chain from the config and restores the trace."""
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
        return TrainState(step=int(payload["step"]), net=net,
                          optimizer=self.optimizer, ema=ema)

    def resume(self, epoch: int) -> TrainState:
        return self.load_state(self.ckpt.restore(epoch),
                               f"checkpoint epoch {epoch}")

    def _maybe_checkpoint(self, state, epoch: int):
        if self.ckpt is None or epoch <= 0:
            return
        # Reference cadence: every 10 epochs, every 5 after 200.
        if epoch % 10 == 0 or (epoch > 200 and epoch % 5 == 0):
            self.ckpt.save(state, epoch)

    def _validate_batch(self, batch) -> None:
        """Target sanity guard (the reference's coordinate check), raising
        a descriptive error instead of silently ending the iteration."""
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

        restore_signals = self._install_preemption_handler()
        try:
            for epoch in range(start_epoch + 1, end_epoch + 1):
                self._maybe_checkpoint(state, epoch - 1)
                for sb in self.loader:  # checked and staged
                    if self._preempted:
                        break
                    sb = sb.wait()
                    state, metrics = self.train_step(
                        state, sb.images, sb.boxes, sb.labels, sb.valid)
                    iteration += 1
                    if pending is not None:
                        flush(pending)
                    pending = (iteration, epoch, metrics)
                if self._preempted:
                    if pending is not None:
                        flush(pending)
                    if self.ckpt is not None:
                        path = self.ckpt.save(state, f"preempt_e{epoch}")
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
        if self.ckpt is not None:
            self.ckpt.save(state, "final")
        return state
