"""Training loop on one device: config → loader → train step → trainer.

Port of ``workoutdetector_tpu/train/trainer.py`` (``Trainer``, ``train``,
``test``) for one device and no mesh:

* the train step crops, resizes and flips the uint8 canvases on the
  device when ``data.device_augment`` is set (``ops/augment.py``; the
  draw from a generator seeded by ``seed + 2`` and the step, the
  counterpart of ``jax.random.fold_in(aug_key, step)``), normalizes the
  batch on the device, runs the model in train mode (BN batch
  statistics, dropout from a generator seeded by
  ``seed + 1`` and the step — the counterpart of
  ``jax.random.fold_in(base_key, step)``), takes the mean softmax CE on
  fp32 logits (plus ``aux_loss_weight`` times the CE of an auxiliary head
  or of RepNet's per-frame logits, and ``moe_aux_weight`` times the mean
  of a MoE model's load-balance losses, where the model returns them:
  ``train_loss``), back-propagates (the 1×1 backward kernels on the main
  path), clips and updates (``train/optim.TrainOptimizer``) and moves the
  EMA;
* the eval step runs the inference path (fused-block and shift-matmul
  kernels) and masks the loader's pad rows (label -1);
* ``fit`` keeps the JAX trainer's semantics: fast_dev_run, max_steps,
  check_val_every_n_epoch, grad_accum_steps counted in update steps,
  'best' (on val/acc >=, never on an empty val split) and 'last'
  checkpoints, resume (``'auto'``: from 'last' when it exists) that
  continues the epoch budget and is exact mid-epoch, early stopping on
  the configured monitor, and SIGTERM/SIGINT preemption (finish the step,
  save 'last', return).

Every source of randomness is a function of (seed, step) or (seed, epoch,
index), and cuDNN is held to deterministic algorithms, so a resumed run
repeats an uninterrupted one bit for bit.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from workoutdetector_tpu_torch.data.datasets import build_dataset
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.convert import (init_flax_variables,
                                                      load_flax_variables)
from workoutdetector_tpu_torch.models.factory import build_model
from workoutdetector_tpu_torch.ops.augment import (canvas_size, crop_flip,
                                                   sample_batch_params)
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager
from workoutdetector_tpu_torch.train.loggers import build_loggers
from workoutdetector_tpu_torch.train.optim import EMA, TrainOptimizer
from workoutdetector_tpu_torch.utils.profiling import StepTimer


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax CE on fp32 logits
    (``optax.softmax_cross_entropy_with_integer_labels``). Written with a
    one-hot product rather than a gather so its backward has no
    scatter-add, whose order on the card could vary from run to run."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp * F.one_hot(labels.long(), logits.shape[-1])).sum(-1)


def train_loss(out, labels: torch.Tensor, aux_weight: float,
               moe_weight: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of a train-mode forward: the mean CE of the logits;
    where the model also returned auxiliary logits (``(logits, aux)``:
    TPN's aux head, RepNet's per-frame logits) ``aux_weight`` times their
    mean CE; and where it returned load-balance losses (``(logits, aux,
    moe_losses)``: a MoE TimeSformer, one loss per routing group)
    ``moe_weight`` times their mean (JAX ``trainer.py:188-204``). (B, T, C)
    auxiliary logits are dense per-frame supervision: the clip's label
    holds for each of its frames."""
    logits, aux, moe = (tuple(out) + (None, None))[:3] \
        if isinstance(out, tuple) else (out, None, None)
    loss = cross_entropy(logits, labels).mean()
    if aux is not None:
        ya = labels
        if aux.dim() == 3:
            ya = labels.repeat_interleave(aux.shape[1])
            aux = aux.reshape(-1, aux.shape[-1])
        loss = loss + aux_weight * cross_entropy(aux, ya).mean()
    if moe is not None:
        loss = loss + moe_weight * moe.mean()
    return loss, logits


class TrainState:
    """What a step changes and a checkpoint holds: the step count, the
    model's parameters and running statistics, the optimizer, the EMA."""

    def __init__(self, model: torch.nn.Module, optimizer: TrainOptimizer,
                 ema: Optional[EMA]):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.ema = ema

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema.state_dict() if self.ema is not None else None}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.step = int(state["step"])


class Trainer:
    """Training and evaluation of one run on one device."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # as the PyTorch reference's train(): deterministic cuDNN algorithms
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.model = build_model(cfg.model).to(self.device)
        self.best_val_acc = 0.0
        self._es_best = float("inf") if cfg.callbacks.early_stopping.mode == \
            "min" else float("-inf")
        self._es_count = 0
        self._ckpt: Optional[CheckpointManager] = None
        self._best_is_ours = False

    # ------------------------------------------------------------ state
    def init_state(self, steps_per_epoch: int, variables=None) -> TrainState:
        """Weights from ``variables`` (a flax-layout tree) or flax's
        initializers at ``cfg.seed``; the optimizer sized in update steps
        per epoch (``grad_accum_steps`` micro-steps make one update)."""
        cfg = self.cfg
        if variables is None:
            variables = init_flax_variables(self.model, cfg.seed)
        load_flax_variables(self.model, variables)
        self._accum = max(cfg.trainer.grad_accum_steps, 1)
        update_steps = max(-(-max(steps_per_epoch, 1) // self._accum), 1)
        optimizer = TrainOptimizer(
            self.model, cfg.optimizer, cfg.lr_scheduler, update_steps,
            cfg.trainer.max_epochs, partial_bn=cfg.model.partial_bn,
            fc_lr5=cfg.model.fc_lr5, grad_accum_steps=self._accum)
        ema = EMA(self.model, cfg.optimizer.ema_decay) \
            if cfg.optimizer.ema_decay > 0 else None
        return TrainState(self.model, optimizer, ema)

    # ------------------------------------------------------------ steps
    def dropout_generator(self, step: int) -> torch.Generator:
        """The step's dropout stream: a function of (seed + 1, step)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(((self.cfg.seed + 1) * 1_000_003 + step) & (2 ** 63 - 1))
        return g

    def augment_params(self, step: int, batch_size: int,
                       base: int) -> torch.Tensor:
        """The step's on-device augment draw, (batch_size, 5) rows of
        (x0, y0, cw, ch, flip) over a base × base canvas, from a generator
        that is a function of (seed + 2, step)."""
        g = torch.Generator()
        g.manual_seed(((self.cfg.seed + 2) * 1_000_003 + step) & (2 ** 63 - 1))
        return sample_batch_params(g, batch_size, base)

    def _batch(self, x_u8, y, step: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch on the device, normalized; a train step's (``step``
        given) through the on-device augment when the config asks."""
        x = torch.as_tensor(x_u8).to(self.device, non_blocking=True)
        if step is not None and self.cfg.data.device_augment:
            params = self.augment_params(step, x.shape[0], canvas_size(x))
            x = crop_flip(x, params, self.cfg.data.image_size)
        return normalize_clip(x), torch.as_tensor(y).to(self.device).long()

    def train_step(self, state: TrainState, x_u8, y) -> Dict[str, torch.Tensor]:
        """One micro-step: the on-device augment where configured, forward,
        loss, backward, optimizer, EMA. Returns device scalars {'loss',
        'acc'} (no host sync)."""
        model = state.model
        model.train()
        x, y = self._batch(x_u8, y, state.step)
        loss, logits = train_loss(
            model(x, dropout_generator=self.dropout_generator(state.step)), y,
            self.cfg.model.aux_loss_weight, self.cfg.model.moe_aux_weight)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        if state.ema is not None:
            state.ema.update(model)
        state.step += 1
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    @torch.no_grad()
    def eval_step(self, state: TrainState, x_u8, y) -> Dict[str, torch.Tensor]:
        """Inference-path logits (EMA weights when EMA is on); loss and
        counts over the real rows only (label ≥ 0)."""
        model = state.model
        model.eval()
        x, y = self._batch(x_u8, y)
        if state.ema is not None:
            logits = torch.func.functional_call(model, state.ema.params, (x,))
        else:
            logits = model(x)
        mask = (y >= 0).float()
        n = mask.sum()
        loss = (cross_entropy(logits, y.clamp(min=0)) * mask).sum() / \
            torch.clamp(n, min=1.0)
        correct = ((logits.argmax(-1) == y) & (y >= 0)).sum()
        return {"loss": loss, "correct": correct, "total": n.long()}

    # ------------------------------------------------------------ loops
    def _loader(self, split: str, shuffle: bool) -> DataLoader:
        return DataLoader(build_dataset(self.cfg.data, split, self.device),
                          batch_size=self.cfg.data.batch_size, shuffle=shuffle,
                          num_workers=self.cfg.data.num_workers,
                          seed=self.cfg.seed, drop_last=(split == "train"))

    def evaluate(self, state: TrainState, loader: DataLoader) -> Dict[str, float]:
        tot_correct, tot, tot_loss = 0, 0, 0.0
        for bx, by in loader:
            m = self.eval_step(state, bx, by)
            n = int(m["total"])
            tot_correct += int(m["correct"])
            tot += n
            # weight by the real rows: a padded tail batch is not a full one
            tot_loss += float(m["loss"]) * n
        if tot == 0:
            return {"acc": 0.0, "loss": 0.0, "n": 0}
        return {"acc": tot_correct / tot, "loss": tot_loss / tot, "n": tot}

    def _resume(self, ckpt: CheckpointManager, name: str,
                state: TrainState) -> TrainState:
        try:
            state, meta = ckpt.restore(name, state)
        except (KeyError, ValueError, RuntimeError, TypeError):
            # the optimizer's layout changed since the save (e.g.
            # grad_accum toggled): weights only, a fresh optimizer
            raw = ckpt.restore_variables(name, prefer_ema=False)
            self.model.load_state_dict({**raw["params"], **raw["batch_stats"]})
            if state.ema is not None:
                state.ema = EMA(self.model, self.cfg.optimizer.ema_decay)
            meta = {}
            print("[resume] optimizer state structure changed; restored "
                  "weights only, optimizer starts fresh")
        self.best_val_acc = meta.get("best_val_acc", 0.0)
        self._best_is_ours = True
        return state

    def fit(self, ckpt_dir: Optional[str] = None, variables=None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """The full loop, from ``variables`` (a flax-layout tree) or a fresh
        initialisation. Returns (final state, summary metrics)."""
        # preemption: finish the in-flight step, save 'last', return
        preempted = threading.Event()
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(
                    sig, lambda signum, frame: preempted.set())
        try:
            return self._fit(ckpt_dir, variables, preempted)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def _fit(self, ckpt_dir, variables, preempted: threading.Event):
        cfg = self.cfg
        timestamp = time.strftime("%Y%m%d-%H%M%S")
        log_dir = os.path.join(cfg.trainer.default_root_dir, timestamp)
        os.makedirs(log_dir, exist_ok=True)
        loggers = build_loggers(cfg, log_dir)
        loggers.log_hyperparams(cfg.to_dict())

        train_loader = self._loader("train", shuffle=True)
        val_loader = self._loader("val", shuffle=False)
        steps_per_epoch = max(len(train_loader), 1)
        state = self.init_state(steps_per_epoch, variables)

        if ckpt_dir is None:
            ckpt_dir = cfg.callbacks.modelcheckpoint.dirpath or log_dir
        ckpt = CheckpointManager(ckpt_dir) \
            if cfg.trainer.enable_checkpointing else None
        self._ckpt = ckpt
        # train() tests only a 'best' this run saved or resumed onto
        self._best_is_ours = False
        resume_from = cfg.trainer.resume_from_checkpoint
        if resume_from == "auto":
            resume_from = "last" if ckpt is not None and ckpt.exists("last") \
                else None
        if resume_from and ckpt is not None:
            state = self._resume(ckpt, resume_from, state)

        max_epochs = 1 if cfg.trainer.fast_dev_run else cfg.trainer.max_epochs
        history: Dict[str, float] = {}
        global_step = state.step
        # resume continues the epoch budget, and mid-epoch from the batch
        # after the last one trained (the loader skips the others unread)
        start_epoch = 0 if cfg.trainer.fast_dev_run else \
            min(global_step // steps_per_epoch, max_epochs)
        resume_skip = 0 if cfg.trainer.fast_dev_run else \
            global_step % steps_per_epoch
        timer = StepTimer()
        es = cfg.callbacks.early_stopping
        es_on_train = es.enable and es.monitor.startswith("train")
        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(
                epoch, start_batch=resume_skip if epoch == start_epoch else 0)
            epoch_loss_sum = epoch_acc_sum = 0.0
            epoch_steps = 0
            for bx, by in train_loader:
                metrics = self.train_step(state, bx, by)
                global_step += 1
                if es_on_train:  # device sums, fetched at the epoch's end
                    epoch_loss_sum = epoch_loss_sum + metrics["loss"]
                    epoch_acc_sum = epoch_acc_sum + metrics["acc"]
                    epoch_steps += 1
                timer.tick()
                if global_step % cfg.trainer.log_every_n_steps == 0 or \
                        cfg.trainer.fast_dev_run:
                    loggers.log_metrics(
                        {"train/loss": float(metrics["loss"]),
                         "train/acc": float(metrics["acc"]),
                         "lr": state.optimizer.schedule(
                             global_step // self._accum),
                         **timer.stats(cfg.data.batch_size)},
                        step=global_step)
                if cfg.trainer.fast_dev_run:
                    break
                if 0 < cfg.trainer.max_steps <= global_step:
                    break
                if preempted.is_set():
                    break
            if preempted.is_set():
                break

            ran_val = (epoch + 1) % cfg.trainer.check_val_every_n_epoch == 0
            val = {}
            if ran_val:
                val = self.evaluate(state, val_loader)
                loggers.log_metrics({f"val/{k}": v for k, v in val.items()},
                                    step=global_step)
                history = {"val/acc": val["acc"], "val/loss": val["loss"]}
                # an empty val split must not save 'best' every epoch
                if val["n"] > 0 and val["acc"] >= self.best_val_acc:
                    self.best_val_acc = val["acc"]
                    self._best_is_ours = True
                    if ckpt is not None:
                        ckpt.save(state, name="best",
                                  meta={"best_val_acc": self.best_val_acc,
                                        "epoch": epoch,
                                        "timestamp": timestamp})
                loggers.log_metrics({"val/best_acc": self.best_val_acc},
                                    step=global_step)
            # early stopping: train/* monitors read the epoch's mean of the
            # train stream (skipped when a resume left the epoch empty),
            # val/* monitors the epochs that ran validation
            if es.enable and (es_on_train or ran_val) and \
                    not (es_on_train and epoch_steps == 0):
                if es_on_train:
                    src = {"loss": float(epoch_loss_sum) / epoch_steps,
                           "acc": float(epoch_acc_sum) / epoch_steps}
                else:
                    src = val
                metric = src["loss"] if "loss" in es.monitor else src["acc"]
                better = (metric < self._es_best) if es.mode == "min" else \
                    (metric > self._es_best)
                if better:
                    self._es_best = metric
                    self._es_count = 0
                else:
                    self._es_count += 1
                    if self._es_count >= es.patience:
                        break
            if cfg.trainer.fast_dev_run:
                break
            if 0 < cfg.trainer.max_steps <= global_step:
                break
        if ckpt is not None:
            ckpt.save(state, name="last",
                      meta={"best_val_acc": self.best_val_acc,
                            "preempted": preempted.is_set()})
            ckpt.wait_until_finished()
        history["best_val_acc"] = self.best_val_acc
        history["preempted"] = float(preempted.is_set())
        loggers.close()
        return state, history

    def test(self, state: TrainState) -> Dict[str, float]:
        split = "test" if self.cfg.data.test.anno or \
            self.cfg.data.dataset_type == "DebugDataset" else "val"
        return self.evaluate(state, self._loader(split, shuffle=False))


def train(cfg, device="cuda") -> Dict[str, float]:
    """fit, then test the 'best' checkpoint this run saved (the final
    state when there is none)."""
    trainer = Trainer(cfg, device)
    state, history = trainer.fit()
    if not cfg.trainer.fast_dev_run:
        ckpt = trainer._ckpt
        if ckpt is not None and trainer._best_is_ours and ckpt.exists("best"):
            state, _ = ckpt.restore("best", state)
        history.update({f"test/{k}": v for k, v in trainer.test(state).items()})
    return history


def test(cfg, device="cuda") -> Dict[str, float]:
    """Evaluate ``cfg.checkpoint`` (or the initial weights) on the test
    split."""
    trainer = Trainer(cfg, device)
    state = trainer.init_state(steps_per_epoch=1)
    if cfg.checkpoint:
        state, _ = CheckpointManager(os.path.dirname(cfg.checkpoint)).restore(
            cfg.checkpoint, state)
    return trainer.test(state)
