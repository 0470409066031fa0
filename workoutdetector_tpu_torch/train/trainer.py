"""Training loop: config → loader → train step → trainer, on one device or
over a mesh of ranks.

Port of ``workoutdetector_tpu/train/trainer.py`` (``Trainer``, ``train``,
``test``):

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

Over a mesh (``parallel/mesh.py``; built from ``cfg.parallel`` when the
process belongs to a process group, as the JAX trainer builds its mesh)
one process per rank runs the JAX trainer's SPMD step by hand: every rank
takes the same global batch (``train_step``, ``eval_step``) or its
loader's block of it (``fit``) and works on its rows. The dropout masks
and the augment draw are drawn for the global batch and cut to the rows
(``models/tsm.RowDraw``: the models whose dropout is ``tsm.dropout``;
TimeSformer's own masks refuse one), train-mode BatchNorm takes the
global batch's statistics (``models/resnet.set_batch_sync``), the
gradients are averaged over the data-parallel ways (one all-reduce of a
flat buffer), and the state lies as ``state_sharding`` lays it
(``StateLayout``: ``parallel.model_axis`` and ``parallel.fsdp`` shard
weights, statistics, momenta and the EMA; the weights are gathered before
compute). A step then equals the one-process step on the whole batch.
Eval sums its losses and counts over the ranks; only the mesh's first
rank writes logs and checkpoints. A single process with no launcher
environment makes no process group and no mesh.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from workoutdetector_tpu_torch.data.datasets import build_dataset
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.convert import (init_flax_variables,
                                                      load_flax_variables)
from workoutdetector_tpu_torch.models.factory import build_model, kernels_for
from workoutdetector_tpu_torch.models.resnet import set_batch_sync
from workoutdetector_tpu_torch.models.tsm import RowDraw
from workoutdetector_tpu_torch.ops.augment import (canvas_size, crop_flip,
                                                   sample_batch_params)
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
from workoutdetector_tpu_torch.parallel.distributed import initialize
from workoutdetector_tpu_torch.parallel.mesh import (Mesh, StateLayout,
                                                     batch_rows, create_mesh,
                                                     dp_size,
                                                     host_batch_shard,
                                                     prefetch_to_device)
from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager
from workoutdetector_tpu_torch.train.loggers import (LoggerCollection,
                                                     build_loggers)
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
    model's parameters and running statistics, the optimizer, the EMA;
    under a ``layout`` the sharded leaves as this rank's blocks."""

    def __init__(self, model: torch.nn.Module, optimizer: TrainOptimizer,
                 ema: Optional[EMA], layout: Optional[StateLayout] = None):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.layout = layout

    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and statistics whole (a collective under
        a layout)."""
        state = self.model.state_dict()
        if self.layout is not None:
            state.update(self.layout.full_state())
        return state

    def load_model_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Whole parameters and statistics of any layout, into this one."""
        if self.layout is None:
            self.model.load_state_dict(state)
            return
        if set(state) != set(self.model.state_dict()):
            raise KeyError("checkpoint keys do not match the model's")
        self.model.load_state_dict(
            {k: v for k, v in state.items() if not self.layout.sharded(k)},
            strict=False)
        self.layout.load_full(state)

    def state_dict(self) -> dict:
        """The whole state, whatever the layout (a collective under one)."""
        return {"step": self.step, "model": self.model_state(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema.state_dict() if self.ema is not None else None}

    def load_state_dict(self, state: dict) -> None:
        self.load_model_state(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load_state_dict(state["ema"])
        self.step = int(state["step"])


class Trainer:
    """Training and evaluation of one run, on one device or over ``mesh``
    (default: a mesh from ``cfg.parallel`` where the process belongs to a
    process group, which a launcher's environment makes; none otherwise).
    On the card a model of another dtype than bf16 trains on the plain
    path (``kernels_for``: the hand kernels take bf16 only).
    """

    def __init__(self, cfg, mesh: Optional[Mesh] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is None and initialize(device=self.device) is not None:
            par = cfg.parallel
            mesh = create_mesh(data=par.data_axis, model=par.model_axis,
                               slices=par.slices,
                               axis_names=tuple(par.axis_names),
                               device=self.device)
        if mesh is not None and not mesh.member:
            raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
        self.mesh = mesh
        # as the PyTorch reference's train(): deterministic cuDNN algorithms
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.model = build_model(
            cfg.model, kernels_for(self.device, cfg.model.dtype)
        ).to(self.device)
        if mesh is not None and dp_size(mesh) > 1:
            set_batch_sync(self.model, mesh.batch_sum)
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
        layout = StateLayout(self.model, self.mesh, cfg.parallel.fsdp) \
            if self.mesh is not None else None
        self._accum = max(cfg.trainer.grad_accum_steps, 1)
        update_steps = max(-(-max(steps_per_epoch, 1) // self._accum), 1)
        optimizer = TrainOptimizer(
            self.model, cfg.optimizer, cfg.lr_scheduler, update_steps,
            cfg.trainer.max_epochs, partial_bn=cfg.model.partial_bn,
            fc_lr5=cfg.model.fc_lr5, grad_accum_steps=self._accum,
            layout=layout)
        ema = EMA(self.model, cfg.optimizer.ema_decay, layout) \
            if cfg.optimizer.ema_decay > 0 else None
        if layout is not None:
            layout.release()
        return TrainState(self.model, optimizer, ema, layout)

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

    def _batch(self, x_u8, y, step: Optional[int] = None,
               rows: Optional[Tuple[int, int]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch on the device, normalized; a train step's (``step``
        given) through the on-device augment when the config asks, its
        draw made for the global batch and cut to ``rows`` = (first row,
        global batch)."""
        x = torch.as_tensor(x_u8).to(self.device, non_blocking=True)
        if step is not None and self.cfg.data.device_augment:
            lo, total = rows if rows is not None else (0, x.shape[0])
            params = self.augment_params(step, total, canvas_size(x))
            x = crop_flip(x, params[lo:lo + x.shape[0]],
                          self.cfg.data.image_size)
        return normalize_clip(x), torch.as_tensor(y).to(self.device).long()

    def _rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's rows of an n-row global batch."""
        return batch_rows(n, self.mesh) if self.mesh is not None else (0, n)

    def _mesh_mean(self, values) -> List[float]:
        """The mean of per-rank values over the mesh: over the data ways,
        since ranks that differ only on ``model`` hold the same values."""
        t = torch.tensor(values, dtype=torch.float64, device=self.mesh.device)
        self.mesh.comm.all_reduce(t, self.mesh.all_group)
        return (t / dist.get_world_size(self.mesh.all_group)).tolist()

    def train_step(self, state: TrainState, x_u8, y) -> Dict[str, torch.Tensor]:
        """One micro-step on the global batch ``x_u8``, ``y`` (each rank of
        a mesh takes its rows): the on-device augment where configured,
        forward, loss, backward, optimizer, EMA. Returns device scalars
        {'loss', 'acc'} of the global batch (no host sync without a mesh).
        """
        lo, hi = self._rows(len(y))
        metrics = self._train_step(state, x_u8[lo:hi], y[lo:hi], lo, len(y))
        if self.mesh is not None:
            loss, acc = self._mesh_mean([float(metrics["loss"]),
                                         float(metrics["acc"])])
            metrics = {"loss": torch.tensor(loss), "acc": torch.tensor(acc)}
        return metrics

    def _train_step(self, state: TrainState, x_u8, y, lo: int, total: int
                    ) -> Dict[str, torch.Tensor]:
        """The step on rows [lo, lo + len(y)) of a ``total``-row global
        batch; this rank's loss and accuracy."""
        model = state.model
        model.train()
        if state.layout is not None:
            state.layout.materialize()
        x, y = self._batch(x_u8, y, state.step, (lo, total))
        gen = self.dropout_generator(state.step)
        if self.mesh is not None:
            gen = RowDraw(gen, lo, lo + len(y), total)
        loss, logits = train_loss(
            model(x, dropout_generator=gen), y,
            self.cfg.model.aux_loss_weight, self.cfg.model.moe_aux_weight)
        state.optimizer.zero_grad()
        loss.backward()
        if self.mesh is not None:
            self._average_grads(model)
        state.optimizer.step()
        if state.ema is not None:
            state.ema.update(model)
        if state.layout is not None:  # nothing whole stays between steps
            state.optimizer.zero_grad()
            state.layout.release()
        state.step += 1
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    @torch.no_grad()
    def _average_grads(self, model: torch.nn.Module) -> None:
        """Every gradient averaged over the data-parallel ways: one
        all-reduce of a flat buffer per dtype."""
        n = dp_size(self.mesh)
        if n == 1:
            return
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for dtype in {p.grad.dtype for p in params}:
            ps = [p for p in params if p.grad.dtype == dtype]
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            self.mesh.comm.all_reduce(flat, self.mesh.dp_group)
            flat /= n
            for p, g in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad = g.view_as(p)

    def eval_step(self, state: TrainState, x_u8, y) -> Dict[str, torch.Tensor]:
        """Inference-path logits (EMA weights when EMA is on) of the global
        batch (each rank of a mesh scores its rows); loss and counts over
        its real rows only (label ≥ 0)."""
        if state.layout is not None:
            state.layout.materialize()
        lo, hi = self._rows(len(y))
        sums = self._eval_sums(state, x_u8[lo:hi], y[lo:hi], self._ema(state))
        if state.layout is not None:
            state.layout.release()
        if self.mesh is not None:
            self.mesh.comm.all_reduce(sums, self.mesh.dp_group)
        n = sums[2]
        return {"loss": (sums[0] / torch.clamp(n, min=1.0)).float(),
                "correct": sums[1].long(), "total": n.long()}

    def _ema(self, state: TrainState):
        return state.ema.full_params() if state.ema is not None else None

    @torch.no_grad()
    def _eval_sums(self, state: TrainState, x_u8, y, ema_params
                   ) -> torch.Tensor:
        """[Σ loss, correct, real rows] of these rows, float64."""
        model = state.model
        model.eval()
        x, y = self._batch(x_u8, y)
        if ema_params is not None:
            logits = torch.func.functional_call(model, ema_params, (x,))
        else:
            logits = model(x)
        mask = (y >= 0).float()
        loss = (cross_entropy(logits, y.clamp(min=0)) * mask).sum()
        correct = ((logits.argmax(-1) == y) & (y >= 0)).sum()
        return torch.stack([loss.double(), correct.double(),
                            mask.sum().double()])

    # ------------------------------------------------------------ loops
    def _loader(self, split: str, shuffle: bool) -> DataLoader:
        shard_id, num_shards = host_batch_shard(self.mesh) \
            if self.mesh is not None else (0, 1)
        return DataLoader(build_dataset(self.cfg.data, split, self.device),
                          batch_size=self.cfg.data.batch_size, shuffle=shuffle,
                          num_workers=self.cfg.data.num_workers,
                          seed=self.cfg.seed, drop_last=(split == "train"),
                          shard_id=shard_id, num_shards=num_shards)

    def evaluate(self, state: TrainState, loader: DataLoader) -> Dict[str, float]:
        """Loss and accuracy over a loader's real rows; over a mesh each
        rank's loader reads its block and the sums are summed."""
        if state.layout is not None:
            state.layout.materialize()
        ema = self._ema(state)
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        for bx, by in prefetch_to_device(loader, self.mesh,
                                         device=self.device):
            sums += self._eval_sums(state, bx, by, ema)
        if state.layout is not None:
            state.layout.release()
        if self.mesh is not None:
            self.mesh.comm.all_reduce(sums, self.mesh.dp_group)
        tot_loss, tot_correct, tot = sums.tolist()
        if tot == 0:
            return {"acc": 0.0, "loss": 0.0, "n": 0}
        return {"acc": tot_correct / tot, "loss": tot_loss / tot, "n": int(tot)}

    def _resume(self, ckpt: CheckpointManager, name: str,
                state: TrainState) -> TrainState:
        try:
            state, meta = ckpt.restore(name, state)
        except (KeyError, ValueError, RuntimeError, TypeError):
            # the optimizer's layout changed since the save (e.g.
            # grad_accum toggled): weights only, a fresh optimizer
            raw = ckpt.restore_variables(name, prefer_ema=False)
            state.load_model_state({**raw["params"], **raw["batch_stats"]})
            if state.ema is not None:
                state.ema = EMA(self.model, self.cfg.optimizer.ema_decay,
                                state.layout)
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

    @property
    def _main(self) -> bool:
        return self.mesh.is_main if self.mesh is not None else True

    def _fit(self, ckpt_dir, variables, preempted: threading.Event):
        cfg = self.cfg
        timestamp = [time.strftime("%Y%m%d-%H%M%S")]
        if self.mesh is not None:  # one run directory: the first rank's
            dist.broadcast_object_list(timestamp, int(self.mesh.ranks.flat[0]),
                                       group=self.mesh.all_group)
        timestamp = timestamp[0]
        log_dir = os.path.join(cfg.trainer.default_root_dir, timestamp)
        loggers = LoggerCollection([])
        if self._main:
            os.makedirs(log_dir, exist_ok=True)
            loggers = build_loggers(cfg, log_dir)
        loggers.log_hyperparams(cfg.to_dict())

        train_loader = self._loader("train", shuffle=True)
        val_loader = self._loader("val", shuffle=False)
        steps_per_epoch = max(len(train_loader), 1)
        state = self.init_state(steps_per_epoch, variables)

        if ckpt_dir is None:
            ckpt_dir = cfg.callbacks.modelcheckpoint.dirpath or log_dir
        ckpt = CheckpointManager(ckpt_dir, self.mesh) \
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
            block = train_loader.local_batch * train_loader.shard_id
            for bx, by in prefetch_to_device(train_loader, self.mesh,
                                             device=self.device):
                metrics = self._train_step(state, bx, by, block,
                                           cfg.data.batch_size)
                if self.mesh is not None:  # global metrics, one stop signal
                    loss, acc, stop = self._mesh_mean(
                        [float(metrics["loss"]), float(metrics["acc"]),
                         float(preempted.is_set())])
                    metrics = {"loss": torch.tensor(loss),
                               "acc": torch.tensor(acc)}
                    if stop > 0:
                        preempted.set()
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
    trainer = Trainer(cfg, device=device)
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
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(steps_per_epoch=1)
    if cfg.checkpoint:
        state, _ = CheckpointManager(os.path.dirname(cfg.checkpoint),
                                     trainer.mesh).restore(cfg.checkpoint,
                                                           state)
    return trainer.test(state)
