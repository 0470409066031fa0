"""Typed config: the port's own copy of ``workoutdetector_tpu/config.py``.

The same dataclasses, defaults, ``load_config`` and dotted overrides, so
the repository's YAMLs (``workoutdetector_tpu/configs/*.yaml``) load
unchanged. PyYAML is imported only inside the functions that read or
write YAML (``merge_file``, ``merge_opts``, ``dump``): a config built in
code needs none. Fields that name TPU-side switches (``shift_impl``,
``fused_block``, ``pallas_conv_bwd``, ``flash_attention``, ``parallel.*``)
are kept so the files load; the port's trainer reads the ones it uses.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a YAML/CLI value to the annotated type (best-effort)."""
    if value is None:
        return None
    origin = getattr(typ, "__origin__", None)
    if origin is not None:  # typing generics: Optional[x], List[x], Dict
        args = getattr(typ, "__args__", ())
        if origin is list:
            inner = args[0] if args else Any
            return [_coerce(v, inner) for v in value]
        if origin is dict:
            return dict(value)
        # Optional[X] == Union[X, None]
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1:
            return _coerce(value, non_none[0])
        return value
    if typ in (Any, None) or isinstance(typ, str):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ is int:
        if isinstance(value, float):
            # YAML already parsed a float: 2.5 must not silently become 2
            if value != int(value):
                raise ValueError(f"non-integral value {value!r} for int field")
            return int(value)
        try:
            return int(value)
        except ValueError:  # '1e4'-style exponent literals
            f = float(value)
            if f != int(f):
                raise ValueError(f"non-integral value {value!r} for int field")
            return int(f)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    return value


@functools.lru_cache(maxsize=None)
def _resolved_hints(cls) -> Dict[str, Any]:
    """Field name → REAL type for a ConfigNode class. Under
    ``from __future__ import annotations`` the dataclass ``field.type``
    is a string; resolving it lets `_coerce` turn e.g.
    ``optimizer.lr=1e-3`` (a string to YAML) into a float."""
    import typing
    try:
        return dict(typing.get_type_hints(cls))
    except Exception:
        return {}


class ConfigNode:
    """Mixin giving dataclasses dict-merge, YAML IO, and dotted access."""

    def merge_dict(self, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            if not hasattr(self, k):
                raise KeyError(
                    f"Unknown config key '{k}' for {type(self).__name__}. "
                    f"Valid keys: {[f.name for f in fields(self)]}")
            cur = getattr(self, k)
            if is_dataclass(cur) and isinstance(v, dict):
                cur.merge_dict(v)
            else:
                ftype = _resolved_hints(type(self)).get(k, Any)
                setattr(self, k, _coerce(v, ftype))

    def merge_file(self, path: str) -> None:
        import yaml
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        self.merge_dict(d)

    def merge_opts(self, opts: List[str]) -> None:
        """Merge dotted-path CLI overrides: ["model.num_class=12", ...].

        Also accepts alternating ["model.num_class", "12"] (fvcore style,
        reference workoutdetector/trainer.py:363-366).
        """
        import yaml
        pairs: List[tuple] = []
        i = 0
        while i < len(opts):
            tok = opts[i]
            if "=" in tok:
                key, val = tok.split("=", 1)
                pairs.append((key, val))
                i += 1
            else:
                if i + 1 >= len(opts):
                    raise ValueError(f"Dangling config override: {tok}")
                pairs.append((tok, opts[i + 1]))
                i += 2
        for key, val in pairs:
            node: Any = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            leaf = parts[-1]
            if not hasattr(node, leaf):
                raise KeyError(f"Unknown config key '{key}'")
            parsed = yaml.safe_load(val)
            cur = getattr(node, leaf)
            if is_dataclass(cur) and isinstance(parsed, dict):
                cur.merge_dict(parsed)
            else:
                ftype = _resolved_hints(type(node)).get(leaf, Any)
                setattr(node, leaf, _coerce(parsed, ftype))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def dump(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def clone(self):
        return copy.deepcopy(self)


@dataclass
class TrainerConfig(ConfigNode):
    default_root_dir: str = "exp/default"
    max_epochs: int = 50
    max_steps: int = -1
    check_val_every_n_epoch: int = 1
    min_epochs: int = 1
    precision: str = "bf16"  # "fp32" | "bf16"
    # kept so the repo's YAMLs (defaults.yaml sets it) load; read by
    # nothing, as in the JAX package: the trainer is always deterministic
    deterministic: bool = True
    fast_dev_run: bool = False
    resume_from_checkpoint: Optional[str] = None
    enable_checkpointing: bool = True
    devices: str = "auto"
    num_nodes: int = 1
    log_every_n_steps: int = 20
    grad_accum_steps: int = 1


@dataclass
class OptimizerConfig(ConfigNode):
    method: str = "sgd"  # sgd | adamw
    lr: float = 0.005
    momentum: float = 0.9
    nesterov: bool = False  # reference timesformer/tpn configs use nesterov
    weight_decay: float = 5.0e-4
    eps: float = 1.0e-8
    # global-norm gradient clip over every gradient; 0 = off
    grad_clip: float = 20.0
    # scale step k by step k-1's global norm (train/optim
    # delayed_clip_by_global_norm); step 0 runs unclipped
    grad_clip_delayed: bool = False
    use_tsn_policies: bool = True  # per-group lr/decay multipliers
    # >0: exponential moving average of the params (decay per step);
    # eval and 'best' selection then use the EMA weights. 0 = off
    ema_decay: float = 0.0


@dataclass
class LRSchedulerConfig(ConfigNode):
    policy: str = "steplr"  # steplr | cosine | multistep
    gamma: float = 0.1
    step: int = 8  # StepLR step size (epochs)
    lr_steps: List[int] = field(default_factory=lambda: [20, 40])
    warmup_epochs: float = 0.0
    warmup_multiplier: float = 8.0
    eta_min: float = 1.0e-5


@dataclass
class ModelConfig(ConfigNode):
    model_type: str = "tsm"  # tsm | tdn | tpn | timesformer | repnet | image
    num_class: int = 12
    num_segments: int = 8
    num_frames: int = 1  # TDN: frames per segment (5)
    base_model: str = "resnet50"
    consensus_type: str = "avg"
    is_shift: bool = True
    shift_div: int = 8
    shift_place: str = "blockres"  # blockres | block
    fc_lr5: bool = True
    partial_bn: bool = True
    dropout: float = 0.5
    temporal_pool: bool = False
    non_local: bool = False
    # TPN (reference configs/tpn.py): aux classification-head CE weight
    aux_loss_weight: float = 0.5
    checkpoint: Optional[str] = None
    # TimeSformer (reference configs/timesformer_div_8x4x1_k400.py:5-23;
    # base_model selects the ViT variant, e.g. vit_base_patch16_224)
    image_size: int = 224
    patch_size: int = 16
    embed_dims: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    attention_type: str = "divided_space_time"
    drop_path_rate: float = 0.0
    # TimeSformer sequence parallelism and MoE MLPs (not in the port yet)
    seq_parallel: bool = False
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    dtype: str = "bfloat16"  # compute dtype; params stay fp32
    # the JAX package's shift implementation switch; the port has one
    # implementation (the hand kernels), so it reads none of these
    shift_impl: str = "xla"  # xla | xla-edge | pallas | unfused
    # shift-site placement stride (reference n_round): 0 = depth rule
    shift_round: int = 0
    remat: bool = False  # block rematerialisation (not in the port yet)
    # inference: the stride-1 bottlenecks of fused_stages as fused-block
    # kernels. The port runs them unless this is 'false' ('auto' = on)
    fused_block: str = "auto"  # auto | true | false
    fused_stages: List[int] = field(default_factory=lambda: [0, 1])
    # the JAX package's opt-in for its 1×1 backward kernels; in the port
    # they are the main path whatever this says
    pallas_conv_bwd: bool = False
    flash_attention: str = "auto"  # auto | true | false (TimeSformer)


@dataclass
class SplitConfig(ConfigNode):
    anno: Optional[str] = None
    data_prefix: Optional[str] = None
    person_crop: bool = False


@dataclass
class DataConfig(ConfigNode):
    dataset_type: str = "FrameDataset"  # FrameDataset|ImageDataset|TDNDataset|DebugDataset|SyntheticPeriodic
    # person-crop detector backend: 'motion' (saliency heuristic) or
    # 'learned' (models/detector.CenterNetDetector weights at
    # person_checkpoint — the fasterrcnn-equivalent capability)
    person_backend: str = "motion"
    person_checkpoint: Optional[str] = None
    data_root: str = ""
    num_segments: int = 8
    num_frames: int = 5  # TDN burst length
    filename_tmpl: str = "img_{:05}.jpg"
    anno_col: int = 4
    batch_size: int = 4
    num_workers: int = 8
    image_size: int = 224
    scale_size: int = 256
    # on-device MultiScaleCrop + flip in the train step (ops/augment.py;
    # the loader then ships scale_size canvases) and the native JPEG
    # in-decode resize of the test transform's geometry
    device_augment: bool = False
    native_prep: bool = True
    train: SplitConfig = field(default_factory=SplitConfig)
    val: SplitConfig = field(default_factory=SplitConfig)
    test: SplitConfig = field(default_factory=SplitConfig)
    # DebugDataset knobs
    debug_size: int = 100
    debug_num_class: int = 2


@dataclass
class WandbConfig(ConfigNode):
    enable: bool = False
    offline: bool = True
    project: str = "workoutdetector-tpu"
    name: Optional[str] = None


@dataclass
class LogConfig(ConfigNode):
    output_dir: Optional[str] = None
    log_every_n_steps: int = 20
    csv_enable: bool = True
    tensorboard_enable: bool = True
    wandb: WandbConfig = field(default_factory=WandbConfig)
    # step tracing and gradient/parameter norm histograms (not in the port
    # yet; the trainer ignores them)
    profile_steps: int = 0
    watch_every_n_steps: int = 0


@dataclass
class CheckpointConfig(ConfigNode):
    save_top_k: int = 1
    monitor: str = "val/acc"
    mode: str = "max"
    dirpath: Optional[str] = None
    save_weights_only: bool = False


@dataclass
class EarlyStoppingConfig(ConfigNode):
    enable: bool = False
    patience: int = 10
    monitor: str = "train/loss"
    mode: str = "min"


@dataclass
class CallbacksConfig(ConfigNode):
    modelcheckpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)


@dataclass
class ParallelConfig(ConfigNode):
    """The mesh a trainer builds when its process is one rank of several
    (``train/trainer.Trainer``, ``parallel/mesh.create_mesh``): ranks on
    the data axis (-1: all the rest), on the model axis, and in slices
    (> 1 adds a leading ``slice`` axis of pure data parallelism);
    ``fsdp`` shards parameters, statistics and optimizer state over the
    data axis too (ZeRO-3, ``parallel/mesh.param_spec``). One process
    without a launcher builds no mesh and reads none of it."""
    data_axis: int = -1
    model_axis: int = 1
    axis_names: List[str] = field(default_factory=lambda: ["data", "model"])
    fsdp: bool = False
    slices: int = 1


@dataclass
class Config(ConfigNode):
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    log: LogConfig = field(default_factory=LogConfig)
    callbacks: CallbacksConfig = field(default_factory=CallbacksConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0
    train: bool = True
    checkpoint: Optional[str] = None
    timestamp: Optional[str] = None


def load_config(cfg_file: Optional[str] = None, opts: Optional[List[str]] = None) -> Config:
    """Load config from YAML + dotted CLI overrides (``a.b=value``)."""
    cfg = Config()
    if cfg_file:
        cfg.merge_file(cfg_file)
    if opts:
        cfg.merge_opts(opts)
    return cfg
