"""ResNet backbone — NHWC at every module boundary.

Port of ``workoutdetector_tpu/models/resnet.py``: stem 7×7/2 → max-pool →
four stages of BasicBlock (resnet18/34) or Bottleneck (resnet50/101,
stride on the 3×3 — torchvision v1.5) → global average pool. Module and
parameter names follow the flax tree (``conv1``, ``bn1``, ``layer{i}_{j}``,
``downsample_conv`` / ``downsample_bn``), so
``models/convert.load_flax_variables`` is a key map. Conv weights are held
OIHW in fp32 and cast to the compute dtype at the call, as flax does.

Two regimes, by ``torch.is_grad_enabled()`` and the module's mode:

* inference (no autograd, BN on running statistics): a BatchNorm after a
  conv is folded into that conv's weight and bias (cached), so cuDNN
  applies it in its epilogue, and eligible bottlenecks are fused-block
  kernels;
* autograd (training, or any forward a gradient is taken through): conv
  then BN, unfolded, in flax's order; BN in train mode normalizes with
  batch statistics and updates its running ones (``BatchNorm``); every
  stride-1 1×1 conv of a bottleneck takes its backward through the 1×1
  backward kernels (``Conv1x1``; the shifted conv1 ``ShiftConv1x1``), as
  the JAX package's ``conv1x1_bwd='pallas'`` does; the 3×3 convs and the
  stride-2 downsamples stay cuDNN convs with autograd.

With ``num_classes`` the trunk carries its own ``fc`` head (the image
classifiers' ResNet zoo, ``models/factory.ImageClassifier``).

The TSM hooks of the JAX ResNet become constructor arguments: per-block
shift specs (``shift_spec``: the shift fused into conv1; ``pre_shift``:
the whole block input shifted), a stage-input hook, and the whole-block
fusion policy (``fuse_spec``). On the main path the shifted 1×1 conv1 is
the shift-matmul kernel and an eligible bottleneck is one fused-block
kernel; ``use_kernels=False`` runs the plain versions instead (the
on-card reference).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.ops import kernels
from workoutdetector_tpu_torch.ops.conv import conv2d_nhwc

STAGE_SIZES = {
    "resnet18": [2, 2, 2, 2],
    "resnet34": [3, 4, 6, 3],
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
}
BOTTLENECK = {"resnet18": False, "resnet34": False, "resnet50": True,
              "resnet101": True}

ShiftSpec = Optional[Tuple[int, int]]  # (n_segment, fold_div)
BN_MOMENTUM = 0.9  # flax's convention: running ← 0.9·running + 0.1·batch


def cached(module: nn.Module, name: str, sources: Sequence[torch.Tensor],
           dtype: torch.dtype, build: Callable[[], object]):
    """Tensors derived from parameters (kernel layouts, folded BN), rebuilt
    only when a source changes storage or version, or ``dtype`` changes.
    Under autograd (grad enabled and a source requiring grad) nothing is
    cached: the value is built with its graph, so gradients reach the
    sources. While ``torch.export`` traces, its fake tensors have no
    storage or version to key on: the value cached in ``dtype`` is taken as
    it is (``utils.export.export_model`` runs a forward on the weights it
    exports just before, and the program holds the value as a constant),
    or, where none is, built into the exported graph."""
    if torch.compiler.is_exporting():
        hit = module._derived.get(name)
        return hit[1] if hit is not None and hit[0][0] == dtype else build()
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return build()
    key = (dtype,) + tuple((t.device, t.data_ptr(), t._version)
                           for t in sources)
    hit = module._derived.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        value = build()
    module._derived[name] = (key, value)
    return value


class Conv(nn.Module):
    """NHWC convolution with an OIHW fp32 weight (a bias with ``bias``, as
    TDN's convs have; ``groups`` as flax's ``feature_group_count``;
    ``pad`` a symmetric pad or ``"SAME"``, flax's default, as RepNet's
    convs have), followed by ``bn`` when given: folded into the weight and
    a bias when the BN can fold (``BatchNorm.foldable``), else applied
    after the conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 pad: Union[int, str] = 0, bias: bool = False,
                 groups: int = 1):
        super().__init__()
        # zeros until load_flax_variables sets them
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self.pad = pad
        self.groups = groups
        self._derived: Dict[str, tuple] = {}

    def forward(self, x: torch.Tensor,
                bn: Optional["BatchNorm"] = None) -> torch.Tensor:
        p = self.pad
        pads = p if isinstance(p, str) else ((p, p), (p, p))
        strides = (self.stride, self.stride)
        if bn is None or not bn.foldable():
            y = conv2d_nhwc(x, self.weight, strides, pads, self.bias,
                            self.groups)
            return y if bn is None else bn(y)
        own = [] if self.bias is None else [self.bias]

        def fold():
            sb = bn.folded()
            bias = sb[1] if self.bias is None else sb[0] * self.bias + sb[1]
            # the bias owns its storage (not a view of sb), as an exported
            # program's constants must
            return (self.weight * sb[0][:, None, None, None]).to(x.dtype), \
                bias.to(x.dtype, copy=True)

        weight, bias = cached(self, "bn", [self.weight] + own + bn.sources(),
                              x.dtype, fold)
        return conv2d_nhwc(x, weight, strides, pads, bias, self.groups)

    def matrix(self) -> torch.Tensor:
        """A 1×1 weight as (C, O) — the kernels' layout."""
        return self.weight[:, :, 0, 0].t()


class Dense(nn.Module):
    """Linear head in the input's dtype: weight (out, in), bias (out,)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax's semantics
    (``FrozenAwareBatchNorm``, ``momentum=0.9``; the detector's and pose's
    own BNs are flax's default ``nn.BatchNorm``, ``momentum=0.99``).

    * train mode, not ``frozen``: normalize with the batch mean and biased
      variance (fp32 statistics, the output rounded once to x's dtype),
      and update the running statistics as flax does,
      ``new = momentum·old + (1 − momentum)·batch`` with the BIASED batch
      variance (``F.batch_norm``'s own update would use the unbiased one,
      so it is given no running buffers);
    * eval mode, or ``frozen`` (partial BN): the running statistics, never
      updated; under autograd as (x − mean)·rsqrt(var + eps)·scale + bias,
      without autograd as x · s + b with s, b folded and cached.

    With ``sync`` set (``set_batch_sync``: data-parallel training, each
    rank holding some rows of the global batch) train mode takes the
    GLOBAL batch's statistics, as the JAX program does on its global
    array: fp32 sums summed over the ranks by ``sync`` (a differentiable
    all-reduce), the mean from Σx and the row count, then the biased
    variance from Σ(x − mean)² (two passes, as ``F.batch_norm``'s), and the
    running statistics move by the same global mean and variance.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 frozen: bool = False, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.frozen = frozen
        self.momentum = momentum
        self.sync: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self._derived: Dict[str, tuple] = {}

    def sources(self) -> List[torch.Tensor]:
        return [self.weight, self.bias, self.running_mean, self.running_var]

    def batch_stats(self) -> bool:
        """Whether this call normalizes with batch statistics."""
        return self.training and not self.frozen

    def foldable(self) -> bool:
        """Running statistics and no autograd: a conv may fold this BN."""
        return not self.batch_stats() and not torch.is_grad_enabled()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.foldable():
            sb = cached(self, "sb", self.sources(), torch.float32, self.folded)
            return torch.addcmul(sb[1], x, sb[0]).to(x.dtype)
        # as (rows, C): channels innermost for the input, the output and
        # the gradients alike, so the backward hands NHWC-contiguous
        # gradients on (a 4-D channels-last view got NCHW ones back, which
        # every consumer then had to copy)
        xr = x.reshape(-1, x.shape[-1])
        if self.batch_stats() and self.sync is not None:
            return self._global_batch_norm(xr).reshape(x.shape)
        if self.batch_stats():
            self._update_running(xr)
            y = F.batch_norm(xr, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        else:
            y = F.batch_norm(xr, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.reshape(x.shape)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, C) x normalized with the statistics of every rank's rows
        (``sync`` sums over the ranks), in fp32, rounded once to x's
        dtype; the running statistics move by the same mean and biased
        variance."""
        xf = x.float()
        count = torch.full((1,), float(x.shape[0]), device=x.device)
        s1 = self.sync(torch.cat([xf.sum(0), count]))
        n = s1[-1]
        mean = s1[:-1] / n
        centred = xf - mean
        var = self.sync(centred.square().sum(0)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = centred * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, x: torch.Tensor) -> None:
        """flax's update from (rows, C) x: fp32 batch mean and biased
        variance E[x²] − E[x]² (clipped at 0), then the momentum average."""
        xf = x.float()
        mean = xf.mean(0)
        var = torch.clamp(xf.square().mean(0) - mean.square(), min=0.0)
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def folded(self) -> torch.Tensor:
        """(2, F) fp32 [scale; bias] for the kernels."""
        return kernels.fold_bn(self.weight, self.bias, self.running_mean,
                               self.running_var, self.eps)


def set_batch_sync(model: nn.Module,
                   sync: Optional[Callable[[torch.Tensor], torch.Tensor]]
                   ) -> None:
    """Give every ``BatchNorm`` of ``model`` the cross-rank sum that makes
    its train-mode statistics those of the global batch (a mesh's
    ``batch_sum``), or None for the rank's own rows."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.sync = sync


def shift_input(x: torch.Tensor, spec: Tuple[int, int],
                use_kernels: bool) -> torch.Tensor:
    """The temporal shift at a block input: the shift kernel (differentiable
    through ``TemporalShift``) or its plain version."""
    if use_kernels:
        return kernels.TemporalShift.apply(x, *spec)
    return kernels.temporal_shift_plain(x, *spec)


class BasicBlock(nn.Module):
    """3×3-3×3 residual block (resnet18/34). A shift site shifts the
    residual-branch input (the shift kernel) before conv1."""
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, downsample: bool,
                 shift: ShiftSpec = None, use_kernels: bool = True,
                 eps: float = 1e-5, frozen_bn: bool = False):
        super().__init__()
        self.shift = shift
        self.use_kernels = use_kernels
        self.conv1 = Conv(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters, eps, frozen=frozen_bn)
        self.conv2 = Conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters, eps, frozen=frozen_bn)
        if downsample:
            self.downsample_conv = Conv(cin, filters, 1, stride)
            self.downsample_bn = BatchNorm(filters, eps, frozen=frozen_bn)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.shift is not None:
            y = shift_input(x, self.shift, self.use_kernels)
        y = torch.relu(self.conv1(y, self.bn1))
        y = self.conv2(y, self.bn2)
        residual = x
        if self.downsample:
            residual = self.downsample_conv(x, self.downsample_bn)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1×1-3×3-1×1 bottleneck (resnet50/101), stride on the 3×3.

    Inference: ``fuse`` at stride 1 makes the whole block one fused-block
    kernel; otherwise a shift site's conv1 is the shift-matmul kernel.
    Under autograd the block runs unfused, its stride-1 1×1 convs through
    ``Conv1x1`` / ``ShiftConv1x1`` (kernel backward).
    """
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, downsample: bool,
                 shift: ShiftSpec = None, fuse: bool = False,
                 use_kernels: bool = True, eps: float = 1e-5,
                 frozen_bn: bool = False):
        super().__init__()
        out = filters * self.expansion
        self.shift = shift
        self.fuse = fuse and stride == 1
        self.use_kernels = use_kernels
        self.conv1 = Conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters, eps, frozen=frozen_bn)
        self.conv2 = Conv(filters, filters, 3, stride, 1)
        self.bn2 = BatchNorm(filters, eps, frozen=frozen_bn)
        self.conv3 = Conv(filters, out, 1)
        self.bn3 = BatchNorm(out, eps, frozen=frozen_bn)
        if downsample:
            self.downsample_conv = Conv(cin, out, 1, stride)
            self.downsample_bn = BatchNorm(out, eps, frozen=frozen_bn)
        self.downsample = downsample
        self._derived: Dict[str, tuple] = {}

    def fused_params(self, dtype: torch.dtype) -> kernels.FusedBlockParams:
        """Folded weights in the fused kernel's layout, cached."""
        mods = [self.conv1, self.bn1, self.conv2, self.bn2, self.conv3,
                self.bn3]
        if self.downsample:
            mods += [self.downsample_conv, self.downsample_bn]
        sources = [t for m in mods for t in
                   list(m.parameters()) + list(m.buffers())]

        def build():
            ds = self.downsample
            return kernels.FusedBlockParams(
                w1=self.conv1.matrix().to(dtype).contiguous(),
                sb1=self.bn1.folded(),
                w2=self.conv2.weight.permute(2, 3, 1, 0).to(dtype).contiguous(),
                sb2=self.bn2.folded(),
                w3=self.conv3.matrix().to(dtype).contiguous(),
                sb3=self.bn3.folded(),
                wd=self.downsample_conv.matrix().to(dtype).contiguous()
                if ds else None,
                sbd=self.downsample_bn.folded() if ds else None)

        return cached(self, "fused", sources, dtype, build)

    def _pointwise(self, conv: Conv, x: torch.Tensor,
                   bn: BatchNorm) -> torch.Tensor:
        """A stride-1 1×1 conv + BN: under autograd with the kernels on,
        ``Conv1x1`` (its backward on the kernels), else the conv's own
        path (folded BN when it can fold)."""
        if self.use_kernels and torch.is_grad_enabled():
            return bn(kernels.Conv1x1.apply(x, conv.matrix().to(x.dtype)))
        return conv(x, bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grad = torch.is_grad_enabled()
        if self.fuse and not grad and not self.training:
            n_seg, fold = (self.shift[0], x.shape[-1] // self.shift[1]) \
                if self.shift is not None else (1, 0)
            fn = kernels.fused_bottleneck if self.use_kernels \
                else kernels.fused_bottleneck_plain
            return fn(x.contiguous(), self.fused_params(x.dtype),
                      n_segment=n_seg, fold=fold)
        if self.shift is not None:
            if self.use_kernels and grad:
                w1 = self.conv1.matrix().to(x.dtype).contiguous()
                y = kernels.ShiftConv1x1.apply(x, w1, *self.shift)
            else:
                w1 = cached(self, "w1", [self.conv1.weight], x.dtype,
                            lambda: self.conv1.matrix().to(x.dtype).contiguous())
                fn = kernels.shift_matmul if self.use_kernels \
                    else kernels.shift_matmul_plain
                y = fn(x.contiguous(), w1, *self.shift)
            y = self.bn1(y)
        else:
            y = self._pointwise(self.conv1, x, self.bn1)
        y = torch.relu(y)
        y = torch.relu(self.conv2(y, self.bn2))
        y = self._pointwise(self.conv3, y, self.bn3)
        residual = x
        if self.downsample:
            if self.downsample_conv.stride == 1:
                residual = self._pointwise(self.downsample_conv, x,
                                           self.downsample_bn)
            else:
                residual = self.downsample_conv(x, self.downsample_bn)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-18/34/50/101 trunk: (N, H, W, 3) → pooled (N, C) features,
    or with ``out_indices`` the NHWC maps of those stages (TPN's taps), or
    with ``forward(x, spatial=True)`` the pre-pool (N, H/32, W/32, C) map
    (the detector's and pose's backbone, JAX ``resnet.py:344-346, 418``).

    Args:
        shift_spec: fn(stage, block) → (n_segment, fold_div) or None: shift
            the residual-branch input of that block (fused into conv1).
        pre_shift: fn(stage, block) → (n_segment, fold_div) or None: shift
            the WHOLE block input, identity path included.
        stage_hook: fn(x, stage) → x at each stage input.
        fuse_spec: fn(stage, block) → bool: whole-block fused kernel
            (bottleneck archs, stride-1 blocks; inference only).
        use_kernels: False runs every kernel's plain version.
        partial_bn: every BN but the stem's runs on its running statistics
            and never updates them, in train mode too (flax's
            ``FrozenAwareBatchNorm(frozen=True)``).
        out_indices: return these stages' (N, h, w, C) outputs, in stage
            order, instead of the pooled features (mmaction's ResNetTSM
            taps, JAX ``resnet.py:336-340``).
        num_classes: > 0 adds the linear head ``fc`` on the pooled
            features (the image classifiers' zoo, JAX ``resnet.py:380``);
            0 returns the pooled features.
    """

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool = True,
                 width: int = 64,
                 shift_spec: Optional[Callable[[int, int], ShiftSpec]] = None,
                 pre_shift: Optional[Callable[[int, int], ShiftSpec]] = None,
                 stage_hook: Optional[Callable] = None,
                 fuse_spec: Optional[Callable[[int, int], bool]] = None,
                 use_kernels: bool = True, eps: float = 1e-5,
                 partial_bn: bool = False,
                 out_indices: Optional[Sequence[int]] = None,
                 num_classes: int = 0):
        super().__init__()
        self.out_indices = None if out_indices is None else tuple(out_indices)
        # the last block of each tapped stage
        self.tap_blocks = {f"layer{i + 1}_{stage_sizes[i] - 1}"
                           for i in self.out_indices or ()}
        self.conv1 = Conv(3, width, 7, 2, 3)
        self.bn1 = BatchNorm(width, eps)
        self.stage_hook = stage_hook
        self.use_kernels = use_kernels
        block_cls = Bottleneck if bottleneck else BasicBlock
        self.blocks = []  # (stage, name, pre-shift spec)
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** i
            out = filters * block_cls.expansion
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                kw = dict(shift=shift_spec(i, j) if shift_spec else None,
                          use_kernels=use_kernels, eps=eps,
                          frozen_bn=partial_bn)
                if bottleneck:
                    kw["fuse"] = bool(fuse_spec and fuse_spec(i, j))
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(
                    cin, filters, stride,
                    downsample=j == 0 and (stride != 1 or cin != out), **kw))
                self.blocks.append(
                    (i, name, pre_shift(i, j) if pre_shift else None))
                cin = out
        self.num_features = cin
        if num_classes > 0:
            self.fc = Dense(cin, num_classes)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor, spatial: bool = False,
                seg_lo: int = 0, seg_hi: int = 6):
        """``seg_lo``/``seg_hi`` run the segment range [seg_lo, seg_hi) for
        a pipeline stage (``parallel/pipeline.pipeline_apply_het``, JAX
        ``resnet.py:344-420``): segment 0 is the stem (conv1, bn1, pool),
        1-4 the residual stages, 5 the head (pool, ``fc``). With seg_lo >
        0, ``x`` is the activation at that boundary; with seg_hi < 6 the
        raw boundary activation is returned. Parameter names do not depend
        on the range, so a stage reads the same weights as the whole."""
        if not 0 <= seg_lo < seg_hi <= 6:
            raise ValueError(f"segment range [{seg_lo}, {seg_hi})")
        if (seg_lo, seg_hi) != (0, 6) and self.out_indices is not None:
            raise ValueError("a segment range has no out_indices taps")
        if seg_lo == 0:
            x = torch.relu(self.conv1(x, self.bn1))
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(
                0, 2, 3, 1)
        stage = -1
        taps = []
        for i, name, pre in self.blocks:
            if not seg_lo <= i + 1 < seg_hi:
                continue
            if i != stage:
                stage = i
                if self.stage_hook is not None:
                    x = self.stage_hook(x, i)
            if pre is not None:
                x = shift_input(x, pre, self.use_kernels)
            x = getattr(self, name)(x)
            if name in self.tap_blocks:
                taps.append(x)
        if self.out_indices is not None:
            return tuple(taps)
        if spatial or seg_hi < 6:
            return x
        x = x.mean(dim=(1, 2))
        return self.fc(x) if self.num_classes > 0 else x


def make_resnet(arch: str, num_classes: int = 1000, **kw) -> ResNet:
    """The zoo's ``arch`` (resnet18/34/50/101) with ``num_classes`` (0:
    the pooled features), JAX ``resnet._make``; ``kw`` as ``ResNet``'s."""
    return ResNet(STAGE_SIZES[arch], bottleneck=BOTTLENECK[arch],
                  num_classes=num_classes, **kw)


def resnet18(**kw) -> ResNet:
    return make_resnet("resnet18", **kw)


def resnet34(**kw) -> ResNet:
    return make_resnet("resnet34", **kw)


def resnet50(**kw) -> ResNet:
    return make_resnet("resnet50", **kw)


def resnet101(**kw) -> ResNet:
    return make_resnet("resnet101", **kw)
