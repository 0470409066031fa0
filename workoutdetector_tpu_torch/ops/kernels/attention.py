"""Softmax attention over one sequence per (sample, head):
o = softmax(q kᵀ · scale) v, and its gradient.

Port of the library Pallas TPU flash attention that
``workoutdetector_tpu/models/timesformer.py`` (``_flash_mha``) calls: the
forward and the backward of the library's ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``, with the plain versions of both. The forward
(which also writes each query row's log-sum-exp under autograd) has two
routes: where ``fwd_route`` takes the shape (dh 64, l ≤ 256), one block
per (sample, head) holds the slice's q, k and v in shared memory and takes
the exact softmax in one pass (``csrc/attention_fwd.cu``, counted in
``attention.launches``); elsewhere the tiled kernel streams K and V with an
online softmax (``csrc/attention.cu``, counted in
``attention_tiled.launches``). The backward has two routes (``attention_bwd``):
where one (sample, head) slice fits a block's shared memory
(``short_route``), one kernel (``csrc/attention_bwd_short.cu``) computes D =
rowsum(dO ∘ O), dQ, dK and dV in one launch; longer sequences go to the
tiled dK/dV and dQ kernels (``csrc/attention_bwd.cu``) with D formed by
``attention_delta`` beside them. In TimeSformer-B/16 (l = 197, dh = 64)
they run the spatial attention of every divided block: per train step 12
``attention`` and 12 ``attention_bwd`` launches. Bounds and designs: see the
notes at the top of the CUDA sources.

Layout: q, k, v are (n, h, l, dh), the JAX package's head-major layout;
``Attention`` takes the packed (n, l, 3·h·dh) qkv projection and returns
its gradient in the same packed layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from workoutdetector_tpu_torch.ops.kernels import _build

HEAD_DIMS = tuple(range(16, 129, 16))  # the head widths the kernels take

# The one-launch backward (csrc/attention_bwd_short.cu) keeps a whole
# (sample, head) slice in shared memory, in 128-byte rows (dh 64): q, k, v
# and dO in R = l rounded up to 16 rows each, dS in bf16 (one R-row tile per
# 64 queries, over o's rows), lse and D in fp32. A block may use
# SHORT_SMEM_MAX bytes.
SHORT_HEAD_DIMS = (64,)
SHORT_SMEM_MAX = 232448

# The one-block forward (csrc/attention_fwd.cu) loads each of q, k and v of
# a slice as one TMA box of R rows of 128 bytes (dh 64), R the first of
# FWD_ROWS that holds l (its compile-time instantiations; a box has at most
# 256 rows); S keeps R key columns in registers.
FWD_HEAD_DIMS = (64,)
FWD_ROWS = (64, 128, 208, 256)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain version: fp32 scores and softmax, the probabilities cast to
    v's dtype before the second product (fp32 sums), one rounding to v's
    dtype. (n, h, l, dh) → (n, h, l, dh)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.float()).to(v.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward under autograd: (o, lse) with lse the
    fp32 (n, h, l) log-sum-exp of each query row's scaled scores (natural
    log); o as ``attention_plain``'s, its probabilities exp(s − lse)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    return (p.float() @ v.float()).to(v.dtype), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ O) in fp32, contiguous (n, h, l): the term the tiled
    dK/dV and dQ kernels subtract from dP (a jnp op outside the TPU
    kernels; the one-launch kernel forms it itself)."""
    return (o.float() * do.float()).sum(-1).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, scale):
    """(dq, dk, dv) from the residuals, in fp32, as the kernels compute
    them: P recomputed from the log-sum-exp, P and dS rounded to q's dtype
    before the products that take them, each output rounded once."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    dv = p.to(q.dtype).float().transpose(-1, -2) @ dof
    ds = (p * (dof @ vf.transpose(-1, -2) - delta[..., None])
          ).to(q.dtype).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: (dq, dk, dv) of o = softmax(q kᵀ ·
    scale) v for the output gradient ``do``, from the forward's residuals
    (o and the fp32 log-sum-exp), not through autograd."""
    return _bwd_plain(q, k, v, do, lse, attention_delta(o, do), scale)


def _check(what: str, *tensors: torch.Tensor) -> Tuple[int, int, int, int]:
    """Refuse what the kernels do not take: tensors off q's CUDA device,
    dtypes other than bf16, unequal (n, h, l, dh) shapes, head widths
    outside HEAD_DIMS, strides that are not multiples of 8 over a unit last
    stride, bases not 16-byte aligned."""
    q = tensors[0]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: tensors on "
                         f"{', '.join(str(t.device) for t in tensors)}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{what} kernel takes bf16, got "
                        f"{'/'.join(str(t.dtype) for t in tensors)}")
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{what} kernel: shapes "
                         f"{[tuple(t.shape) for t in tensors]}: needs equal "
                         "(n, h, l, dh) shapes")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what} kernel: head width {q.shape[3]} not in "
                         f"{HEAD_DIMS}")
    for t in tensors:
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(
                f"{what} kernel: strides {t.stride()} at offset "
                f"{t.data_ptr() % 16}: needs a unit last stride, the others "
                "multiples of 8 and a 16-byte aligned base")
    return tuple(q.shape)


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def fwd_rows(l: int) -> int:
    """R, the rows of each of the one-block forward's q, k and v tiles for
    a slice of length l: the first of FWD_ROWS ≥ l, 0 where none is (or
    l < 1)."""
    return next((r for r in FWD_ROWS if l <= r), 0) if l >= 1 else 0


def fwd_smem(l: int) -> int:
    """Bytes of shared memory the one-block forward takes for a slice of
    length l at dh 64, as ``csrc/attention_fwd.cu``'s
    ``wd_attention_fwd_smem``: 1024 of alignment slack, q, k and v (R =
    ``fwd_rows(l)`` rows of 128 bytes each), two 8-byte mbarriers; 0 where
    the kernel does not take l."""
    r = fwd_rows(l)
    return 1024 + 3 * r * 128 + 16 if r else 0


def fwd_route(l: int, dh: int) -> bool:
    """The route rule of the forward: True where the one-block kernel takes
    (l, dh): dh in FWD_HEAD_DIMS and 1 ≤ l ≤ 256 (``fwd_smem`` > 0, at
    most 99,344 bytes: two blocks an SM); elsewhere the tiled kernel
    runs."""
    return dh in FWD_HEAD_DIMS and fwd_smem(l) > 0


def _launch(q, k, v, scale, with_lse: bool, tiled: bool = False):
    """Launch the forward kernel of the shape's route (``fwd_route``), or
    the tiled one where ``tiled``: o, the (n, h, l, dh) view of a
    contiguous (n, l, h, dh) buffer, and with ``with_lse`` the fp32 (n, h,
    l) log-sum-exp (else None)."""
    n, h, l, dh = _check("attention", q, k, v)
    # the one-block kernel takes each row's max of the raw scores: scale > 0
    short = not tiled and fwd_route(l, dh) and scale > 0
    out = torch.empty((n, l, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, l), dtype=torch.float32, device=q.device) \
        if with_lse else None
    lib = _build.load()
    fn = lib.lib.wd_attention_fwd_bf16 if short else lib.lib.wd_attention_bf16
    lib.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, _strides(q, k, v),
        n, h, l, dh, float(scale), q.device.index or 0,
        _build.stream_handle(q.device)), "attention")
    if short:
        attention.launches += 1
    else:
        attention_tiled.launches += 1
    return out.transpose(1, 2), lse


def attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, with_lse: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(o, lse or None) from the tiled forward kernel (``csrc/attention.cu``:
    K and V streamed in 64-row tiles, online softmax) for CUDA tensors
    (bf16), whatever the shape; the plain version for CPU ones.
    ``attention`` and ``attention_lse`` take this route where ``fwd_route``
    leaves a shape out (l > 256 or dh ≠ 64); its launches count here."""
    if q.device.type == "cpu":
        if with_lse:
            return attention_lse_plain(q, k, v, scale)
        return attention_plain(q, k, v, scale), None
    return _launch(q, k, v, scale, with_lse, tiled=True)


attention_tiled.launches = 0


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward kernel of the shape's route with the
    log-sum-exp the backward kernels read, for CUDA tensors (bf16; one
    ``attention`` or ``attention_tiled`` launch), the plain version for CPU
    ones."""
    if q.device.type == "cpu":
        return attention_lse_plain(q, k, v, scale)
    return _launch(q, k, v, scale, True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """The forward kernel of the shape's route (``fwd_route``: the
    one-block kernel, counted here, or the tiled one, counted in
    ``attention_tiled``) for CUDA tensors (bf16), the plain version for CPU
    ones.

    q, k, v may be any views with a unit last stride (e.g. thirds of a
    packed qkv projection); the kernel's result is the (n, h, l, dh) view
    of a contiguous (n, l, h, dh) buffer. Forward only: under autograd on
    CUDA it raises, and the caller runs ``Attention`` on the packed qkv
    projection, whose backward runs ``attention_bwd``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention() is forward only; under autograd run "
            "Attention.apply(qkv, num_heads, scale) on the packed projection")
    return _launch(q, k, v, scale, False)[0]


attention.launches = 0


def _backward(which: str, q, k, v, do, lse, delta, scale, dq, dk, dv):
    n, h, l, dh = _check(which, q, k, v, do, *(t for t in (dq, dk, dv)
                                              if t is not None))
    _check_vectors(which, (n, h, l), q.device, lse=lse, delta=delta)
    stand_in = q  # strides of an output the entry point does not write
    lib = _build.load()
    fn = getattr(lib.lib, f"wd_{which}_bf16")
    lib.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in (dq, dk, dv)),
        _strides(q, k, v, do, *(t if t is not None else stand_in
                                for t in (dq, dk, dv))),
        n, h, l, dh, float(scale), q.device.index or 0,
        _build.stream_handle(q.device)), which)


def _check_vectors(what: str, shape, device, **vectors) -> None:
    """Refuse per-row fp32 vectors (lse, D) that are not contiguous fp32 of
    ``shape`` on ``device``."""
    for name, t in vectors.items():
        if t.shape != shape or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != device:
            raise ValueError(f"{what} kernel: {' and '.join(vectors)} must be "
                             f"contiguous fp32 {shape} on {device}, {name} is "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _out(like: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, device=like.device) \
        if out is None else out


def attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: float, dk: Optional[torch.Tensor] = None,
                  dv: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of the attention, the tiled dK/dV kernel for CUDA tensors
    (bf16) and the plain version for CPU ones: ``attention_bwd``'s route
    for sequences too long for one block. lse, delta: fp32 (n, h, l) from
    the forward and ``attention_delta``. Written into ``dk`` and ``dv``
    when given (any views with a unit last stride, e.g. thirds of a
    packed gradient), else into new (n, h, l, dh) tensors."""
    dk, dv = _out(k, dk), _out(v, dv)
    if q.device.type == "cpu":
        _, gk, gv = _bwd_plain(q, k, v, do, lse, delta, scale)
        return dk.copy_(gk), dv.copy_(gv)
    _backward("attention_dkv", q, k, v, do, lse, delta, scale, None, dk, dv)
    attention_dkv.launches += 1
    return dk, dv


attention_dkv.launches = 0


def attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 scale: float, dq: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """dQ of the attention, the tiled dQ kernel for CUDA tensors (bf16) and
    the plain version for CPU ones; arguments as ``attention_dkv``'s."""
    dq = _out(q, dq)
    if q.device.type == "cpu":
        return dq.copy_(_bwd_plain(q, k, v, do, lse, delta, scale)[0])
    _backward("attention_dq", q, k, v, do, lse, delta, scale, dq, None, None)
    attention_dq.launches += 1
    return dq


attention_dq.launches = 0


def short_smem(l: int) -> int:
    """Bytes of shared memory the one-launch backward takes for one
    (sample, head) slice of length l at dh 64, as
    ``csrc/attention_bwd_short.cu``'s ``short_smem``: 1024 of alignment
    slack, q, k, v and dO (R = l rounded up to 16 rows of 128 bytes each),
    dS in o's place (one R-row tile per 64 queries), lse and D in fp32, two
    8-byte mbarriers."""
    r = -(-l // 16) * 16
    return 1024 + 4 * r * 128 + -(-r // 64) * r * 128 + 2 * r * 4 + 16


def short_route(l: int, dh: int) -> bool:
    """The route rule of ``attention_bwd``: True where the one-launch kernel
    takes (l, dh): dh in SHORT_HEAD_DIMS and the slice within
    SHORT_SMEM_MAX bytes of shared memory (``short_smem``), i.e.
    1 ≤ l ≤ 224 at dh 64; elsewhere the tiled dK/dV and dQ kernels run."""
    return dh in SHORT_HEAD_DIMS and l > 0 and short_smem(l) <= SHORT_SMEM_MAX


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float, dq: Optional[torch.Tensor] = None,
                  dk: Optional[torch.Tensor] = None,
                  dv: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of o = softmax(q kᵀ · scale) v for the output gradient
    ``do``, from the forward's residuals (o and the fp32 (n, h, l)
    log-sum-exp from ``attention_lse``), written into ``dq``, ``dk``,
    ``dv`` when given (any views with a unit last stride, e.g. the thirds
    of a packed gradient), else into new (n, h, l, dh) tensors.

    CPU tensors: ``attention_bwd_plain``. CUDA tensors (bf16): where
    ``short_route(l, dh)``, one launch of the kernel that computes D, dQ,
    dK and dV (counted in ``attention_bwd.launches``); elsewhere the tiled
    route,
    ``attention_delta`` then ``attention_dkv`` and ``attention_dq``
    (counted in theirs). Anything else raises."""
    dq, dk, dv = _out(q, dq), _out(k, dk), _out(v, dv)
    if q.device.type == "cpu":
        for out, g in zip((dq, dk, dv),
                          attention_bwd_plain(q, k, v, o, lse, do, scale)):
            out.copy_(g)
        return dq, dk, dv
    n, h, l, dh = _check("attention_bwd", q, k, v, do, o, dq, dk, dv)
    _check_vectors("attention_bwd", (n, h, l), q.device, lse=lse)
    if not short_route(l, dh):
        delta = attention_delta(o, do)
        attention_dkv(q, k, v, do, lse, delta, scale, dk, dv)
        attention_dq(q, k, v, do, lse, delta, scale, dq)
        return dq, dk, dv
    lib = _build.load()
    lib.check(lib.lib.wd_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, o, dq, dk, dv), n, h, l, dh, float(scale),
        q.device.index or 0, _build.stream_handle(q.device)),
        "attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


def split_heads(x: torch.Tensor, num_heads: int, parts: int = 3):
    """(n, l, parts·h·dh) → ``parts`` views (n, h, l, dh), one per
    contiguous h·dh slice of the last dim (3 for a packed qkv projection)."""
    n, l, c = x.shape
    return [t.view(n, l, num_heads, -1).transpose(1, 2)
            for t in x.split(c // parts, dim=-1)]


class Attention(torch.autograd.Function):
    """softmax(q kᵀ · scale) v over a packed (n, l, 3·h·dh) qkv projection
    → (n, l, h·dh), with its gradient in the packed layout.

    On CUDA (bf16) the forward kernel writes o and the log-sum-exp, which
    are saved with qkv; the backward is one ``attention_bwd`` call, which
    writes dQ, dK and dV into the thirds of one packed gradient, so the
    qkv projection's backward reads it as it is (at TimeSformer's l = 197
    one launch that also forms D). On the CPU the same steps run the
    plain versions."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float
                ) -> torch.Tensor:
        n, l, _ = qkv.shape
        q, k, v = split_heads(qkv, num_heads)
        o, lse = attention_lse(q, k, v, scale)
        o = o.transpose(1, 2).reshape(n, l, -1)  # a view of the kernel's buffer
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, o, lse = ctx.saved_tensors
        h = ctx.num_heads
        q, k, v = split_heads(qkv, h)
        (o4,) = split_heads(o, h, parts=1)
        (do4,) = split_heads(do.contiguous(), h, parts=1)
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        attention_bwd(q, k, v, o4, lse, do4, ctx.scale, *split_heads(dqkv, h))
        return dqkv, None, None
