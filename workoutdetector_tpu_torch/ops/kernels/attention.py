"""Softmax attention over one sequence per (sample, head):
o = softmax(q kᵀ · scale) v.

Port of the library Pallas TPU flash attention that
``workoutdetector_tpu/models/timesformer.py`` (``_flash_mha``) calls,
forward only: the hand kernel in ``csrc/attention.cu`` and its plain
version. In TimeSformer it runs the spatial attention of every divided
block (12 launches per ViT-B forward). Bound and design: see the note at
the top of the CUDA source.

Layout: q, k, v are (n, h, l, dh), the JAX package's head-major layout.
"""

from __future__ import annotations

import ctypes

import torch

from workoutdetector_tpu_torch.ops.kernels import _build

HEAD_DIMS = tuple(range(16, 129, 16))  # the head widths the kernel takes


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain version: fp32 scores and softmax, the probabilities cast to
    v's dtype before the second product (fp32 sums), one rounding to v's
    dtype. (n, h, l, dh) → (n, h, l, dh)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p.float() @ v.float()).to(v.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """The kernel for CUDA tensors (bf16), the plain version for CPU ones.

    q, k, v may be any views with a unit last stride (e.g. thirds of a
    packed qkv projection); the kernel's result is the (n, h, l, dh) view
    of a contiguous (n, l, h, dh) buffer. Forward only: under autograd
    on CUDA it raises (the backward kernels are ROADMAP's TimeSformer
    training slice)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention kernel is forward only: its backward (dQ, dK, dV) is "
            "queued with the TimeSformer training slice (ROADMAP §1 slice 6)")
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"attention kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: needs equal "
                         "(n, h, l, dh) shapes")
    n, h, l, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention kernel: head width {dh} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(
                f"attention kernel: {name} strides {t.stride()} at offset "
                f"{t.data_ptr() % 16}: needs a unit last stride, the others "
                "multiples of 8 and a 16-byte aligned base")
    out = torch.empty((n, l, h, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(s for t in (q, k, v)
                                     for s in t.stride()[:3]))
    lib = _build.load()
    lib.check(lib.lib.wd_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        n, h, l, dh, float(scale), q.device.index or 0,
        _build.stream_handle(q.device)), "attention")
    attention.launches += 1
    return out.transpose(1, 2)


attention.launches = 0
