"""Learned person detector: an anchor-free CenterNet.

Port of ``workoutdetector_tpu/models/detector.py``. A convolutional
backbone (``TinyFCN``, stride 8, or the shared ResNet's pre-pool map,
stride 32) and a head that predicts a centre heatmap, the box width and
height, and the sub-cell offset. Decoding is one top-k on the host.

Pieces:
  * ``CenterNetDetector`` — the module (NHWC in, a dict of fp32 maps out).
  * ``gaussian_targets`` / ``detection_loss`` — targets (numpy, on the
    host) and the penalty-reduced focal loss + L1 (torch).
  * ``decode_boxes`` — heatmaps → (x1, y1, x2, y2, score) boxes, numpy.
  * ``LearnedDetectorBackend`` — the ``data/person.Detector`` backend
    (clip → per-frame boxes) with ``save`` / ``load``: ``load`` reads the
    JAX package's flax msgpack file or the port's own ``torch.save`` file.
  * ``train_detector`` / ``distill_from_videos`` — Adam on (images,
    boxes), or on motion pseudo-labels of real videos.

Module and parameter names follow the flax tree (``backbone/conv{i}``,
``backbone/bn{i}``, ``head_conv``, ``hm``, ``wh``, ``offset``, the
ResNet's own names under ``backbone``), so ``models/convert.
load_flax_variables`` carries JAX variables across. The detector's own
BatchNorms are flax's default ``nn.BatchNorm`` (momentum 0.99); the ResNet
backbone keeps its 0.9.

The hand kernels take bf16 only, so the backbone is chosen at
construction by ``dtype`` (``resnet_backbone``): in bf16 a ResNet's
stride-1 bottlenecks of stages 0 and 1 are fused-block kernels at
inference and its 1×1 convs take the dx/dW kernels under autograd, as
``ImageClassifier`` builds them; in any other dtype the ResNet runs as
torch ops. ``TinyFCN`` has no kernel.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.convert import (init_flax_variables,
                                                      load_flax_variables)
from workoutdetector_tpu_torch.models.resnet import (BatchNorm, Conv,
                                                     ResNet, make_resnet)
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip

FLAX_BN_MOMENTUM = 0.99  # flax nn.BatchNorm's default


class TinyFCN(nn.Module):
    """Three 3×3 stride-2 convs, each with BN and ReLU: stride 8, widths
    ``width``, 2·``width``, 4·``width``. Runs in its input's dtype."""

    def __init__(self, width: int = 32):
        super().__init__()
        cin = 3
        for i, w in enumerate((width, width * 2, width * 4)):
            self.add_module(f"conv{i + 1}", Conv(cin, w, 3, 2, 1))
            self.add_module(f"bn{i + 1}",
                            BatchNorm(w, momentum=FLAX_BN_MOMENTUM))
            cin = w
        self.num_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"conv{i}")(
                x, getattr(self, f"bn{i}")))
        return x


def resnet_backbone(arch: str, dtype: torch.dtype,
                    use_kernels: bool = True) -> ResNet:
    """The headless ResNet under a detector or pose head. In bf16 (with
    ``use_kernels``) its stride-1 bottlenecks of stages 0 and 1 are
    fused-block kernels at inference and its 1×1 convs take the dx/dW
    kernels under autograd; in any other dtype every op is a torch op,
    since the kernels take bf16 only."""
    kernels_on = use_kernels and dtype == torch.bfloat16
    return make_resnet(arch, 0, use_kernels=kernels_on,
                       fuse_spec=(lambda i, j: i in (0, 1))
                       if kernels_on else None)


def backbone_features(backbone: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The backbone's feature map: ``TinyFCN``'s output, or the ResNet's
    pre-pool map (``spatial=True``)."""
    if isinstance(backbone, ResNet):
        return backbone(x, spatial=True)
    return backbone(x)


class CenterNetDetector(nn.Module):
    """Centre-point detector: (B, H, W, 3) ImageNet-normalized float →
    dict(heatmap (B, h, w, 1) logits, wh (B, h, w, 2), offset (B, h, w,
    2)), fp32, at ``stride`` (8 for ``tiny``, 32 for a ResNet). Computes
    in ``dtype``, parameters fp32. Built in eval mode; ``train()`` turns on
    the BatchNorm batch statistics. ``use_kernels=False`` builds the plain
    reference."""

    # the focal-loss prior, p ≈ 0.1 (``init_flax_variables``)
    FLAX_BIAS_INIT = {"hm": -2.19}

    def __init__(self, backbone: str = "tiny", head_width: int = 64,
                 dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.backbone_name = backbone
        self.head_width = head_width
        self.dtype = dtype
        if backbone == "tiny":
            self.backbone = TinyFCN()
        else:
            self.backbone = resnet_backbone(backbone, dtype, use_kernels)
        cin = self.backbone.num_features
        self.head_conv = Conv(cin, head_width, 3, 1, 1, bias=True)
        self.hm = Conv(head_width, 1, 1, bias=True)
        self.wh = Conv(head_width, 2, 1, bias=True)
        self.offset = Conv(head_width, 2, 1, bias=True)
        self.eval()

    @property
    def stride(self) -> int:
        return 8 if self.backbone_name == "tiny" else 32

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = backbone_features(self.backbone, x.to(self.dtype))
        y = torch.relu(self.head_conv(feat))
        return {"heatmap": self.hm(y).float(), "wh": self.wh(y).float(),
                "offset": self.offset(y).float()}


# ---------------------------------------------------------------- targets


def gaussian_targets(boxes: np.ndarray, hw: Tuple[int, int],
                     stride: int) -> Dict[str, np.ndarray]:
    """CenterNet training targets for ONE image.

    Args:
        boxes: (N, 4) pixel-space (x1, y1, x2, y2); N may be 0.
        hw: (H, W) of the *input image*.
        stride: model output stride.
    Returns:
        heatmap (h, w, 1), wh (h, w, 2), offset (h, w, 2),
        mask (h, w, 1) — 1 at centre cells (regression loss support).
    """
    h, w = hw[0] // stride, hw[1] // stride
    hm = np.zeros((h, w, 1), np.float32)
    wh = np.zeros((h, w, 2), np.float32)
    off = np.zeros((h, w, 2), np.float32)
    mask = np.zeros((h, w, 1), np.float32)
    for x1, y1, x2, y2 in np.asarray(boxes, np.float32).reshape(-1, 4):
        bw, bh = (x2 - x1) / stride, (y2 - y1) / stride
        if bw <= 0 or bh <= 0:
            continue
        cx, cy = (x1 + x2) / 2 / stride, (y1 + y2) / 2 / stride
        ci, cj = int(np.clip(cy, 0, h - 1)), int(np.clip(cx, 0, w - 1))
        sigma = max(1.0, (bw + bh) / 12.0)
        yy, xx = np.mgrid[0:h, 0:w]
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))
        # the quantized centre cell is the positive: with a fractional
        # (cx, cy) no cell would reach the focal loss's positive threshold
        g[ci, cj] = 1.0
        hm[..., 0] = np.maximum(hm[..., 0], g)
        wh[ci, cj] = (bw, bh)
        off[ci, cj] = (cx - cj, cy - ci)
        mask[ci, cj] = 1.0
    return {"heatmap": hm, "wh": wh, "offset": off, "mask": mask}


def detection_loss(out: Mapping[str, torch.Tensor],
                   tgt: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Penalty-reduced focal loss on the heatmap + masked L1 on wh (×0.1)
    and offset (the CenterNet objective); positives where the target
    heatmap is ≥ 0.999."""
    p = torch.sigmoid(out["heatmap"])
    gt = tgt["heatmap"]
    pos = (gt >= 0.999).float()
    eps = 1e-6
    pos_loss = -pos * ((1 - p) ** 2) * torch.log(p + eps)
    neg_loss = -(1 - pos) * ((1 - gt) ** 4) * (p ** 2) * torch.log(1 - p + eps)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    focal = (pos_loss + neg_loss).sum() / n_pos
    m = tgt["mask"]
    n_m = torch.clamp(m.sum(), min=1.0)
    l1 = ((out["wh"] - tgt["wh"]).abs().sum(-1, keepdim=True) * m).sum() / n_m
    l1o = ((out["offset"] - tgt["offset"]).abs().sum(-1, keepdim=True)
           * m).sum() / n_m
    return focal + 0.1 * l1 + l1o


# ---------------------------------------------------------------- decode


def decode_boxes(out: Mapping[str, np.ndarray], stride: int, k: int = 4,
                 threshold: float = 0.3) -> List[np.ndarray]:
    """Batch heatmaps → per-image (N, 5) boxes (x1, y1, x2, y2, score).

    3×3 local-max suppression (CenterNet's stand-in for NMS) + top-k +
    score threshold, in numpy on the host.
    """
    hm = 1.0 / (1.0 + np.exp(-np.asarray(out["heatmap"])[..., 0]))  # (B,h,w)
    wh = np.asarray(out["wh"])
    off = np.asarray(out["offset"])
    b, h, w = hm.shape
    results: List[np.ndarray] = []
    for i in range(b):
        m = hm[i]
        padded = np.pad(m, 1, constant_values=-1.0)
        windows = np.stack([padded[dy:dy + h, dx:dx + w]
                            for dy in range(3) for dx in range(3)])
        keep = m >= windows.max(axis=0)
        scores = np.where(keep, m, 0.0).reshape(-1)
        order = np.argsort(scores)[::-1][:k]
        boxes = []
        for idx in order:
            s = scores[idx]
            if s < threshold:
                break
            ci, cj = divmod(int(idx), w)
            cx = (cj + off[i, ci, cj, 0]) * stride
            cy = (ci + off[i, ci, cj, 1]) * stride
            bw = max(wh[i, ci, cj, 0], 0.0) * stride
            bh = max(wh[i, ci, cj, 1], 0.0) * stride
            boxes.append([cx - bw / 2, cy - bh / 2,
                          cx + bw / 2, cy + bh / 2, s])
        results.append(np.asarray(boxes, np.float32).reshape(-1, 5))
    return results


# ---------------------------------------------------------- weight files


def save_weights(path: str, model: nn.Module, input_size: int) -> None:
    """The port's own file: ``torch.save`` of the state dict with the
    model's class, backbone, head width, dtype and ``input_size`` beside
    it, so ``read_weights`` needs no guess."""
    torch.save({"kind": type(model).__name__,
                "backbone": model.backbone_name,
                "head_width": model.head_width,
                "dtype": str(model.dtype).removeprefix("torch."),
                "input_size": int(input_size),
                "state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}},
               path)


def read_weights(path: str, cls, backbone: str, input_size: int
                 ) -> Tuple[nn.Module, int]:
    """(model of ``cls`` on the CPU with its weights, input size) from a
    port file (``save_weights``: its own backbone, dtype and input size)
    or a JAX flax msgpack file (``backbone`` and ``input_size`` as given,
    fp32, as the JAX ``load`` builds it)."""
    with open(path, "rb") as f:
        zipped = f.read(2) == b"PK"  # torch.save writes a zip archive
    if zipped:
        d = torch.load(path, map_location="cpu", weights_only=True)
        if d.get("kind") != cls.__name__:
            raise ValueError(f"{path} holds a {d.get('kind')}, not a "
                             f"{cls.__name__}")
        dtype = getattr(torch, d["dtype"], None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"{path}: unknown dtype {d['dtype']!r}")
        model = cls(backbone=d["backbone"], head_width=d["head_width"],
                    dtype=dtype)
        model.load_state_dict(d["state_dict"])
        return model, int(d["input_size"])
    from workoutdetector_tpu_torch.utils.flax_file import read_flax_msgpack
    model = cls(backbone=backbone)
    load_flax_variables(model, read_flax_msgpack(path))
    return model, input_size


class ClipBatcher:
    """The clip → resized, zero-padded batches → fp32 maps plumbing that
    ``LearnedDetectorBackend`` and ``pose.PoseEstimator`` share. A lock
    serializes forwards, so loader threads may share one instance."""

    def __init__(self, model: nn.Module, input_size: int, batch: int,
                 device: Union[str, torch.device]):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.input_size = input_size
        self.batch = batch
        self._lock = threading.Lock()

    def _resized(self, clip: np.ndarray) -> np.ndarray:
        import cv2
        s = self.input_size
        return np.stack([cv2.resize(f, (s, s)) for f in clip])

    def _forward(self, chunk: np.ndarray) -> Any:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        with self._lock, torch.no_grad():
            return self.model(normalize_clip(x))

    def _chunks(self, resized: np.ndarray):
        """(maps of each padded batch, real rows in it)."""
        for i in range(0, len(resized), self.batch):
            chunk = resized[i:i + self.batch]
            pad = self.batch - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            yield self._forward(chunk), self.batch - pad


# ---------------------------------------------------------------- backend


class LearnedDetectorBackend(ClipBatcher):
    """``data/person.Detector`` backend: clip (T, H, W, 3) uint8 → list of
    per-frame (N_t, 4) boxes in the clip's pixels.

    Frames are resized on the host (cv2) to ``input_size`` squares and
    run in batches of ``batch``, the last one padded with zeros, on
    ``device`` (default ``"cuda"``; it raises without a card unless the
    caller names the CPU). ``model`` carries its weights.
    """

    def __init__(self, model: CenterNetDetector, input_size: int = 128,
                 threshold: float = 0.3, batch: int = 16,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(model, input_size, batch, device)
        self.threshold = threshold

    def heatmaps(self, clip: np.ndarray) -> Dict[str, np.ndarray]:
        """The clip's maps (heatmap logits, wh, offset), (T, h, w, ·)."""
        outs: Dict[str, List[np.ndarray]] = {"heatmap": [], "wh": [],
                                             "offset": []}
        for o, n in self._chunks(self._resized(clip)):
            for key in outs:
                outs[key].append(o[key][:n].cpu().numpy())
        return {key: np.concatenate(v) for key, v in outs.items()}

    def __call__(self, clip: np.ndarray,
                 threshold: Optional[float] = None) -> List[np.ndarray]:
        t, h, w = clip.shape[:3]
        s = self.input_size
        per_frame = decode_boxes(
            self.heatmaps(clip), self.model.stride,
            threshold=self.threshold if threshold is None else threshold)
        sx, sy = w / s, h / s
        scale = np.asarray([sx, sy, sx, sy], np.float32)
        return [b[:, :4] * scale for b in per_frame]

    def save(self, path: str) -> None:
        """The port's own file (``save_weights``)."""
        save_weights(path, self.model, self.input_size)

    @classmethod
    def load(cls, path: str, backbone: str = "tiny", input_size: int = 128,
             threshold: float = 0.3,
             device: Union[str, torch.device] = "cuda"
             ) -> "LearnedDetectorBackend":
        """A backend from the port's file or the JAX package's flax
        msgpack file (``backbone`` and ``input_size`` apply to the latter;
        the port's file names its own)."""
        dev = resolve_device(device)
        model, size = read_weights(path, CenterNetDetector, backbone,
                                   input_size)
        return cls(model, input_size=size, threshold=threshold, device=dev)


def distill_from_videos(video_paths: List[str],
                        steps: int = 600,
                        size: int = 128,
                        frame_stride: int = 2,
                        agg_window: int = 12,
                        decode_scale: int = 256,
                        lr: float = 1e-3,
                        batch: int = 16,
                        seed: int = 0,
                        backbone: str = "tiny",
                        device: Union[str, torch.device] = "cuda"
                        ) -> LearnedDetectorBackend:
    """Distill the aggregated-motion teacher into a CenterNet on real
    footage, with no annotation.

    Each video is decoded at short side ``decode_scale``;
    ``data.person.aggregate_motion_boxes`` labels its frames; every
    ``frame_stride``-th frame is resized to the backend's square input
    with its box mapped along (the geometry of
    ``LearnedDetectorBackend.__call__``), plus its mirrored twin; frames
    where the teacher abstains train as background. Then
    ``train_detector`` on ``device``.
    """
    import cv2

    from workoutdetector_tpu_torch.data.person import aggregate_motion_boxes
    from workoutdetector_tpu_torch.data.transforms import resize_short_side
    from workoutdetector_tpu_torch.data.video import VideoReader

    dev = resolve_device(device)
    frames, boxes = [], []
    for path in video_paths:
        with VideoReader(path) as r:
            clip = resize_short_side(r.read_raw(), decode_scale)
        agg = aggregate_motion_boxes(clip, window=agg_window)
        h, w = clip.shape[1:3]
        sx, sy = size / w, size / h
        for i in range(0, len(clip), frame_stride):
            img = cv2.resize(clip[i], (size, size))
            if len(agg[i]):
                b = agg[i][0] * np.asarray([sx, sy, sx, sy], np.float32)
                bs = b[None]
            else:
                bs = np.zeros((0, 4), np.float32)
            frames.append(img)
            boxes.append(bs)
            frames.append(img[:, ::-1].copy())  # mirrored twin
            if len(bs):
                fb = bs.copy()
                fb[:, 0], fb[:, 2] = size - bs[:, 2], size - bs[:, 0]
                boxes.append(fb)
            else:
                boxes.append(bs)
    return train_detector(np.stack(frames), boxes, steps=steps, lr=lr,
                          batch=batch, backbone=backbone, seed=seed,
                          device=dev)


def start_model(model: nn.Module, seed: int,
                device: torch.device) -> nn.Module:
    """``model`` with the port's initializers drawn from ``seed`` (flax's
    distributions, not ``jax.random``'s draws), on ``device`` in train
    mode."""
    load_flax_variables(model, init_flax_variables(model, seed))
    return model.to(device).train()


def train_detector(scenes: np.ndarray, boxes: List[np.ndarray],
                   steps: int = 200, lr: float = 1e-3, batch: int = 8,
                   backbone: str = "tiny", seed: int = 0,
                   log_every: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> LearnedDetectorBackend:
    """Fit an fp32 ``CenterNetDetector`` on (images, per-image boxes) with
    Adam (β 0.9 / 0.999, eps 1e-8: optax's defaults).

    Args:
        scenes: (N, S, S, 3) uint8 images, moved to ``device`` once.
        boxes: list of (K_i, 4) pixel boxes per image.
    Starts from the port's initializers drawn from ``seed``; batches are
    ``np.random.default_rng(seed).integers(0, N, (batch,))`` draws, the
    JAX function's. Returns a ready backend on ``device``.
    """
    dev = resolve_device(device)
    model = start_model(CenterNetDetector(backbone=backbone), seed, dev)
    size = scenes.shape[1]
    tgts = [gaussian_targets(b, (size, size), model.stride) for b in boxes]
    stacked = {key: torch.from_numpy(np.stack([t[key] for t in tgts])).to(dev)
               for key in ("heatmap", "wh", "offset", "mask")}
    images = torch.from_numpy(np.ascontiguousarray(scenes)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(seed)
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(scenes), (batch,))).to(dev)
        out = model(normalize_clip(images[idx]))
        loss = detection_loss(out, {k: v[idx] for k, v in stacked.items()})
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (s + 1) % log_every == 0:
            print(f"detector step {s + 1}: loss {float(loss):.4f}")
    return LearnedDetectorBackend(model.eval(), input_size=size, device=dev)
