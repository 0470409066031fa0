"""Top-down 2D pose estimation with a heatmap head.

Port of ``workoutdetector_tpu/models/pose.py`` (SimpleBaseline-style): the
detector's backbone (``TinyFCN`` or the ResNet's pre-pool map), 1 or 3
transposed convs 4×4 stride 2 with BN and ReLU, and a 17-channel 1×1
heatmap conv; decoding is a per-channel argmax on the host.

flax's ``nn.ConvTranspose(F, (4, 4), (2, 2), padding="SAME")`` neither
flips its kernel nor pads as ``torch.nn.ConvTranspose2d`` does: it equals
``F.conv_transpose2d(x, w, stride=2, padding=1)`` with ``w`` the flax
kernel flipped in both spatial axes and laid out (in, out, kh, kw).
``Deconv`` keeps the flax kernel under the generic 4-D weight map
(``models/convert.py``: (out, in, kh, kw), unflipped) and flips and swaps
it at the call. Names follow the flax tree (``backbone``, ``deconv{i}``,
``debn{i}``, ``hm``); the BNs are flax's default (momentum 0.99). The
backbone's dtype rule is the detector's (``detector.resnet_backbone``).
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.detector import (FLAX_BN_MOMENTUM,
                                                       TinyFCN, ClipBatcher,
                                                       backbone_features,
                                                       read_weights,
                                                       resnet_backbone,
                                                       save_weights,
                                                       start_model)
from workoutdetector_tpu_torch.models.resnet import BatchNorm, Conv
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip

NUM_KEYPOINTS = 17  # COCO-17 layout (utils/visualize.COCO_PAIRS)


class Deconv(nn.Module):
    """flax ``ConvTranspose(cout, (4, 4), (2, 2), padding="SAME")`` on NHWC:
    (N, H, W, cin) → (N, 2H, 2W, cout), in x's dtype. ``weight`` is the
    flax kernel under the generic 4-D map, (cout, cin, 4, 4) unflipped."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.transpose(0, 1).flip(2, 3).to(x.dtype)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w,
                               self.bias.to(x.dtype), stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


class TopDownPose(nn.Module):
    """(B, S, S, 3) normalized float → (B, S/4, S/4, 17) fp32 heatmaps.
    Computes in ``dtype``, parameters fp32; built in eval mode.
    ``use_kernels=False`` builds the plain reference."""

    def __init__(self, backbone: str = "tiny", head_width: int = 64,
                 dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.backbone_name = backbone
        self.head_width = head_width
        self.dtype = dtype
        if backbone == "tiny":
            self.backbone = TinyFCN()
            self.n_up = 1  # stride 8 → 4
        else:
            self.backbone = resnet_backbone(backbone, dtype, use_kernels)
            self.n_up = 3  # stride 32 → 4
        cin = self.backbone.num_features
        for i in range(self.n_up):
            self.add_module(f"deconv{i + 1}", Deconv(cin, head_width))
            self.add_module(f"debn{i + 1}",
                            BatchNorm(head_width, momentum=FLAX_BN_MOMENTUM))
            cin = head_width
        self.hm = Conv(head_width, NUM_KEYPOINTS, 1, bias=True)
        self.eval()

    @property
    def stride(self) -> int:
        return 4  # after upsampling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = backbone_features(self.backbone, x.to(self.dtype))
        for i in range(1, self.n_up + 1):
            y = torch.relu(getattr(self, f"debn{i}")(
                getattr(self, f"deconv{i}")(y)))
        return self.hm(y).float()


def keypoint_targets(kps: np.ndarray, input_size: int, stride: int = 4,
                     sigma: float = 1.5) -> np.ndarray:
    """(17, 2) pixel keypoints → (s, s, 17) gaussian heatmaps
    (s = input_size // stride). NaN/out-of-frame keypoints → zero map."""
    s = input_size // stride
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    maps = np.zeros((s, s, NUM_KEYPOINTS), np.float32)
    for k, (x, y) in enumerate(np.asarray(kps, np.float32)):
        if not np.isfinite(x) or not np.isfinite(y):
            continue
        cx, cy = x / stride, y / stride
        if not (0 <= cx < s and 0 <= cy < s):
            continue
        maps[..., k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) /
                              (2 * sigma ** 2))
    return maps


def decode_keypoints(heatmaps: np.ndarray, stride: int = 4
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, s, s, 17) heatmaps → ((B, 17, 2) xy pixels, (B, 17) scores)."""
    hm = np.asarray(heatmaps)
    b, h, w, k = hm.shape
    flat = hm.reshape(b, h * w, k)
    idx = flat.argmax(axis=1)  # (B, 17)
    scores = np.take_along_axis(flat, idx[:, None, :], axis=1)[:, 0, :]
    ys, xs = np.divmod(idx, w)
    xy = np.stack([xs, ys], axis=-1).astype(np.float32) * stride + stride / 2
    return xy, scores


class PoseEstimator(ClipBatcher):
    """Batched clip → (T, 17, 3) keypoints on ``device`` (default
    ``"cuda"``; it raises without a card unless the caller names the CPU),
    with ``save`` / ``load`` as the detector backend's. ``model`` carries
    its weights."""

    def __init__(self, model: TopDownPose, input_size: int = 128,
                 batch: int = 16, device: Union[str, torch.device] = "cuda"):
        super().__init__(model, input_size, batch, device)

    def heatmaps(self, clip: np.ndarray) -> np.ndarray:
        """(T, S/4, S/4, 17) heatmaps of the resized clip."""
        return np.concatenate([o[:n].cpu().numpy() for o, n in
                               self._chunks(self._resized(clip))])

    def estimate_clip(self, clip: np.ndarray) -> np.ndarray:
        """clip (T, H, W, 3) uint8 → (T, 17, 3) [x, y, score] in the
        clip's pixels."""
        h, w = clip.shape[1:3]
        s = self.input_size
        xy, scores = decode_keypoints(self.heatmaps(clip), self.model.stride)
        xy *= np.asarray([w / s, h / s], np.float32)
        return np.concatenate([xy, scores[..., None]], axis=-1)

    def save(self, path: str) -> None:
        """The port's own file (``detector.save_weights``)."""
        save_weights(path, self.model, self.input_size)

    @classmethod
    def load(cls, path: str, backbone: str = "tiny", input_size: int = 128,
             device: Union[str, torch.device] = "cuda") -> "PoseEstimator":
        """An estimator from the port's file or the JAX package's flax
        msgpack file (``backbone`` and ``input_size`` apply to the latter;
        the port's file names its own)."""
        dev = resolve_device(device)
        model, size = read_weights(path, TopDownPose, backbone, input_size)
        return cls(model, input_size=size, device=dev)


def train_pose(images: np.ndarray, keypoints: List[np.ndarray],
               steps: int = 200, lr: float = 2e-3, batch: int = 8,
               backbone: str = "tiny", seed: int = 0, log_every: int = 0,
               device: Union[str, torch.device] = "cuda") -> PoseEstimator:
    """Fit an fp32 ``TopDownPose`` on (images (N, S, S, 3) uint8,
    per-image (17, 2) keypoints) with the MSE heatmap loss × 100 and Adam
    (optax's defaults), from the port's initializers drawn from ``seed``;
    batches are the JAX function's ``default_rng(seed)`` draws."""
    dev = resolve_device(device)
    model = start_model(TopDownPose(backbone=backbone), seed, dev)
    size = images.shape[1]
    tgts = torch.from_numpy(np.stack([keypoint_targets(k, size, model.stride)
                                      for k in keypoints])).to(dev)
    x_all = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(seed)
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(images), (batch,))).to(dev)
        out = model(normalize_clip(x_all[idx]))
        loss = torch.mean((out - tgts[idx]) ** 2) * 100.0
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (s + 1) % log_every == 0:
            print(f"pose step {s + 1}: loss {float(loss):.4f}")
    return PoseEstimator(model.eval(), input_size=size, device=dev)
