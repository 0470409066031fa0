"""Inference engine: uint8 frame windows → logits on the device.

Port of ``workoutdetector_tpu/infer/engine.py`` (``InferenceEngine``):
windows are scored in fixed batches of ``window_batch`` (the tail chunk
zero-padded, like the reference's zero-padded tail), the normalize runs on
the device, and ``score_video`` uploads a decoded video once and gathers
its sparse windows there (``ops.preprocess.preprocess_windows``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.timesformer import fold_for_inference
from workoutdetector_tpu_torch.ops.preprocess import (normalize_clip,
                                                      preprocess_windows)


class InferenceEngine:
    """Wraps a model into a fixed-batch scoring function on one device.

    Args:
        model: module whose forward(x (B, T, H, W, C) float) → logits.
        num_segments: frames per window (8).
        window_batch: windows scored per device call.
        device: ``"cuda"`` (default) or ``"cpu"``; raises when CUDA is
            asked for and absent.
        optimize: apply the exact inference rewrites first (a TimeSformer's
            t_fc folded into t_attn.proj on a copy, in fp32; other models
            are left as they are), as the JAX engine does.
    """

    def __init__(self, model: torch.nn.Module, num_segments: int = 8,
                 window_batch: int = 16,
                 device: Union[str, torch.device, None] = "cuda",
                 optimize: bool = True):
        self.device = resolve_device(device)
        if optimize:
            model = fold_for_inference(model)
        self.model = model.to(self.device).eval()
        self.num_segments = num_segments
        self.window_batch = window_batch

    @torch.no_grad()
    def _run(self, windows_u8: torch.Tensor) -> torch.Tensor:
        return self.model(normalize_clip(windows_u8.to(self.device)))

    # ---------------- core batched call ---------------- #
    def chunked_call(self, fn, arr: np.ndarray) -> np.ndarray:
        """Run ``fn`` over any-N leading-dim input in chunks of
        window_batch, zero-padding the tail chunk to a full batch."""
        wb = self.window_batch
        outs: List[np.ndarray] = []
        for i in range(0, arr.shape[0], wb):
            chunk = arr[i:i + wb]
            pad = wb - chunk.shape[0]
            if pad > 0:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            out = fn(torch.from_numpy(np.ascontiguousarray(chunk)))
            outs.append(out.float().cpu().numpy()[:wb - pad])
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def score_windows(self, windows_u8: np.ndarray) -> np.ndarray:
        """Score N windows (N, T, H, W, C) uint8 → (N, num_class) logits."""
        return self.chunked_call(self._run, windows_u8)

    def score_clip(self, clip_u8: np.ndarray) -> np.ndarray:
        """Score one (T, H, W, C) window → (num_class,) logits."""
        return self.score_windows(clip_u8[None])[0]

    # ---------------- video scoring ---------------- #
    def windows_for_video(self, total_frames: int, step: int = 8) -> np.ndarray:
        """Window start indices every ``step`` frames; none for 0 frames."""
        return np.arange(0, max(total_frames, 0), step, dtype=np.int64)

    def gather_windows(self, video_u8: np.ndarray, starts: np.ndarray,
                       stride: int = 2) -> np.ndarray:
        """Host-side sparse gather: frames [s, s+stride, ...], zero past the
        end (reference vid[i:i+16:2] + zero pad)."""
        t = video_u8.shape[0]
        f = self.num_segments
        out = np.zeros((len(starts), f) + video_u8.shape[1:], video_u8.dtype)
        for k, s in enumerate(starts):
            idx = np.arange(s, s + f * stride, stride)
            valid = idx < t
            out[k, :valid.sum()] = video_u8[idx[valid]]
        return out

    @torch.no_grad()
    def score_video(self, video_u8: np.ndarray, step: int = 8,
                    stride: int = 2, starts: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Score a whole decoded (T, H, W, C) uint8 video.

        The video is copied to the device once; each batch of windows is
        gathered and normalized there. Returns (starts, (N, num_class)
        logits); ``starts`` defaults to every ``step`` frames.
        """
        if starts is None:
            starts = self.windows_for_video(video_u8.shape[0], step=step)
        starts = np.asarray(starts, np.int64)
        if len(starts) == 0:
            return starts, np.zeros((0, self.model.num_class), np.float32)
        video = torch.from_numpy(np.ascontiguousarray(video_u8)).to(self.device)
        total = video.shape[0]
        wb = self.window_batch
        outs: List[np.ndarray] = []
        for i in range(0, len(starts), wb):
            chunk = starts[i:i + wb]
            n = len(chunk)
            # padded starts point past the end → all-zero windows
            padded = np.concatenate([chunk, np.full(wb - n, total, np.int64)])
            x = preprocess_windows(video, torch.from_numpy(padded).to(self.device),
                                   num_frames=self.num_segments, stride=stride)
            outs.append(self.model(x).float().cpu().numpy()[:n])
        return starts, np.concatenate(outs)
