"""Self-similarity analysis and the training-free periodicity counters.

Port of ``workoutdetector_tpu/utils/similarity.py`` (the reference's
``utils/common.py:44-250`` heatmaps, promoted there to counters): cosine
self-similarity of per-frame features, lag profiles (the mean of each
diagonal of the similarity matrix), the comb-scored fundamental period,
per-cell profiles over a grid of the frame for localized motion, and the
counts they give.

The similarity matrices are torch matmuls on ``device`` (``"cuda"`` by
default; it raises without CUDA unless ``"cpu"`` is named), as the JAX
package's are device matmuls. They run in float64 whatever the caller's
matmul settings (TF32 or not): the counts compare lag-profile values
against each other and against thresholds, so the function fixes its own
precision and the card counts what the CPU counts. The per-cell features,
the comb scoring and the cycle count are the JAX module's numpy, copied.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from workoutdetector_tpu_torch.data.video import VideoReader
from workoutdetector_tpu_torch.device import resolve_device

Device = Union[str, torch.device, None]


def _unit_rows(features, device: Device, center: bool = False
               ) -> torch.Tensor:
    """(..., T, D) features as float64 rows of unit norm (norms clamped at
    1e-12) on ``device``; ``center`` subtracts the mean row first."""
    f = torch.as_tensor(np.asarray(features, np.float32)).to(
        resolve_device(device), torch.float64)
    if center:
        f = f - f.mean(dim=-2, keepdim=True)
    return f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def _diagonal_means(sim: torch.Tensor) -> np.ndarray:
    """(..., T, T) similarities → (..., max(T//2, 2) − 1) float32: the mean
    of the k-th diagonal for k = 1, 2, …"""
    t = sim.shape[-1]
    ks = range(1, max(t // 2, 2))
    prof = torch.stack([torch.diagonal(sim, k, -2, -1).mean(-1) for k in ks],
                       dim=-1)
    return prof.cpu().numpy().astype(np.float32)


def cosine_self_similarity(features: np.ndarray,
                           device: Device = "cuda") -> np.ndarray:
    """(T, D) features → (T, T) cosine *distance* matrix (0 = identical),
    as sklearn's pairwise_distances(metric='cosine') the reference uses
    (common.py:70-74)."""
    f = _unit_rows(features, device)
    return (1.0 - f @ f.T).cpu().numpy().astype(np.float32)


def pose_self_similarity(keypoints: np.ndarray,
                         device: Device = "cuda") -> np.ndarray:
    """(T, 17, 2|3) first-person keypoints → (T, T) cosine distances
    (reference plot_pose_heatmap, common.py:63-76)."""
    kp = np.asarray(keypoints)
    return cosine_self_similarity(kp.reshape(kp.shape[0], -1), device)


def video_cnn_features(engine: Any, video_path: str) -> np.ndarray:
    """Per-frame backbone features of a video (reference video_feature,
    common.py:108-148): the frames decoded at the engine's crop, with the
    scale following it (224 → 256), through ``engine.score_images``.

    Args:
        engine: a rank-4 ``InferenceEngine`` over a headless image model
            (``ImageClassifier(..., num_class=0)``).
    Returns:
        (T, D) features.
    """
    # a fixed 256 scale with a small crop would keep only the centre of
    # the frame and miss off-centre motion
    scale = max(engine.image_size, round(engine.image_size * 256 / 224))
    with VideoReader(video_path) as r:
        frames = r.read_prepped(scale, engine.image_size)
    return engine.score_images(frames)


def lag_profile(features: np.ndarray, device: Device = "cuda") -> np.ndarray:
    """(T, D) features → (T//2 − 1,) mean cosine similarity at each
    temporal lag k ≥ 1 (the k-th diagonal of the self-similarity matrix of
    the mean-removed features, averaged). A motion of period p peaks at
    k = p, 2p, 3p, …"""
    f = _unit_rows(features, device, center=True)
    return _diagonal_means(f @ f.T)


def _comb_period(prof: np.ndarray, min_period: int) -> Tuple[int, float]:
    """The fundamental period of one lag profile by comb scoring: each
    candidate p scores the mean profile at its multiples minus the
    profile's mean; among the periods within 5% of the best score the
    first contiguous cluster is the fundamental's peak (later clusters
    are its multiples), and its argmax wins."""
    t_half = len(prof)
    base = float(np.mean(prof))
    periods = np.arange(min_period, t_half + 1)
    if len(periods) == 0:
        return 0, 0.0
    scores = np.array([
        float(np.mean(prof[np.arange(p, t_half + 1, p) - 1])) - base
        for p in periods])
    best = float(scores.max())
    if best <= 0:
        return int(periods[int(scores.argmax())]), best
    qualified = periods[scores >= 0.95 * best]
    end = 1
    while end < len(qualified) and qualified[end] == qualified[end - 1] + 1:
        end += 1
    cluster = qualified[:end]
    offset = int(cluster[0] - periods[0])
    cscores = scores[offset:offset + len(cluster)]
    p = int(cluster[int(np.argmax(cscores))])
    return p, float(scores[p - int(periods[0])])


def estimate_period(features: np.ndarray, min_period: int = 4,
                    device: Device = "cuda") -> Tuple[int, float]:
    """Fundamental period of (T, D) features from their lag profile
    (``_comb_period``). Returns (period_frames, strength); strength ≤ 0
    means no periodicity."""
    return _comb_period(lag_profile(features, device), min_period)


def _cell_features(frames: np.ndarray, grid: int) -> np.ndarray:
    """(T, H, W, 3) frames → (grid², T, D) per-cell pixel features,
    z-scored per dimension over time (the static background removed, the
    contrast of the cells equalized)."""
    t, h, w, _ = frames.shape
    ch, cw = h // grid, w // grid
    x = np.asarray(frames[:, :ch * grid, :cw * grid], np.float32)
    x = x.reshape(t, grid, ch, grid, cw, 3).transpose(1, 3, 0, 2, 4, 5)
    x = x.reshape(grid * grid, t, ch * cw * 3)
    mu = x.mean(axis=1, keepdims=True)
    sd = x.std(axis=1, keepdims=True)
    return (x - mu) / np.maximum(sd, 1e-6)


def _cell_profiles(cells: np.ndarray, device: Device) -> np.ndarray:
    """(G, T, D) z-scored cell features → (G, T//2 − 1) lag profiles: one
    batched matmul (einsum 'gtd,gsd->gts') of the unit rows."""
    f = _unit_rows(cells, device)
    return _diagonal_means(torch.einsum("gtd,gsd->gts", f, f))


def spatial_lag_profiles(frames: np.ndarray, grid: int = 4,
                         device: Device = "cuda") -> np.ndarray:
    """Per-cell temporal lag profiles of a (T, H, W, 3) video: the frame
    cut into grid × grid cells, each with its own profile, so that motion
    confined to a few cells (an arm in a static scene) stays visible.

    Returns:
        (grid², T//2 − 1) lag profiles.
    """
    return _cell_profiles(_cell_features(frames, grid), device)


def estimate_period_spatial(frames: np.ndarray, grid: int = 4,
                            min_period: int = 4,
                            device: Device = "cuda") -> Tuple[int, float]:
    """Fundamental period via the strongest grid cell: each cell's profile
    comb-scored alone, the strongest (period, strength) returned (cells are
    z-scored, so strengths compare)."""
    profs = spatial_lag_profiles(frames, grid=grid, device=device)
    best: Tuple[int, float] = (0, 0.0)
    for g in range(profs.shape[0]):
        p, s = _comb_period(profs[g], min_period)
        if s > best[1]:
            best = (p, s)
    return best


def _count_cycles(cell_feats: np.ndarray, period: int) -> int:
    """Cycles of a cell's dominant motion: the first principal component
    of its (T, D) features, smoothed over max(3, period // 4) frames; one
    rep is two median crossings, crossings closer than period / 3 are
    dropped, and count = (crossings + 1) // 2."""
    f = cell_feats - cell_feats.mean(axis=0, keepdims=True)
    u, sv, _ = np.linalg.svd(f, full_matrices=False)
    sig = u[:, 0] * sv[0]
    k = max(3, period // 4)
    padded = np.pad(sig, k, mode="reflect")  # zero-pad dents the edges
    smooth = np.convolve(padded, np.ones(k) / k, mode="same")[k:-k]
    sign = np.sign(smooth - np.median(smooth))
    changes = np.nonzero(np.diff(sign) != 0)[0]
    kept: list = []
    for c in changes:
        if not kept or c - kept[-1] >= period / 3:
            kept.append(int(c))
    return (len(kept) + 1) // 2


def count_by_spatial_periodicity(frames: np.ndarray, grid: int = 8,
                                 min_period: int = 4,
                                 min_strength: float = 0.05,
                                 device: Device = "cuda"
                                 ) -> Tuple[int, int, float]:
    """Training-free rep count from raw (T, H, W, 3) frames: the strongest
    grid cell gives the period, its motion waveform the cycle count. The
    cycle count wins where it covers at least 60% of the cycles the period
    implies (it trims inactive lead-in and lead-out), else round(T /
    period).

    Returns:
        (count, period_frames, strength); count 0 when no cell's
        periodicity clears ``min_strength``.
    """
    t = len(frames)
    if t < 2 * min_period:
        return 0, 0, 0.0
    cells = _cell_features(frames, grid)
    profs = _cell_profiles(cells, device)
    best_g, period, strength = 0, 0, 0.0
    for g in range(profs.shape[0]):
        p, s = _comb_period(profs[g], min_period)
        if s > strength:
            best_g, period, strength = g, p, s
    if period <= 0 or strength < min_strength:
        return 0, period, strength
    by_duration = int(round(t / period))
    by_cycles = _count_cycles(cells[best_g], period)
    if by_cycles >= 0.6 * t / period:
        return by_cycles, period, strength
    return by_duration, period, strength


def count_by_periodicity(features: np.ndarray, min_period: int = 4,
                         min_strength: float = 0.05,
                         device: Device = "cuda") -> Tuple[int, int, float]:
    """Training-free rep count from per-frame features (CNN features or
    flattened keypoints): the duration over the fundamental period.

    Returns:
        (count, period_frames, strength); count 0 when no periodic
        structure clears ``min_strength``.
    """
    feats = np.asarray(features)
    if len(feats) < 2 * min_period:
        return 0, 0, 0.0
    period, strength = estimate_period(feats, min_period, device)
    if period <= 0 or strength < min_strength:
        return 0, period, strength
    return int(round(len(feats) / period)), period, strength


def plot_similarity(mat: np.ndarray, title: str = "",
                    reps: Optional[list] = None,
                    out_path: Optional[str] = None) -> None:
    """Heatmap with optional rep-start markers (common.py:63-76);
    matplotlib is imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(5, 4))
    plt.imshow(mat, cmap="viridis")
    plt.colorbar()
    plt.title(title)
    if reps:
        plt.vlines(reps[::2], colors="r", ymin=0, ymax=len(mat), lw=0.5)
    if out_path:
        plt.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close()
    else:
        plt.show()
