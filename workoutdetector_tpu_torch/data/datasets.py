"""Datasets of the port: ``DebugDataset`` and the ``build_dataset`` factory.

Port of ``workoutdetector_tpu/data/datasets.py`` (``DebugDataset``,
``build_dataset``). Items are ``(uint8 (T, H, W, 3) clip, int label)``,
``__getitem__(idx, rng)`` taking the loader's per-item generator. The
datasets that read files come with the second half of the decoder slice
(ROADMAP §1 slice 4b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# dataset_type → where the port will bring it (ROADMAP.md §1)
LATER = {
    "FrameDataset": "the decoder slice's file datasets (JPEG frames, "
                    "ROADMAP §1 slice 4b)",
    "ImageDataset": "the decoder slice's file datasets (ROADMAP §1 slice 4b)",
    "TDNDataset": "the decoder slice's file datasets, with TDN (ROADMAP §1 "
                  "slice 4b and item 6)",
    "SyntheticPeriodic": "the RepNet slice (ROADMAP §1 item 6)",
}


class DebugDataset:
    """Synthetic constant-colour clips, pixel value 255 // (label + 1) as
    uint8: a learnable toy task that needs no files."""

    def __init__(self, num_class: int = 2, num_segments: int = 8,
                 size: int = 100, image_size: int = 224) -> None:
        self.num_class = num_class
        self.num_segments = num_segments
        self.size = size
        self.image_size = image_size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, int]:
        label = idx % self.num_class
        x = np.full((self.num_segments, self.image_size, self.image_size, 3),
                    255 // (label + 1), dtype=np.uint8)
        return x, label


def build_dataset(cfg, split: str):
    """The dataset ``cfg.dataset_type`` names (cfg: ``DataConfig``)."""
    if cfg.dataset_type == "DebugDataset":
        return DebugDataset(num_class=cfg.debug_num_class,
                            num_segments=cfg.num_segments,
                            size=cfg.debug_size, image_size=cfg.image_size)
    if cfg.dataset_type in LATER:
        raise NotImplementedError(
            f"dataset_type {cfg.dataset_type!r} ({split}) is not in the "
            f"PyTorch port yet: it comes with {LATER[cfg.dataset_type]}")
    raise KeyError(f"Dataset '{cfg.dataset_type}' is not supported.")
