"""ImageFolder-style dataset: one directory per class.

The port's own copy of ``workoutdetector_tpu/data/image_folder.py``: the
numpy uint8 counterpart of torchvision's ``ImageFolder`` for any
``root/{class}/image`` tree.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from workoutdetector_tpu_torch.data.datasets import read_image

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolderDataset:
    """`root/{class}/image.jpg` tree → (1, H, W, C) uint8 items.

    Classes are sorted directory names; `class_to_idx` mirrors
    torchvision's convention.
    """

    def __init__(self,
                 root: str,
                 transform: Optional[Callable] = None) -> None:
        if not osp.isdir(root):
            raise NotADirectoryError(f"{root} is not a directory")
        self.root = root
        self.classes: List[str] = sorted(
            d for d in os.listdir(root) if osp.isdir(osp.join(root, d)))
        self.class_to_idx: Dict[str, int] = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            cdir = osp.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTS):
                    self.samples.append((osp.join(cdir, f), self.class_to_idx[c]))
        self.transform = transform

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        path, label = self.samples[idx]
        img = read_image(path)[None]
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, label

    def __len__(self) -> int:
        return len(self.samples)
