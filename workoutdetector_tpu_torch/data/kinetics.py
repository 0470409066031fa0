"""Kinetics-400 annotation layer.

The port's own copy of ``workoutdetector_tpu/data/kinetics.py``: reads
the Kinetics CSV packs (``kinetics_400_labels.csv``: ``id,name``; split
CSVs: ``label,youtube_id,time_start,time_end,split``) and writes the
3-column rawframe lists that ``FrameDataset`` reads for
``kinetics400_tsm.yaml``. The CSVs are read with the ``csv`` module, each
column typed as pandas' ``read_csv`` types it (``data.repcount.read_csv``),
so an all-digit ``youtube_id`` column holds ints and loses its leading
zeros, as it does in the JAX package.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Optional

from workoutdetector_tpu_torch.data.repcount import read_csv
from workoutdetector_tpu_torch.settings import PROJ_ROOT


def load_labels(labels_csv: Optional[str] = None) -> Dict[str, int]:
    """{class name: id} from kinetics_400_labels.csv."""
    path = labels_csv or osp.join(PROJ_ROOT, "datasets", "kinetics400",
                                  "kinetics_400_labels.csv")
    return {str(row["name"]): int(row["id"]) for row in read_csv(path)}


def split_to_rawframe_list(split_csv: str,
                           rawframes_root: str,
                           out_txt: str,
                           labels_csv: Optional[str] = None,
                           filename_tmpl: str = "img_{:05}.jpg") -> int:
    """Kinetics split CSV → 3-column rawframe list ``dir total_frames
    label``. Only videos whose rawframe directory exists are written
    (partial local copies of Kinetics are the norm). Returns the number
    of lines written."""
    labels = load_labels(labels_csv)
    rows = read_csv(split_csv)
    n = 0
    os.makedirs(osp.dirname(osp.abspath(out_txt)), exist_ok=True)
    with open(out_txt, "w") as f:
        for row in rows:
            name = str(row["label"])
            if name not in labels:
                continue
            ytb = row["youtube_id"]
            start = int(row["time_start"])
            # mmaction's directory naming: {ytb}_{start:06}_{end:06}
            stem = f"{ytb}_{start:06}_{int(row['time_end']):06}"
            frame_dir = osp.join(rawframes_root, stem)
            if not osp.isdir(frame_dir):
                frame_dir = osp.join(rawframes_root, ytb)  # plain-id layout
                if not osp.isdir(frame_dir):
                    continue
            total = len([x for x in os.listdir(frame_dir)
                         if x.endswith((".jpg", ".jpeg", ".png"))])
            if total == 0:
                continue
            rel = osp.relpath(frame_dir, rawframes_root)
            f.write(f"{rel} {total} {labels[name]}\n")
            n += 1
    return n
