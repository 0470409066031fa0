"""RepCount annotation layer.

The port's own copy of ``workoutdetector_tpu/data/repcount.py``
(``ACTIONS``, ``RepcountItem``, ``RepcountItemWithPred``,
``RepcountHelper``), reading ``annotation.csv`` with the standard ``csv``
module instead of pandas. The cells are typed per column as pandas'
``read_csv`` types them: a column whose cells all parse as integers holds
ints, one whose cells all parse as numbers holds floats (an empty cell is
NaN and makes an integer column float), any other column strings. The
first column is the index. The helper's two metrics (normalized MAE,
within-one OBO) differ from ``counting.obo_mae`` (raw MAE, exact-one OBO),
as in the reference. ``build_label_list`` and ``build_video_label_list``
write the image and rawframe lists the training yamls read.
"""

from __future__ import annotations

import csv
import math
import os
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ACTIONS = ["situp", "push_up", "pull_up", "jump_jack", "squat", "front_raise"]

# the cells pandas' read_csv reads as NaN by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def _is_int(cell: str) -> bool:
    try:
        int(cell)
    except ValueError:
        return False
    return True


def _is_float(cell: str) -> bool:
    try:
        float(cell)
    except ValueError:
        return False
    return True


def _typed_column(cells: List[str]) -> list:
    """One column's cells as pandas types them (see the module doc)."""
    present = [c for c in cells if c not in _NA]
    if present and all(_is_int(c) for c in present) and len(present) == len(cells):
        return [int(c) for c in cells]
    if all(_is_float(c) for c in present) and present:
        return [float(c) if c not in _NA else math.nan for c in cells]
    return [c if c not in _NA else math.nan for c in cells]


def read_csv(path: str, index_col: bool = False) -> List[Dict[str, object]]:
    """The rows of a csv file as dicts of cells typed per column as
    pandas' ``read_csv`` types them; ``index_col`` leaves out the first
    column (``read_csv(path, index_col=0)``)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return []
    skip = 1 if index_col else 0
    header, body = rows[0][skip:], [r[skip:] for r in rows[1:] if r]
    columns = {name: _typed_column([r[j] if j < len(r) else "" for r in body])
               for j, name in enumerate(header)}
    return [{name: columns[name][i] for name in header}
            for i in range(len(body))]


def _is_na(value) -> bool:
    return isinstance(value, float) and math.isnan(value)


@dataclass
class RepcountItem:
    """One annotated RepCount video."""

    video_path: str
    frames_path: str
    total_frames: int
    class_: str
    count: int
    reps: List[int]  # start_1, end_1, start_2, end_2, ...
    split: str
    video_name: str
    ytb_id: Optional[str] = None
    ytb_start_sec: Optional[int] = None
    ytb_end_sec: Optional[int] = None

    def __getitem__(self, key):
        return self.__dict__[key]

    def __iter__(self):
        return iter(self.__dict__.items())


@dataclass
class RepcountItemWithPred(RepcountItem):
    """RepcountItem plus prediction fields."""

    pred_count: int = 0
    pred_reps: Optional[List[int]] = None
    mae: float = 0.0
    obo_acc: bool = False
    model_type: Optional[str] = None


class RepcountHelper:
    """Annotation helper: filter annotation.csv by split/action, evaluate
    count predictions.

    Args:
        data_root: dataset root, e.g. '.../data/RepCount'
        anno_file: path to annotation.csv
    """

    def __init__(self, data_root: str, anno_file: str):
        self.data_root = data_root
        self.anno_file = anno_file
        self.classes = list(ACTIONS)

    def get_rep_data(self,
                     split: List[str] = ("test",),
                     action: Optional[List[str]] = ("situp",)
                     ) -> Dict[str, RepcountItem]:
        """``action=None`` filters by split only — every csv row regardless
        of class; ``"all"`` among the actions means the six ``ACTIONS``."""
        if len(split) == 0:
            raise ValueError('split must be specified, e.g. ["train", "val"]')
        split = [x.lower() for x in split]
        rows = [r for r in read_csv(self.anno_file, index_col=True)
                if r["split"] in split]
        if action is not None:
            if len(action) == 0:
                raise ValueError('action must be specified, e.g. ["pull_up"]')
            action = [x.lower() for x in action]
            if "all" in action:
                action = self.classes
            rows = [r for r in rows if r["class_"] in action]
        ret: Dict[str, RepcountItem] = {}
        for row in rows:
            name = row["name"]
            name_no_ext = name.split(".")[0]
            split_ = row["split"]
            video_path = os.path.join(self.data_root, "videos", split_, name)
            frames_path = os.path.join(self.data_root, "rawframes", split_,
                                       name_no_ext)
            total_frames = -1
            if os.path.isdir(frames_path):
                total_frames = len(os.listdir(frames_path))
            # an empty or NaN count cell: no count, no reps
            count_cell = row["count"]
            count = 0 if _is_na(count_cell) else int(count_cell)
            reps = [int(x) for x in str(row["reps"]).split()] if count > 0 else []
            ret[name] = RepcountItem(video_path, frames_path, total_frames,
                                     row["class_"], count, reps, split_, name,
                                     row.get("vid"), row.get("start"),
                                     row.get("end"))
        return ret

    def eval_count(
        self,
        pred_reps: Dict[str, int],
        split: List[str] = ("test",),
        action: List[str] = (),
    ) -> Tuple[float, float, Dict[str, RepcountItemWithPred]]:
        """Normalized-MAE / within-one-OBO count evaluation.

        MAE is |pred-gt|/gt per video (0 when gt == 0); OBO counts |diff|<=1.
        Totals are divided by the number of items in the selected
        split/action, not by the number of predictions, as in the
        reference.
        """
        items = self.get_rep_data(split=split, action=action)
        total_mae = 0.0
        total_obo = 0.0
        pred_items: Dict[str, RepcountItemWithPred] = {}
        for name, count in pred_reps.items():
            gt_count = items[name].count
            diff = abs(count - gt_count)
            mae = diff / gt_count if gt_count > 0 else 0.0
            obo = diff <= 1
            total_mae += mae
            total_obo += obo
            pred_items[name] = RepcountItemWithPred(**items[name].__dict__,
                                                    pred_count=count,
                                                    pred_reps=[],
                                                    mae=mae,
                                                    obo_acc=obo)
        return total_mae / len(items), total_obo / len(items), pred_items


def build_label_list(data_root: str,
                     anno_file: str,
                     actions: List[str],
                     out_dir: str,
                     overwrite: bool = False) -> None:
    """Write train/val/test.txt image lists of the first rep's start and
    middle frames, with class ids 2k and 2k + 1 for action k."""
    for a in actions:
        if a not in ACTIONS:
            raise ValueError(f"action {a} not in {ACTIONS}")
    paths = {s: osp.join(out_dir, f"{s}.txt") for s in ("train", "val", "test")}
    if not osp.exists(out_dir):
        os.makedirs(out_dir)
    elif not overwrite and any(osp.isfile(p) for p in paths.values()):
        return
    tmpl = "img_{:05d}.jpg"  # frame files are 1-indexed
    helper = RepcountHelper(data_root=data_root, anno_file=anno_file)
    data = helper.get_rep_data(split=["train", "val", "test"], action=actions)
    handles = {s: open(p, "w") for s, p in paths.items()}
    try:
        for item in data.values():
            if item.count < 1:
                continue
            start_idx, end_idx = item.reps[0], item.reps[1]
            mid_idx = (start_idx + end_idx) // 2
            cls_idx = actions.index(item.class_)
            rel_path = osp.relpath(item.frames_path, data_root)
            f = handles[item.split]
            f.write(f"{rel_path}/{tmpl.format(start_idx + 1)} {cls_idx * 2}\n")
            f.write(f"{rel_path}/{tmpl.format(mid_idx + 1)} {cls_idx * 2 + 1}\n")
    finally:
        for f in handles.values():
            f.close()


def build_video_label_list(data_root: str,
                           anno_file: str,
                           actions: List[str],
                           out_dir: str,
                           max_reps: int = 2,
                           overwrite: bool = False) -> None:
    """Write 4-column rawframe lists ``path start length label`` of each
    rep's two halves: ``{action}/{split}.txt`` with labels 0/1 and
    ``all-{split}.txt`` with 2k/2k + 1 for action k (12 classes over the
    six actions). At most ``max_reps`` reps per video (all when < 1)."""
    if not osp.exists(out_dir):
        os.makedirs(out_dir)
    helper = RepcountHelper(data_root=data_root, anno_file=anno_file)
    for split in ("train", "val", "test"):
        all_lines: List[str] = []
        for action in actions:
            data = helper.get_rep_data(split=[split], action=[action])
            lines: List[str] = []
            for item in data.values():
                if item.count < 1:
                    continue
                reps = item.reps[:max_reps * 2] if max_reps > 0 else item.reps
                rel = osp.relpath(item.frames_path, data_root)
                for start, end in zip(reps[0::2], reps[1::2]):
                    start, end = start + 1, end + 1  # frames are 1-indexed
                    mid = (start + end) // 2
                    if end - start < 2:
                        continue
                    cls = actions.index(action)
                    lines.append(f"{rel} {start} {mid - start + 1} {cls * 2}\n")
                    lines.append(f"{rel} {mid + 1} {end - mid} {cls * 2 + 1}\n")
            adir = osp.join(out_dir, action)
            os.makedirs(adir, exist_ok=True)
            ap = osp.join(adir, f"{split}.txt")
            if overwrite or not osp.isfile(ap):
                with open(ap, "w") as f:
                    # the per-action lists carry binary labels 0/1
                    for ln in lines:
                        parts = ln.split()
                        parts[-1] = str(int(parts[-1]) % 2)
                        f.write(" ".join(parts) + "\n")
            all_lines.extend(lines)
        allp = osp.join(out_dir, f"all-{split}.txt")
        if overwrite or not osp.isfile(allp):
            with open(allp, "w") as f:
                f.writelines(all_lines)
