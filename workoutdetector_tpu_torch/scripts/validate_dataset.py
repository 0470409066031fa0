"""Dataset integrity validator: pre-flight checks before a training run.

The port's own copy of ``workoutdetector_tpu/scripts/validate_dataset.py``
on the port's ``data/datasets._load_rawframe_anno``, ``data/jpeg`` (the
native libjpeg header probe or full decode, then cv2, as the loader
falls back), ``data/repcount.RepcountHelper`` and ``data/video``:

  * rawframe lists (3 or 4 columns): frame folders exist, every
    ``img_%05d.jpg`` they name is present, labels are in range, and
    (``--probe``) the first, middle and last frame of each item (or
    every frame) decode;
  * RepCount ``annotation.csv``: a video file or rawframe folder for
    each row, rep boundaries paired, ordered, as many pairs as the
    count, within the frames (a warning past them);
  * video folders: every file opens and has a decodable frame.

Usage:
  python -m workoutdetector_tpu_torch.scripts.validate_dataset \
      --rawframe-list train.txt --data-root ~/data --num-class 12
  python -m workoutdetector_tpu_torch.scripts.validate_dataset \
      --repcount-root ~/data/RepCount [--anno .../annotation.csv]
  python -m workoutdetector_tpu_torch.scripts.validate_dataset --videos dir/

Exit code 1 if any error-severity issue is found (warnings don't fail).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from dataclasses import dataclass
from typing import List, Optional

from workoutdetector_tpu_torch.data.datasets import _load_rawframe_anno


@dataclass
class Issue:
    severity: str  # 'error' | 'warning'
    path: str
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.path}: {self.message}"


def _probe_jpeg(path: str, full: bool) -> Optional[str]:
    """None if the file parses as an image, else a reason string.

    Mirrors the loader's fallback chain: a file the native decoder
    rejects (CMYK, EXIF-rotated) but cv2 can read trains fine, so it
    must pass pre-flight too."""
    from workoutdetector_tpu_torch.data import jpeg as njpeg
    if njpeg.native_available() and path.lower().endswith((".jpg", ".jpeg")):
        if not full:
            import ctypes
            lib = njpeg._load()
            h = ctypes.c_int()
            w = ctypes.c_int()
            rc = lib.wdj_dims(path.encode(), ctypes.byref(h), ctypes.byref(w))
            if rc == 0 and h.value > 0 and w.value > 0:
                return None
        elif njpeg.read_image(path) is not None:
            return None
    import cv2
    return None if cv2.imread(path) is not None else "decode failed"


def validate_rawframe_list(anno_path: str,
                           data_root: str = "",
                           data_prefix: str = "",
                           anno_col: int = 4,
                           num_class: Optional[int] = None,
                           tmpl: str = "img_{:05}.jpg",
                           probe: str = "sample") -> List[Issue]:
    """Validate a 3/4-column rawframe annotation list.

    probe: 'none' | 'sample' (first/middle/last frame per item) | 'full'.
    """
    issues: List[Issue] = []
    prefix = osp.join(data_root, data_prefix or "")
    try:
        rows = _load_rawframe_anno(anno_path, prefix, anno_col)
    except (OSError, ValueError) as e:
        return [Issue("error", anno_path, f"unparseable annotation list: {e}")]
    if not rows:
        issues.append(Issue("error", anno_path, "annotation list is empty"))
    for row in rows:
        d = row["frame_dir"]
        start, total, label = row["start_index"], row["total_frames"], row["label"]
        if total <= 0:
            issues.append(Issue("error", d, f"non-positive total_frames {total}"))
            continue
        if label < 0 or (num_class is not None and label >= num_class):
            issues.append(Issue(
                "error", d, f"label {label} outside [0, {num_class})"))
        if not osp.isdir(d):
            issues.append(Issue("error", d, "frame directory missing"))
            continue
        missing = [i for i in range(start, start + total)
                   if not osp.isfile(osp.join(d, tmpl.format(i)))]
        if missing:
            issues.append(Issue(
                "error", d,
                f"{len(missing)}/{total} frame files missing "
                f"(first: {tmpl.format(missing[0])})"))
            continue
        if probe != "none":
            idx = (range(start, start + total) if probe == "full" else
                   sorted({start, start + total // 2, start + total - 1}))
            for i in idx:
                p = osp.join(d, tmpl.format(i))
                reason = _probe_jpeg(p, full=(probe == "full"))
                if reason:
                    issues.append(Issue("error", p, reason))
    return issues


def validate_repcount(data_root: str,
                      anno_file: Optional[str] = None,
                      splits: tuple = ("train", "val", "test")) -> List[Issue]:
    """Validate RepCount annotation.csv rows against the media on disk
    and the rep boundaries' invariants (paired, ordered across pairs)."""
    from workoutdetector_tpu_torch.data.repcount import RepcountHelper
    anno_file = anno_file or osp.join(data_root, "annotation.csv")
    if not osp.isfile(anno_file):
        return [Issue("error", anno_file, "annotation csv missing")]
    helper = RepcountHelper(data_root, anno_file)
    try:
        items = helper.get_rep_data(split=list(splits), action=["all"])
    except (KeyError, ValueError) as e:
        return [Issue("error", anno_file, f"unparseable annotation csv: {e}")]
    issues: List[Issue] = []
    for name, item in items.items():
        has_video = osp.isfile(item.video_path)
        has_frames = osp.isdir(item.frames_path)
        if not has_video and not has_frames:
            issues.append(Issue(
                "error", name, "neither video file nor rawframe dir on disk"))
        if len(item.reps) % 2 != 0:
            issues.append(Issue(
                "error", name, f"odd rep boundary list (len {len(item.reps)})"))
            continue
        if item.count != len(item.reps) // 2:
            issues.append(Issue(
                "error", name,
                f"count {item.count} != {len(item.reps) // 2} rep pairs"))
        # ordered across pairs, not only within one:
        # s1 <= e1 <= s2 <= e2 <= ... — report every violation
        for j in range(len(item.reps) - 1):
            a, b = item.reps[j], item.reps[j + 1]
            if b < a:
                kind = ("rep end" if j % 2 == 0 else "next rep start")
                issues.append(Issue(
                    "error", name,
                    f"{kind} {b} precedes boundary {a} (position {j + 1})"))
        if item.reps and item.total_frames > 0 and \
                max(item.reps) >= item.total_frames + 2:
            # +2: the annotation's indices overshoot by one on some rows
            # of the published csv
            issues.append(Issue(
                "warning", name,
                f"rep boundary {max(item.reps)} beyond total_frames "
                f"{item.total_frames}"))
    return issues


def validate_videos(video_dir: str, exts: tuple = (".mp4", ".webm", ".avi",
                                                   ".mov", ".mkv")) -> List[Issue]:
    """Every video in the directory opens and reports decodable frames."""
    from workoutdetector_tpu_torch.data.video import VideoReader
    issues: List[Issue] = []
    files = sorted(f for f in os.listdir(video_dir)
                   if f.lower().endswith(exts))
    if not files:
        issues.append(Issue("warning", video_dir, "no video files found"))
    for f in files:
        p = osp.join(video_dir, f)
        try:
            with VideoReader(p) as r:
                n = r.frame_count
                if n <= 0:
                    # container metadata may understate; try one real frame
                    got = next(iter(r.iter_raw()), None)
                    if got is None:
                        issues.append(Issue("error", p, "no decodable frames"))
        except (IOError, OSError) as e:
            issues.append(Issue("error", p, f"failed to open: {e}"))
    return issues


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rawframe-list", action="append", default=[],
                    help="3/4-column annotation list (repeatable)")
    ap.add_argument("--data-root", default="")
    ap.add_argument("--data-prefix", default="")
    ap.add_argument("--anno-col", type=int, default=4)
    ap.add_argument("--num-class", type=int, default=None)
    ap.add_argument("--tmpl", default="img_{:05}.jpg")
    ap.add_argument("--probe", choices=("none", "sample", "full"),
                    default="sample", help="JPEG integrity probe depth")
    ap.add_argument("--repcount-root", default=None)
    ap.add_argument("--anno", default=None, help="RepCount annotation.csv")
    ap.add_argument("--videos", action="append", default=[],
                    help="directory of videos to probe (repeatable)")
    args = ap.parse_args(argv)

    issues: List[Issue] = []
    for lst in args.rawframe_list:
        issues += validate_rawframe_list(lst, args.data_root, args.data_prefix,
                                         args.anno_col, args.num_class,
                                         args.tmpl, args.probe)
    if args.repcount_root:
        issues += validate_repcount(args.repcount_root, args.anno)
    for d in args.videos:
        issues += validate_videos(d)

    for issue in issues:
        print(issue)
    errors = sum(1 for i in issues if i.severity == "error")
    warnings = len(issues) - errors
    print(f"validate_dataset: {errors} error(s), {warnings} warning(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
