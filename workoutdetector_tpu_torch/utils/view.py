"""Dataset viewer: annotated rep start/mid/end frames per video.

Port of ``workoutdetector_tpu/utils/view.py`` (the reference's Gradio
gallery). gradio and matplotlib are imported inside ``show_one_video``:
the gallery is a Gradio app where gradio imports, else the same gallery
as a matplotlib grid PNG.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional, Tuple

import numpy as np

from workoutdetector_tpu_torch.data.repcount import RepcountHelper


def rep_frames_for_video(helper: RepcountHelper, name: str,
                         split: List[str] = ("train", "val", "test")
                         ) -> Tuple[List[np.ndarray], List[str]]:
    """Start/mid/end frames of every rep of one video, with captions."""
    from workoutdetector_tpu_torch.data.datasets import read_image

    data = helper.get_rep_data(split=list(split), action=["all"])
    item = data[name]
    frames: List[np.ndarray] = []
    captions: List[str] = []
    for k, (s, e) in enumerate(zip(item.reps[0::2], item.reps[1::2])):
        mid = (s + e) // 2
        for tag, idx in (("start", s), ("mid", mid), ("end", e)):
            path = osp.join(item.frames_path, f"img_{idx + 1:05}.jpg")
            if osp.isfile(path):
                frames.append(read_image(path))
                captions.append(f"rep{k} {tag} f{idx}")
    return frames, captions


def show_one_video(helper: RepcountHelper, name: str,
                   out_path: Optional[str] = None):
    """Gallery of one video's rep boundary frames: Gradio when available,
    else a grid PNG at out_path."""
    frames, captions = rep_frames_for_video(helper, name)
    try:
        import gradio as gr
        with gr.Blocks() as demo:
            gr.Gallery(value=[(f, c) for f, c in zip(frames, captions)],
                       label=name)
        demo.launch()
        return demo
    except ImportError:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        n = len(frames)
        if n == 0:
            return None
        cols = 3
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.5 * rows))
        axes = np.atleast_1d(axes).ravel()
        for ax in axes:
            ax.axis("off")
        for ax, f, c in zip(axes, frames, captions):
            ax.imshow(f)
            ax.set_title(c, fontsize=7)
        fig.suptitle(name)
        out_path = out_path or f"{name}.gallery.png"
        fig.savefig(out_path, bbox_inches="tight", dpi=110)
        plt.close(fig)
        return out_path
