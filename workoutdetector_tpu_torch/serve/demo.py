"""Interactive demo: repetition counting + action recognition on uploaded
videos.

Port of ``workoutdetector_tpu/serve/demo.py`` (the reference Gradio demo,
workoutdetector/demo.py:82-284: 'repetition count' via
count_by_video_model and 'action recognition' via one sampled window).
gradio is imported only where the interface comes up; without it the CLI
prints the same outputs (JSON, and with ``-o`` the annotated video).

``count-similarity`` is the checkpoint-free counter (the per-cell motion
periodicity, ``count_by_motion_periodicity``); ``count-repnet`` counts
with the learnable RepNet period model (``count_by_repnet``; ``--cfg
workoutdetector_tpu/configs/repnet.yaml --checkpoint ...``, ``--grid``
for the quadrant views).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from workoutdetector_tpu_torch.data.sampling import sample_frames
from workoutdetector_tpu_torch.data.video import VideoReader
from workoutdetector_tpu_torch.infer.engine import InferenceEngine
from workoutdetector_tpu_torch.infer.inference_count import (
    count_by_motion_periodicity, count_by_repnet, count_by_video_model)
from workoutdetector_tpu_torch.serve.server import scores_to_payload
from workoutdetector_tpu_torch.settings import WORKOUT_LABELS

def inference_video_action(engine: InferenceEngine, video_path: str,
                           labels: List[str]) -> Dict[str, float]:
    """Action recognition: decode all → uniform 8-frame sample → one
    window score (reference demo.py:161-195)."""
    with VideoReader(video_path) as r:
        clip = r.read_prepped(256, engine.image_size)
    if len(clip) == 0:
        raise IOError(f"no decodable frames in {video_path}")
    idx = sample_frames(len(clip), engine.num_segments, random=False)
    scores = engine.score_windows(clip[idx][None])[0]
    return scores_to_payload(scores, labels)


def inference_video_reps(engine: InferenceEngine, video_path: str,
                         output_path: Optional[str] = None
                         ) -> Tuple[int, List[int]]:
    """Repetition counting task (reference demo.py:198-249); with
    ``output_path`` the video with the states and counts drawn on it
    (``write_count_video``)."""
    return count_by_video_model(engine, video_path,
                                video_out_path=output_path)


def run_demo(engine_action: InferenceEngine,
             engine_reps: InferenceEngine,
             labels: Optional[List[str]] = None) -> None:
    """Launch the Gradio interface if available (reference demo.py:260-284)."""
    labels = labels or list(WORKOUT_LABELS)
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use the CLI: python -m "
            "workoutdetector_tpu_torch.serve.demo -i video.mp4 "
            "--task count|recognize") from e

    def main(video, task):
        if task == "repetition count":
            out = video + ".annotated.webm"
            count, reps = inference_video_reps(engine_reps, video, out)
            return {f"count: {count}": 1.0}, out
        scores = inference_video_action(engine_action, video, labels)
        return scores, None

    gr.Interface(
        fn=main,
        inputs=[gr.Video(), gr.Radio(["repetition count", "action recognition"])],
        outputs=[gr.Label(num_top_classes=5), gr.Video()],
        title="Workout Detector",
    ).launch()


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.infer.engine import engine_from_checkpoint

    parser = argparse.ArgumentParser(description="Workout demo (CLI fallback)")
    parser.add_argument("-i", "--video", required=True)
    parser.add_argument("--task", choices=["count", "recognize",
                                           "count-similarity",
                                           "count-repnet"], default="count",
                        help="count-similarity: the training-free motion "
                             "periodicity counter (no checkpoint); "
                             "count-repnet: the learnable period counter "
                             "(--cfg workoutdetector_tpu/configs/repnet.yaml "
                             "--checkpoint ...)")
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="port checkpoint file or .pt2 artifact")
    parser.add_argument("-o", "--output", default=None,
                        help="annotated video output path")
    parser.add_argument("--grid", action="store_true",
                        help="count-repnet: also score quadrant crops "
                             "(motion confined to a small region)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("opts", nargs="*", help="dotted config overrides")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    if args.task == "count-similarity":
        count, period, strength = count_by_motion_periodicity(
            args.video, device=device)
        print(json.dumps({"count": count, "period_frames": period,
                          "strength": round(float(strength), 4)}))
        return
    cfg = load_config(args.cfg, args.opts)
    if args.task == "count-repnet":
        cfg.model.model_type = "repnet"
        engine = engine_from_checkpoint(cfg, args.checkpoint,
                                        image_size=cfg.data.image_size,
                                        window_batch=4, device=device)
        count, period, strength = count_by_repnet(engine, args.video,
                                                  grid=args.grid)
        print(json.dumps({"count": count, "period_frames": period,
                          "strength": round(float(strength), 4)}))
        return
    if args.task == "recognize":
        cfg.model.num_class = len(WORKOUT_LABELS)
    engine = engine_from_checkpoint(cfg, args.checkpoint, device=device)
    if args.task == "count":
        count, reps = inference_video_reps(engine, args.video, args.output)
        print(json.dumps({"count": count, "reps": reps}))
    else:
        scores = inference_video_action(engine, args.video,
                                        engine.labels or list(WORKOUT_LABELS))
        print(json.dumps(scores))


if __name__ == "__main__":
    main()
