"""workoutdetector_tpu_torch — the PyTorch/CUDA port of workoutdetector_tpu.

The JAX package beside this one is the reference; this package reproduces
its inference and training paths on an NVIDIA H100 with kernels written
by hand for Hopper (``ops/kernels`` over ``csrc/*.cu``). It imports torch,
numpy and the standard library only — never jax, and nothing of the JAX
package; PyYAML only inside the functions that read YAML configs, cv2 and
pandas only inside the functions that decode, resize, draw or write
images, videos and CSVs, matplotlib and gradio only inside the plotting
and gallery functions.

Layer map:
  ops.preprocess     — on-device window gather + fused normalize, the
                       antialiased resize_center_crop
  ops.augment        — the train step's on-device MultiScaleCrop + flip
  ops.temporal_shift — plain TSM shift / shift-conv
  ops.kernels        — hand kernels (shift, shift-matmul, fused bottleneck,
                       1×1-conv backward dx / dW, attention forward and
                       its backward: one launch for D, dQ, dK and dV
                       where a (sample, head) fits a block, the tiled
                       dK/dV and dQ kernels beyond), each with its plain
                       PyTorch version beside it, and the autograd
                       Functions built on them
  models             — ResNet / TSM (NHWC at the public surface, train and
                       eval modes), TimeSformer (train and eval modes:
                       stochastic depth, dropout; the t_fc fold for
                       inference), the flax-variable loader and
                       initializers, build_model; the person detector
                       (CenterNet, LearnedDetectorBackend) and top-down
                       pose (TopDownPose, PoseEstimator)
  infer              — InferenceEngine (inference rewrites with
                       optimize=True; stage_video / score_staged: pinned
                       copies on a copy stream), score_video_chunked,
                       engine_from_checkpoint, count_by_video_model,
                       inference_dataset, eval_dataset, eval_count_shards
                       and the dataset CLI (inference_count.main)
  counting           — pred_to_count (rep counting state machine), the
                       count metrics and the score-directory evaluation
  config             — typed config, load_config (the repo's YAMLs)
  data               — VideoReader (native/libwdvideo.so or cv2), the
                       rawframe JPEG reader (native/libwdjpeg.so or cv2),
                       sampling, host transforms, FrameDataset /
                       ImageDataset / SuperImageDataset / DebugDataset,
                       the RepCount, ImageFolder, Kinetics and Countix
                       layers and label lists (CSVs through the csv
                       module), the deterministic DataLoader, the person
                       crop (data/person.py) and the synthetic fixtures
                       (data/synthetic.py)
  scripts            — compare_scores, eval_count, export_model, bbox
                       (person boxes → JSON, drawn or cropped videos),
                       pose (keypoint pickles, rendering)
  utils              — export, similarity, visualize (plots, skeletons),
                       view (rep galleries), flax_file (the JAX package's
                       msgpack weight files)
  train              — optimizer policies, checkpoints, loggers, Trainer
  trainer            — the train/test CLI

Layout: public functions take and return the JAX package's layout, NHWC —
``(B, T, H, W, C)`` clips and ``(B·T, H, W, C)`` activations.

Devices: entry points take ``device`` (default ``"cuda"``) and raise when
CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
