"""workoutdetector_tpu_torch — the PyTorch/CUDA port of workoutdetector_tpu.

The JAX package beside this one is the reference; this package reproduces
its inference and training paths on an NVIDIA H100 with kernels written
by hand for Hopper (``ops/kernels`` over ``csrc/*.cu``). It imports torch,
numpy and the standard library only — never jax, and nothing of the JAX
package; PyYAML only inside the functions that read YAML configs.

Layer map:
  ops.preprocess     — on-device window gather + fused normalize
  ops.temporal_shift — plain TSM shift / shift-conv
  ops.kernels        — hand kernels (shift, shift-matmul, fused bottleneck,
                       1×1-conv backward dx / dW), each with its plain
                       PyTorch version beside it, and the autograd
                       Functions built on them
  models             — ResNet / TSM (NHWC at the public surface, train and
                       eval modes), the flax-variable loader, build_model
  infer              — InferenceEngine, count_by_video_model
  counting           — pred_to_count (rep counting state machine)
  config             — typed config, load_config (the repo's YAMLs)
  data               — DebugDataset, the deterministic DataLoader
  train              — optimizer policies, checkpoints, loggers, Trainer
  trainer            — the train/test CLI

Layout: public functions take and return the JAX package's layout, NHWC —
``(B, T, H, W, C)`` clips and ``(B·T, H, W, C)`` activations.

Devices: entry points take ``device`` (default ``"cuda"``) and raise when
CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
