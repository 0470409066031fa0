from workoutdetector_tpu_torch.models.convert import (init_flax_variables,
                                                      load_flax_variables)
from workoutdetector_tpu_torch.models.factory import build_model
from workoutdetector_tpu_torch.models.resnet import ResNet
from workoutdetector_tpu_torch.models.timesformer import (
    VIT_VARIANTS, TimeSformer, fold_for_inference, fold_timesformer_tfc)
from workoutdetector_tpu_torch.models.tsm import TSM

__all__ = ["ResNet", "TSM", "TimeSformer", "VIT_VARIANTS", "build_model",
           "fold_for_inference", "fold_timesformer_tfc",
           "init_flax_variables", "load_flax_variables"]
