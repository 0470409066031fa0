from workoutdetector_tpu_torch.models.convert import (init_flax_variables,
                                                      load_flax_variables)
from workoutdetector_tpu_torch.models.factory import build_model
from workoutdetector_tpu_torch.models.resnet import ResNet
from workoutdetector_tpu_torch.models.tsm import TSM

__all__ = ["ResNet", "TSM", "build_model", "init_flax_variables",
           "load_flax_variables"]
