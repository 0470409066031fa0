from workoutdetector_tpu_torch.models.convert import (init_flax_variables,
                                                      load_flax_variables,
                                                      port_tdn_checkpoint,
                                                      port_tsm_checkpoint)
from workoutdetector_tpu_torch.models.factory import (build_model,
                                                      example_input_shape)
from workoutdetector_tpu_torch.models.resnet import ResNet
from workoutdetector_tpu_torch.models.tdn import TDN
from workoutdetector_tpu_torch.models.timesformer import (
    VIT_VARIANTS, TimeSformer, fold_for_inference, fold_timesformer_tfc)
from workoutdetector_tpu_torch.models.tpn import TPN
from workoutdetector_tpu_torch.models.tsm import TSM

__all__ = ["ResNet", "TDN", "TPN", "TSM", "TimeSformer", "VIT_VARIANTS",
           "build_model", "example_input_shape", "fold_for_inference",
           "fold_timesformer_tfc", "init_flax_variables",
           "load_flax_variables", "port_tdn_checkpoint",
           "port_tsm_checkpoint"]
