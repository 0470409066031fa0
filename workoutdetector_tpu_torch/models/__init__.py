from workoutdetector_tpu_torch.models.convert import (
    init_flax_variables, load_flax_variables, port_convnext_checkpoint,
    port_tdn_checkpoint, port_timesformer_checkpoint, port_tsm_checkpoint,
    port_vit_checkpoint)
from workoutdetector_tpu_torch.models.convnext import (CONVNEXT_VARIANTS,
                                                       ConvNeXt,
                                                       ConvNeXtBlock,
                                                       make_convnext)
from workoutdetector_tpu_torch.models.factory import (ImageClassifier,
                                                      build_model,
                                                      example_input_shape)
from workoutdetector_tpu_torch.models.moe import MoEMlp
from workoutdetector_tpu_torch.models.repnet import (REPNET_VARIANTS, RepNet,
                                                     count_from_frame_logits,
                                                     period_of_class)
from workoutdetector_tpu_torch.models.resnet import (ResNet, resnet18,
                                                     resnet34, resnet50,
                                                     resnet101)
from workoutdetector_tpu_torch.models.tdn import TDN
from workoutdetector_tpu_torch.models.timesformer import (
    VIT_VARIANTS, TimeSformer, fold_for_inference, fold_timesformer_tfc,
    vit_patch_size)
from workoutdetector_tpu_torch.models.tpn import TPN
from workoutdetector_tpu_torch.models.tsm import TSM

__all__ = ["CONVNEXT_VARIANTS", "ConvNeXt", "ConvNeXtBlock",
           "ImageClassifier", "MoEMlp", "REPNET_VARIANTS", "RepNet",
           "ResNet", "TDN", "TPN", "TSM", "TimeSformer", "VIT_VARIANTS",
           "build_model", "count_from_frame_logits", "example_input_shape",
           "fold_for_inference", "fold_timesformer_tfc",
           "init_flax_variables", "load_flax_variables", "make_convnext",
           "port_convnext_checkpoint", "port_tdn_checkpoint",
           "port_timesformer_checkpoint", "port_tsm_checkpoint",
           "period_of_class", "port_vit_checkpoint", "resnet18", "resnet34",
           "resnet50", "resnet101", "vit_patch_size"]
