"""Data: sampling, transforms, the file datasets, the label lists and the
loader, as the JAX package's ``data`` exports them where the port has
them (Countix comes later: ROADMAP §1 item 7)."""

from workoutdetector_tpu_torch.data.datasets import (DebugDataset,
                                                     FrameDataset,
                                                     ImageDataset,
                                                     SuperImageDataset,
                                                     TDNDataset,
                                                     build_dataset)
from workoutdetector_tpu_torch.data.image_folder import ImageFolderDataset
from workoutdetector_tpu_torch.data.repcount import (RepcountHelper,
                                                     RepcountItem,
                                                     RepcountItemWithPred,
                                                     build_label_list)
from workoutdetector_tpu_torch.data.repcount_datasets import (
    RepcountImageDataset, RepcountRecognitionDataset, RepcountVideoDataset)
from workoutdetector_tpu_torch.data.sampling import (sample_frames,
                                                     tdn_sample_indices)

__all__ = [
    "sample_frames", "tdn_sample_indices", "RepcountHelper",
    "RepcountItem", "RepcountItemWithPred", "build_label_list",
    "FrameDataset", "TDNDataset", "ImageDataset", "DebugDataset",
    "SuperImageDataset",
    "ImageFolderDataset", "RepcountImageDataset", "RepcountVideoDataset",
    "RepcountRecognitionDataset", "build_dataset"
]
