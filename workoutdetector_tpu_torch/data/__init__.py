"""Data: sampling, transforms, the file datasets, the label lists and the
loader, as the JAX package's ``data`` exports them where the port has
them (TDNDataset with tdn_sample_indices, and Countix, come later: ROADMAP §1
items 6 and 7)."""

from workoutdetector_tpu_torch.data.datasets import (DebugDataset,
                                                     FrameDataset,
                                                     ImageDataset,
                                                     SuperImageDataset,
                                                     build_dataset)
from workoutdetector_tpu_torch.data.image_folder import ImageFolderDataset
from workoutdetector_tpu_torch.data.repcount import (RepcountHelper,
                                                     RepcountItem,
                                                     RepcountItemWithPred,
                                                     build_label_list)
from workoutdetector_tpu_torch.data.repcount_datasets import (
    RepcountImageDataset, RepcountRecognitionDataset, RepcountVideoDataset)
from workoutdetector_tpu_torch.data.sampling import sample_frames

__all__ = [
    "sample_frames", "RepcountHelper",
    "RepcountItem", "RepcountItemWithPred", "build_label_list",
    "FrameDataset", "ImageDataset", "DebugDataset", "SuperImageDataset",
    "ImageFolderDataset", "RepcountImageDataset", "RepcountVideoDataset",
    "RepcountRecognitionDataset", "build_dataset"
]
