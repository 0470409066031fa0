from workoutdetector_tpu_torch.infer.engine import (InferenceEngine,
                                                    engine_from_checkpoint,
                                                    score_video_chunked)
from workoutdetector_tpu_torch.infer.inference_count import (
    count_by_image_model, count_by_motion_periodicity, count_by_repnet,
    count_by_similarity, count_by_video_model, eval_count_shards,
    eval_dataset, inference_dataset)

__all__ = [
    "InferenceEngine", "count_by_image_model", "count_by_motion_periodicity",
    "count_by_repnet", "count_by_similarity", "count_by_video_model", "engine_from_checkpoint",
    "eval_count_shards", "eval_dataset", "inference_dataset",
    "score_video_chunked"
]
