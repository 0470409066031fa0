from workoutdetector_tpu_torch.serve.batcher import AsyncBatcher

__all__ = ["AsyncBatcher"]
