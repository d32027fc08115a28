from repro_torch.data.pipeline import (
    ImageTaskConfig,
    LMStreamConfig,
    MarkovLMStream,
    SyntheticImages,
    image_batches,
    lm_batches,
    shard_batch,
)

__all__ = [
    "ImageTaskConfig", "LMStreamConfig", "MarkovLMStream", "SyntheticImages",
    "image_batches", "lm_batches", "shard_batch",
]
