from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.pipeline import make_split_pipeline, wire_stats

__all__ = ["Request", "ServingEngine", "make_split_pipeline", "wire_stats"]
