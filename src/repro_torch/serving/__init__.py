from repro_torch.serving.engine import GenerationEngine, GenerationResult
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ContinuousBatchingScheduler", "GenerationEngine",
           "GenerationResult", "Request"]
