from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import Request, RequestState

__all__ = ["InferenceEngine", "Request", "RequestState"]
