"""Serving of the port: engine, continuous-batching scheduler, requests."""
from repro_torch.serving.engine import DyMoEEngine, EngineConfig, \
    GenerationResult
from repro_torch.serving.request import Request

__all__ = ["DyMoEEngine", "EngineConfig", "GenerationResult", "Request"]
