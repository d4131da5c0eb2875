"""Serving of the port: engine (with the modeled edge replay),
continuous-batching scheduler, requests and sampling."""
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile
from repro_torch.serving.engine import DyMoEEngine, EngineConfig, \
    GenerationResult
from repro_torch.serving.request import Request, RequestHandle, \
    SamplingParams
from repro_torch.serving.sampler import sample_token, sample_token_rows

__all__ = ["EdgeProfile", "EdgeCostModel", "DyMoEEngine", "EngineConfig",
           "GenerationResult", "Request", "RequestHandle",
           "SamplingParams", "sample_token", "sample_token_rows"]
