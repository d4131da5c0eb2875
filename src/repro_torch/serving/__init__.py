"""Serving of the port: engine (with the modeled edge replay), the
step-driven continuous-batching session, requests and sampling, the fault
taxonomy with its injector and retry helpers, and the SLO policy layer."""
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile
from repro_torch.serving.engine import DyMoEEngine, EngineConfig, \
    GenerationResult
from repro_torch.serving.faults import AdmissionError, DeadlineExceeded, \
    DispatchError, FaultInjector, FaultSpec, InjectedFault, NO_FAULTS, \
    QueueFull, ReplayError, ServingError, SessionClosed, SessionHealth, \
    requeue, result_with_retry, submit_with_retry
from repro_torch.serving.policy import DegradationLadder, EDFPolicy, \
    FIFOPolicy, SLOPressure, SchedulingPolicy, effective_deadline, \
    estimate_service_s, make_policy
from repro_torch.serving.request import Request, RequestHandle, \
    SamplingParams, TokenChunk
from repro_torch.serving.sampler import sample_token, sample_token_rows
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, \
    SchedulerConfig

__all__ = ["EdgeProfile", "EdgeCostModel", "DyMoEEngine", "EngineConfig",
           "GenerationResult", "Request", "RequestHandle",
           "SamplingParams", "TokenChunk", "sample_token",
           "sample_token_rows", "ContinuousBatchingScheduler",
           "SchedulerConfig",
           # fault tolerance: taxonomy, injection, health, retry helpers
           "ServingError", "ReplayError", "DispatchError",
           "AdmissionError", "QueueFull", "DeadlineExceeded",
           "SessionClosed", "InjectedFault", "FaultSpec", "FaultInjector",
           "NO_FAULTS", "SessionHealth", "submit_with_retry", "requeue",
           "result_with_retry",
           # SLO policy layer
           "SchedulingPolicy", "FIFOPolicy", "EDFPolicy", "SLOPressure",
           "DegradationLadder", "make_policy", "estimate_service_s",
           "effective_deadline"]
