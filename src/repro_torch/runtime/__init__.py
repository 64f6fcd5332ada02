from repro_torch.runtime.api import (
    CacheConfig, CacheStats, EngineConfig, GenerationRequest,
    GenerationResult, SamplingParams, TokenDelta, make_engine,
    FINISH_STOP, FINISH_LENGTH, FINISH_ABORTED,
    FINISH_TIMEOUT, FINISH_ERROR, FINISH_SHED,
)
from repro_torch.runtime.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.runtime.faults import FaultInjector, FaultSpec
from repro_torch.runtime.frontdoor import (
    Arrival, FrontDoor, GreedyChunkPolicy, RequestRecord, SchedulerPolicy,
    TokenBudgetPolicy, latency_report,
)
from repro_torch.runtime.server import PagedServer
from repro_torch.runtime.sharded_server import ShardedPagedServer
from repro_torch.runtime.speculative import (
    Drafter, DraftModelDrafter, NGramDrafter,
)
from repro_torch.runtime.trainer import FailureInjector, Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "FailureInjector",
           "PagedServer", "ShardedPagedServer", "Drafter", "NGramDrafter",
           "DraftModelDrafter",
           "CacheConfig", "CacheStats", "EngineConfig",
           "GenerationRequest", "GenerationResult", "SamplingParams",
           "TokenDelta", "make_engine", "FINISH_STOP", "FINISH_LENGTH",
           "FINISH_ABORTED", "FINISH_TIMEOUT", "FINISH_ERROR",
           "FINISH_SHED", "FaultInjector", "FaultSpec", "Clock", "MonotonicClock", "VirtualClock",
           "Arrival", "FrontDoor", "RequestRecord", "SchedulerPolicy",
           "GreedyChunkPolicy", "TokenBudgetPolicy", "latency_report"]
