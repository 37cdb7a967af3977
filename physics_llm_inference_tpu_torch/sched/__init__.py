"""Request scheduling (counterpart: physics_llm_inference_tpu/sched), with
its exports."""
from .request import Request, RequestState
from .continuous_batcher import ContinuousBatcher, ContinuousBatcherConfig
from .static_batcher import StaticBatcher, analyze_static_batching_waste
from .scheduler import (
    Scheduler, SchedulerConfig, SchedulerOutput, SchedulingPolicy,
)
from .chunked_prefill import ChunkedPrefillScheduler, ChunkConfig
from .mixed_batch import MixedBatchScheduler, MixedBatchConfig, MixedBatch
from .overlap import OverlapScheduler, simulate_overlap_vs_sequential

__all__ = [
    "Request", "RequestState",
    "ContinuousBatcher", "ContinuousBatcherConfig",
    "StaticBatcher", "analyze_static_batching_waste",
    "Scheduler", "SchedulerConfig", "SchedulerOutput", "SchedulingPolicy",
    "ChunkedPrefillScheduler", "ChunkConfig",
    "MixedBatchScheduler", "MixedBatchConfig", "MixedBatch",
    "OverlapScheduler", "simulate_overlap_vs_sequential",
]
