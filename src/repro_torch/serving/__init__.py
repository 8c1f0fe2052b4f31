"""Async serving runtime over the plan cache (continuous batching).

Request flow:  admission (bucket → cached plan) → scheduler (join/leave the
decode batch at token boundaries) → planned ``prefill_kv`` forward seeds the
paged KV pool → batched decode.  Fault tolerance (deadlines, retries,
degraded-mode replanning) rides the same seams, and analytical queries
share the runtime (``run_analysis``, ``serve_analyses``).
"""
from .admission import AdmissionController, bucket_len
from .degrade import DegradePolicy
from .kv_pool import PagedKVPool, PageTable
from .metrics import MetricsRegistry, RequestMetrics, ServingMetrics
from .runtime import (AnalysisRequest, AnalysisResult, AsyncServingRuntime,
                      ServeRequest, ServeResult, serve_sequential)
from .scheduler import ContinuousBatchScheduler, SlotState, TenantScheduler

__all__ = [
    "AdmissionController", "bucket_len",
    "DegradePolicy",
    "PagedKVPool", "PageTable",
    "MetricsRegistry", "RequestMetrics", "ServingMetrics",
    "AnalysisRequest", "AnalysisResult",
    "AsyncServingRuntime", "ServeRequest", "ServeResult", "serve_sequential",
    "ContinuousBatchScheduler", "SlotState", "TenantScheduler",
]
