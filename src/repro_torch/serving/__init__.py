"""Async serving runtime over the plan cache (continuous batching).

Request flow:  admission (bucket → cached plan) → scheduler (join/leave the
decode batch at token boundaries) → planned ``prefill_kv`` forward seeds the
paged KV pool → batched decode.
"""
from .admission import AdmissionController, bucket_len
from .kv_pool import PagedKVPool, PageTable
from .metrics import MetricsRegistry, RequestMetrics, ServingMetrics
from .runtime import (AsyncServingRuntime, ServeRequest, ServeResult,
                      serve_sequential)
from .scheduler import ContinuousBatchScheduler, SlotState

__all__ = [
    "AdmissionController", "bucket_len",
    "PagedKVPool", "PageTable",
    "MetricsRegistry", "RequestMetrics", "ServingMetrics",
    "AsyncServingRuntime", "ServeRequest", "ServeResult", "serve_sequential",
    "ContinuousBatchScheduler", "SlotState",
]
