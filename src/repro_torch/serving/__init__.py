"""Serving pieces of the port: the continuous-batching engine, its KV-cache
backends, request bookkeeping and sampling."""
from repro_torch.serving.engine import EngineMetrics, InferenceEngine
from repro_torch.serving.kv_cache import (BACKENDS, BlockAllocator, CacheView,
                                          ContiguousBackend, EncDecBackend,
                                          KVCacheBackend, OccupancyStats,
                                          PagedBackend, PagedEncDecBackend,
                                          ViewSink, make_backend)
from repro_torch.serving.request import Phase, Request, SequenceState
from repro_torch.serving.sampling import sample

__all__ = ["BACKENDS", "BlockAllocator", "CacheView", "ContiguousBackend",
           "EncDecBackend", "EngineMetrics", "InferenceEngine",
           "KVCacheBackend", "OccupancyStats", "PagedBackend",
           "PagedEncDecBackend", "Phase", "Request", "SequenceState",
           "ViewSink", "make_backend", "sample"]
