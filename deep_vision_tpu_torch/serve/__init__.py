"""Serving plane: buckets, batching queue, engine, router, SLO metrics."""
from deep_vision_tpu_torch.serve.buckets import (
    DEFAULT_BUCKETS,
    bucket_for,
    normalize_buckets,
    pad_batch,
    split_rows,
)
from deep_vision_tpu_torch.serve.engine import Engine, ModelEntry, ServeError
from deep_vision_tpu_torch.serve.queue import (
    BatchingQueue,
    DeadlineExceeded,
    QueueClosed,
    Request,
)
from deep_vision_tpu_torch.serve.router import Server, ServerClosed
from deep_vision_tpu_torch.serve.slo import SLOTracker

__all__ = [
    "DEFAULT_BUCKETS", "bucket_for", "normalize_buckets", "pad_batch",
    "split_rows", "Engine", "ModelEntry", "ServeError", "BatchingQueue",
    "DeadlineExceeded", "QueueClosed", "Request", "Server", "ServerClosed",
    "SLOTracker",
]
