"""Serving plane: buckets, batching queue, engine, router, SLO metrics,
and the in-process fleet: admission control, the replica pool and the
canary weight swap."""
from deep_vision_tpu_torch.serve.admission import (
    AdmissionController,
    ShedError,
    TokenBucket,
)
from deep_vision_tpu_torch.serve.buckets import (
    DEFAULT_BUCKETS,
    bucket_for,
    normalize_buckets,
    pad_batch,
    split_rows,
)
from deep_vision_tpu_torch.serve.engine import Engine, ModelEntry, ServeError
from deep_vision_tpu_torch.serve.pool import (
    REPLICA_STATES,
    ReplicaLost,
    ReplicaPool,
)
from deep_vision_tpu_torch.serve.queue import (
    BatchingQueue,
    DeadlineExceeded,
    QueueClosed,
    Request,
)
from deep_vision_tpu_torch.serve.router import Server, ServerClosed
from deep_vision_tpu_torch.serve.slo import SHED_REASONS, SLOTracker
from deep_vision_tpu_torch.serve.swap import (
    SWAP_OUTCOMES,
    SWAP_PHASES,
    SwapController,
    swap_tree,
)

__all__ = [
    "AdmissionController", "BatchingQueue", "DEFAULT_BUCKETS",
    "DeadlineExceeded", "Engine", "ModelEntry", "QueueClosed",
    "REPLICA_STATES", "ReplicaLost", "ReplicaPool", "Request",
    "SHED_REASONS", "SLOTracker", "SWAP_OUTCOMES", "SWAP_PHASES",
    "ServeError", "Server", "ServerClosed", "ShedError", "SwapController",
    "TokenBucket", "bucket_for", "normalize_buckets", "pad_batch",
    "split_rows", "swap_tree",
]
