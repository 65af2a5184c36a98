"""Serving plane: buckets, batching queue, engine, router, SLO metrics,
the in-process fleet (admission control, the replica pool and the
canary weight swap), the process fleet behind its HTTP front door
(the transport and ProcReplicaPool), and int8 serving with its
calibration gate (quantize)."""
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
from deep_vision_tpu_torch.serve.procpool import PROC_STATES, ProcReplicaPool
from deep_vision_tpu_torch.serve.quantize import (
    QuantizationRejected,
    QuantizedModel,
    calibrate_and_quantize,
    quantize_variables,
    quantized_fn,
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
from deep_vision_tpu_torch.serve.transport import (
    DEADLINE_HEADER,
    STATUS_BY_REASON,
    TRANSPORT_OUTCOMES,
    TRANSPORT_SERVER_OUTCOMES,
    Transport,
    TransportError,
)

__all__ = [
    "AdmissionController", "BatchingQueue", "DEADLINE_HEADER",
    "DEFAULT_BUCKETS", "DeadlineExceeded", "Engine", "ModelEntry",
    "PROC_STATES", "ProcReplicaPool", "QuantizationRejected",
    "QuantizedModel", "QueueClosed", "REPLICA_STATES",
    "ReplicaLost", "ReplicaPool", "Request", "SHED_REASONS", "SLOTracker",
    "STATUS_BY_REASON", "SWAP_OUTCOMES", "SWAP_PHASES", "ServeError",
    "Server", "ServerClosed", "ShedError", "SwapController",
    "TRANSPORT_OUTCOMES", "TRANSPORT_SERVER_OUTCOMES", "TokenBucket",
    "Transport", "TransportError", "bucket_for", "calibrate_and_quantize",
    "normalize_buckets", "pad_batch", "quantize_variables", "quantized_fn",
    "split_rows", "swap_tree",
]
