"""Inference serving (counterpart of ``mxnet_tpu/serving``).

- ``batcher`` — the continuous batcher over a hybridized block (one CUDA
  graph per bucket on the card);
- ``warmup`` — captures the bucket grid and ledgers each capture;
- ``server`` — the replica's HTTP front: POST /predict + the telemetry
  endpoint's /metrics, /healthz and /flight, admission control and OOM
  shedding, weight reload into the captured graphs, graceful drain,
  weight quantization;
- ``fleet`` — a round-robin router over replica endpoints with
  ejection, failover and readmission through /healthz.

Membership discovery and the weight push over the replica transport
raise until ``parallel.dist``'s membership and the replica layer are
ported (ROADMAP queue 1 item 10).
"""
from .batcher import (BlockRunner, InferenceEngine, RequestShed,
                      RequestTooLarge, ServeError, batch_bucket_for,
                      parse_buckets, seq_bucket_for)
from .fleet import (NoReplicasError, Router, discover_replicas,
                    http_json, push_weights)
from .server import PredictServer, memory_admission, quantize_weights
from .warmup import warmup

__all__ = [
    'BlockRunner', 'InferenceEngine', 'RequestShed', 'RequestTooLarge',
    'ServeError', 'batch_bucket_for', 'parse_buckets', 'seq_bucket_for',
    'warmup', 'PredictServer', 'memory_admission', 'quantize_weights',
    'Router', 'NoReplicasError', 'discover_replicas', 'http_json',
    'push_weights',
]
