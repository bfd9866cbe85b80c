"""Inference serving (counterpart of ``mxnet_tpu/serving``): the
continuous batcher over a hybridized block (one CUDA graph per bucket on
the card) and its warmup pass, which captures the bucket grid and
ledgers each capture, both reporting into ``telemetry``. The HTTP front
(``PredictServer``, ``memory_admission``, ``quantize_weights``) and the
fleet router are not ported yet (ROADMAP queue 1 item 4a)."""
from .batcher import (BlockRunner, InferenceEngine, RequestShed,
                      RequestTooLarge, ServeError, batch_bucket_for,
                      parse_buckets, seq_bucket_for)
from .warmup import warmup

__all__ = ['BlockRunner', 'InferenceEngine', 'RequestShed',
           'RequestTooLarge', 'ServeError', 'batch_bucket_for',
           'parse_buckets', 'seq_bucket_for', 'warmup']
