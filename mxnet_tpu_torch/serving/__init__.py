"""Inference serving (counterpart of ``mxnet_tpu/serving``): the
continuous batcher and its warmup pass. The HTTP front, the fleet router
and weight quantisation are not ported yet."""
from .batcher import (BlockRunner, InferenceEngine, RequestShed,
                      RequestTooLarge, ServeError, batch_bucket_for,
                      parse_buckets, seq_bucket_for)
from .warmup import warmup

__all__ = ['BlockRunner', 'InferenceEngine', 'RequestShed',
           'RequestTooLarge', 'ServeError', 'batch_bucket_for',
           'parse_buckets', 'seq_bucket_for', 'warmup']
