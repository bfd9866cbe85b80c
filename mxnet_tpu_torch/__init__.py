"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu`` for an NVIDIA
H100 (Hopper, sm_90a).

It imports torch and numpy, never jax and nothing of ``mxnet_tpu``.
Module names mirror ``mxnet_tpu`` so each counterpart is easy to find,
and ``import mxnet_tpu_torch as mx`` reads like ``import mxnet_tpu as
mx``: ``mx.nd``, ``mx.autograd``, ``mx.rtc``, ``mx.cpu()``, ``mx.gpu()``.
Entry points run on the card unless the caller asks for the CPU
(``device='cpu'``, ``ctx=mx.cpu()``); with no CUDA device they raise.

It serves ``models.bert.BertModel`` through ``serving.InferenceEngine``
and trains ``models.bert.BertForPretraining`` on five hand-written
kernels (see ``ops``), through ``gluon.Trainer`` (SGD, NAG, Adam, AdamW,
LAMB and the ``lr_scheduler``s, its update one captured program) or
through ``parallel.ShardedTrainStep``, the whole step captured as one
CUDA graph. It runs MXNet's imperative API (``nd``, ``autograd``) with
user kernels compiled by NVRTC (``rtc``), and MXNet's Gluon API
(``gluon``: Blocks with deferred initialisation, ``hybridize()`` as CUDA
graphs, the layers and losses, the vision model zoo's ResNets). Serving
replays one CUDA graph per bucket through ``hybridize()``, behind
``serving.PredictServer`` (HTTP /predict, /reload, /drain) and
``serving.Router``; serving and training report into ``telemetry``
(metrics, spans, the flight recorder, memory watermarks, the compile
ledger, attribution, the fleet monitor and the /metrics endpoint), off
by default. ``amp`` (also ``contrib.amp``) is MXNet's automatic mixed
precision in bfloat16 or float16, with the dynamic loss scaler. The
input pipeline is MXNet's: ``recordio``, ``io`` (``NDArrayIter``,
``ImageRecordIter`` over the native decode runtime of
``src/io/mxtpu_io.cc``, ``DevicePrefetchIter``), ``image`` and
``gluon.data``, each batch copied to the card on a side stream.
"""
from .base import MXNetError
from .context import Context, cpu, cpu_pinned, current_context, gpu, \
    num_gpus, tpu
from . import (amp, autograd, checkpoint, config, context, contrib, engine,
               gluon, image, initializer, io, lr_scheduler, models, ndarray,
               ops, optimizer, parallel, random, recordio, resilience, rtc,
               serialization, serving, telemetry, weights)
from . import ndarray as nd
from . import initializer as init

__all__ = ['MXNetError', 'Context', 'cpu', 'cpu_pinned', 'current_context',
           'gpu', 'num_gpus', 'tpu', 'amp', 'autograd', 'checkpoint',
           'config', 'context', 'contrib',
           'engine', 'gluon', 'image', 'init', 'initializer', 'io',
           'lr_scheduler', 'models', 'nd', 'ndarray', 'ops', 'optimizer',
           'parallel', 'random', 'recordio', 'resilience', 'rtc',
           'serialization', 'serving', 'telemetry', 'weights']
