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
``gluon.data``, each batch copied to the card on a side stream. The
models are BERT, GPT-2 (``models.gpt``) and the Transformer
(``models.transformer``), the vision zoo is MXNet's, ``metric`` holds
MXNet's evaluation metrics and ``gluon.contrib`` the Estimator and its
handlers. MXNet's symbolic API is ``sym`` (``symbol``: graphs, JSON both
ways with the JAX package, the Executor), ``mod`` (``module``: Module,
BucketingModule, SequentialModule and ``fit``), ``model`` (checkpoint
pairs), ``callback``, ``monitor``, ``visualization``, ``name``,
``AttrScope``, ``operator`` (``CustomOp``) and ``subgraph`` (the
``fuse_attention`` backend on the flash kernels); ``gluon`` adds
``SymbolBlock`` and ``export``. MXNet's sparse storage is ``nd.sparse``
(CSR and RowSparse NDArrays), ``Embedding(sparse_grad=True)`` with lazy
updates in the Trainer and the RowSparse path of ``ShardedTrainStep``
(``ops/rowsparse.py``), and the DGL graph ops (``ops/graph.py``).
"""
from .base import MXNetError
from .context import Context, cpu, cpu_pinned, current_context, gpu, \
    num_gpus, tpu
from . import (amp, autograd, checkpoint, config, context, contrib, engine,
               gluon, image, initializer, io, lr_scheduler, metric, models,
               ndarray, ops, optimizer, parallel, random, recordio,
               resilience, rtc, serialization, serving, telemetry, weights)
from . import ndarray as nd
from . import initializer as init
from . import (attribute, callback, executor, executor_manager, kvstore,
               model, module, monitor, name, operator, subgraph, symbol,
               visualization)
from . import kvstore as kv
from . import symbol as sym
from . import module as mod
from .attribute import AttrScope

__all__ = ['MXNetError', 'Context', 'cpu', 'cpu_pinned', 'current_context',
           'gpu', 'num_gpus', 'tpu', 'amp', 'autograd', 'checkpoint',
           'config', 'context', 'contrib', 'AttrScope', 'attribute',
           'callback', 'executor', 'executor_manager', 'kv', 'kvstore',
           'model', 'module',
           'mod', 'monitor', 'name', 'operator', 'subgraph', 'sym',
           'symbol', 'visualization',
           'engine', 'gluon', 'image', 'init', 'initializer', 'io',
           'lr_scheduler', 'metric', 'models', 'nd', 'ndarray', 'ops', 'optimizer',
           'parallel', 'random', 'recordio', 'resilience', 'rtc',
           'serialization', 'serving', 'telemetry', 'weights']
