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
``csrc/io/mxtpu_io.cc``, ``DevicePrefetchIter``), ``image`` and
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
MXNet 1.6's whole op surface is registered (``list_ops``,
``register_op``; every name of its op inventory resolves through
``base.get_op``), with ``nd.linalg``, ``nd.random``, ``mx.np``
(``numpy``), ``mx.npx`` (``numpy_extension``), the quantized ops,
``util``, ``registry`` and ``seed``. Around a model: ``profiler`` (op
rows, scopes and the card's trace), ``runtime`` (``Features``),
``libinfo``, ``log``, ``library`` (op libraries loaded at run time),
``torch`` (the PyTorch bridge: ``mx.torch.to_torch``), ``test_utils``
(MXNet's test helpers) and ``contrib`` (``quantization.quantize_net``,
``onnx``, ``text``, ``tensorboard``, ``svrg_optimization``).

``mx.torch`` is the bridge module: this package's namespace never binds
PyTorch itself (and ``__all__`` leaves the bridge out, so a star import
does not shadow PyTorch), and every module of the port imports PyTorch
absolutely (``import torch``).
"""
from .base import MXNetError, list_ops, register_op
from .context import Context, cpu, cpu_pinned, current_context, gpu, \
    num_gpus, tpu
from . import (amp, autograd, checkpoint, config, context, contrib, engine,
               gluon, image, initializer, io, lr_scheduler, metric, models,
               ndarray, ops, optimizer, parallel, random, recordio,
               registry, resilience, rtc, serialization, serving, telemetry,
               util, weights)
from .random import seed
from . import numpy, numpy_extension
from . import numpy as np
from . import numpy_extension as npx
from . import ndarray as nd
from . import initializer as init
from . import (attribute, callback, executor, executor_manager, kvstore,
               model, module, monitor, name, operator, subgraph, symbol,
               visualization)
from . import kvstore as kv
from . import symbol as sym
from . import module as mod
from .attribute import AttrScope
from . import test_utils
from . import libinfo, library, log, profiler, runtime
from . import torch  # noqa: F401  (the bridge, mx.torch)
from . import kvstore_server
# a DMLC_ROLE=server process exits here, before the script's body runs
kvstore_server._init_kvstore_server_module()

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
           'serialization', 'serving', 'telemetry', 'weights', 'list_ops',
           'register_op', 'seed', 'np', 'npx', 'numpy', 'numpy_extension',
           'registry', 'test_utils', 'util', 'libinfo', 'library', 'log',
           'profiler', 'runtime']
