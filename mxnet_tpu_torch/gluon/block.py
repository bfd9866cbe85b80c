"""Block, HybridBlock and the CachedOp counterpart (counterpart of
``mxnet_tpu/gluon/block.py``, ref: python/mxnet/gluon/block.py:229 (Block),
:827 (HybridBlock), src/imperative/cached_op.cc).

A Block is a ``torch.nn.Module``, so every entry point of the port that
takes a module takes one (``parallel.ShardedTrainStep``, ``gluon.Trainer``,
``serving.BlockRunner``, ``weights.params_from_mxnet_tpu``). Its Gluon
Parameters register their tensors on it under their attribute names, so
``named_parameters()`` yields the JAX package's structured names. The
names, prefixes and ``_BlockScope`` counters are MXNet's.

Two kinds of call:

- with NDArrays (MXNet's entry): NDArrays come back. Inside
  ``autograd.record()`` the call is recorded on ``mx.autograd``'s tape:
  a later ``backward()`` writes each Parameter's gradient into its
  tensor's ``.grad``. Outside it nothing is recorded (``torch.no_grad``).
- with torch tensors (PyTorch's entry, and every call a Block makes of
  its children): tensors come back, and torch's own grad mode decides
  what is recorded.

Training mode, one rule for both. A layer that behaves differently in
training (BatchNorm, Dropout) reads its module's ``training`` flag; an
``nd`` op a ``hybrid_forward`` calls itself (``F.dropout``,
``F.batch_norm`` with ``training=None``) reads ``autograd.is_training()``,
as MXNet's ops do. A call with NDArrays first sets the module flag on the
block and its children from ``autograd.is_training()`` (True inside
``record()``), and leaves it so, so both agree; a call with tensors
leaves the flag as the caller set it (a new module trains, as torch's
do). ``ShardedTrainStep`` sets both for its forward and loss (``train()``
and autograd's flag, as the JAX step does); ``BlockRunner`` calls
``eval()`` and leaves autograd's flag off.

``HybridBlock.forward(x, *args)`` gives ``hybrid_forward(F, x, *args,
**params)`` the layer's parameter tensors and ``F = nd``, whose ops take
tensors and return tensors. Deferred initialisation happens in a
layer's first forward: its ``_infer_param_shapes`` sets the shapes from
the input, and the Parameters are initialised as ``initialize`` asked.

``hybridize()``. The outermost hybridized block of a call keeps one entry
per key, as ``CachedOp.__call__`` keys its compiles: the inputs' shapes
and dtypes, the training flag, whether autograd records, the AMP
patch epoch (a graph captured before ``amp.init()`` is not replayed after
it, nor the other way round) and the parameters' names. On the card:

- without autograd (predict mode, or ``autograd.train_mode()`` outside
  ``record()``, or tensors under ``no_grad``) the forward is captured as
  one CUDA graph (``_capture.capture``): the key's first call runs
  eagerly on the capture stream (kernels and cuDNN plans are set up
  there, deferred parameters placed) and is that call's result, later
  calls copy the inputs into the graph's buffers, replay it and return
  clones of its outputs. BatchNorm's running statistics are updated in
  place by each replay; the blocks' dropout generators are registered
  with the graph, so each replay draws new noise.
- under autograd the forward and the backward are captured as two CUDA
  graphs by ``torch.cuda.make_graphed_callables``: its warm-up runs the
  block three times, so the parameters that the forward writes
  (grad_req 'null': the running statistics) are restored after it, and
  the key's first call is the first replay. A block that holds its own
  CUDA generator, has forward hooks, takes non-tensor arguments, or
  whose forward draws from the port's generator (``F.dropout``, rrelu:
  one forward under ``no_grad`` shows it, its writes undone) runs
  eagerly here instead: ``make_graphed_callables`` registers only the
  default generator, refuses hooks, and takes tensors only.
- a forward that calls an op computing on the host (an op library's op,
  ``library.load``) cannot enter a CUDA graph: its device-to-host copy
  and synchronize are not capturable. The key's first run shows it
  (``_capture.HostCallInCapture``), and that key runs eagerly from then
  on, counted in ``CachedOp.num_eager``; the op returns what it returns
  outside a hybridized block.

Each new key is a compile of site ``cachedop:<block name>`` for the
compile ledger (``telemetry.compile``; the capture's seconds and the
inputs' signature), or for the compile counters when the ledger is
disarmed and telemetry on; a call that finds its key counts a cache hit.
Nested hybridized blocks inside such a call run as part of it; a block
called inside another capture (``ShardedTrainStep``'s) runs plain. On
the CPU ``hybridize()`` changes nothing: the same forward runs eagerly.

The symbolic side (ref: block.py:1106 export, :1218 SymbolBlock). Called
with a ``Symbol``, a HybridBlock traces itself: ``hybrid_forward(sym, x,
**params)`` with each parameter a ``sym.var`` of its name, so ``export``
writes ``path-symbol.json`` and ``path-NNNN.params`` (``arg:``/``aux:``
keys, the running statistics as ``aux:``), the JAX package's pair.
``SymbolBlock(outputs, inputs)`` runs a Symbol graph as a block, one
Parameter per argument and auxiliary state; ``SymbolBlock.imports`` loads
such a pair, the JAX package's or the port's, or a Module checkpoint's.

``hybridize(backend=name)`` (or ``optimize_for``) applies a subgraph
backend (``mxnet_tpu_torch.subgraph``): the block's forward runs as the
backend's rewritten program, eagerly on the CPU and captured as above
on the card. An unknown name raises.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import re
import threading
import time
from collections import OrderedDict

import numpy as onp
import torch

from ..base import MXNetError, state, telem_flags as _telem
from ..ndarray.ndarray import NDArray
from .. import ndarray as nd
from .. import symbol as _symbol
from .. import _imperative
from ..amp import amp as _amp
from .. import autograd as _autograd
from .. import random as _random
from .._capture import (HostCallInCapture, capture, graph_generators,
                        host_calls, module_generators)
from ..telemetry import compile as _compile, memory as _memory, \
    metrics as _metrics
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _load_into)

__all__ = ['Block', 'HybridBlock', 'SymbolBlock', 'CachedOp']


class _BlockScope:
    """Name scope manager (ref: block.py _BlockScope)."""

    _current = threading.local()
    _global_counter = {}

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, 'value', None)
        if current is None:
            if prefix is None:
                count = _BlockScope._global_counter.get(hint, 0)
                _BlockScope._global_counter[hint] = count + 1
                prefix = f"{hint}{count}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, 'value', None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_plain = threading.local()   # depth of calls that must not use a cache

# The blocks' structure version: a new value whenever any Block gains,
# loses or replaces a child or a Parameter (after the change). A CachedOp
# keeps its block's parameter names with the version it read them at.
_versions = itertools.count(1)
_structure = [0]


def _structure_changed():
    _structure[0] = next(_versions)


@contextlib.contextmanager
def plain_calls():
    """Blocks called inside run their forward as it is, without their
    hybridize cache (a caller that captures the block itself)."""
    _plain.depth = getattr(_plain, 'depth', 0) + 1
    try:
        yield
    finally:
        _plain.depth -= 1


def _capturable(args):
    """Whether a hybridized call with ``args`` goes through its CachedOp:
    a CUDA tensor among them, and no capture already under way."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args) \
        and not torch.cuda.is_current_stream_capturing()


def _has_ndarray(args):
    return any(isinstance(a, NDArray) for a in args)


def _is_symbol(x):
    return isinstance(x, _symbol.Symbol)


def _map_out(out, fn):
    if isinstance(out, (list, tuple)):
        return type(out)(fn(o) for o in out)
    return fn(out)


class Block(torch.nn.Module):
    """Base building block (ref: gluon/block.py:229); see the module
    docstring for calls and modes."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ''
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith('_') \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return OrderedDict((k, m) for k, m in self._modules.items()
                           if m is not None)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get('_reg_params')
            if reg is not None:
                reg[name] = value
                self._parameters[name] = value.tensor
            object.__setattr__(self, name, value)
            _structure_changed()
            return
        child = isinstance(value, torch.nn.Module) or \
            name in self.__dict__.get('_modules', ())
        super().__setattr__(name, value)
        if child:
            _structure_changed()

    def __delattr__(self, name):
        super().__delattr__(name)
        _structure_changed()

    def add_module(self, name, module):
        super().add_module(name, module)
        _structure_changed()

    def _apply(self, fn, recurse=True):
        # torch may swap a tensor for a new one (.to() across devices):
        # the Parameter follows its registered tensor
        ret = super()._apply(fn, recurse)
        for name, p in self._reg_params.items():
            t = self._parameters.get(name)
            if t is not None and t is not p._var:
                p._var = t
        return ret

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's Parameters by prefixed name;
        ``select`` a regular expression the names must match."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=''):
        """{structured name: Parameter}, shared ones under every name."""
        if prefix:
            prefix += '.'
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def register_child(self, block, name=None):
        self.add_module(name if name is not None else
                        str(len(self._modules)), block)

    def register_forward_hook(self, hook):
        """hook(block, inputs, output) after each forward."""
        from .utils import HookHandle
        return HookHandle(super().register_forward_hook(hook))

    def register_forward_pre_hook(self, hook):
        """hook(block, inputs) before each forward."""
        from .utils import HookHandle
        return HookHandle(super().register_forward_pre_hook(hook))

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter to ``dtype``; the block remembers it
        (``ShardedTrainStep`` casts a cast block's floating inputs)."""
        for child in self._children.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)
        self._cast_dtype = dtype

    def __call__(self, *args, **kwargs):
        if _has_ndarray(args):
            self.train(state.is_training)
        return super().__call__(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each Parameter's shape and count, and the total."""
        lines = [f"{type(self).__name__} summary:"]
        total = 0
        for name, p in self.collect_params().items():
            n = int(onp.prod(p.shape)) if p.shape else 0
            total += n
            lines.append(f"  {name}: {p.shape} ({n} params)")
        lines.append(f"Total params: {total}")
        print('\n'.join(lines))

    # --- serialization (ref: block.py:417,473) --------------------------
    def save_parameters(self, filename, deduplicate=False):
        """The reference's binary .params format, keyed by structured
        name, which the JAX package (and MXNet) reads; bfloat16 is
        written as float32."""
        from ..serialization import atomic_write_file, save_ndarray_file
        params = self._collect_params_with_prefix()
        if deduplicate:
            seen, uniq = set(), {}
            for key, val in params.items():
                if id(val) not in seen:
                    seen.add(id(val))
                    uniq[key] = val
            params = uniq
        arg_dict = {key: val.data().asnumpy() for key, val in params.items()}
        atomic_write_file(filename, save_ndarray_file(arg_dict))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source='current'):
        """Load a .params file (the JAX package's, MXNet's or this
        one's) by structured name; values take the parameters' dtypes."""
        from ..serialization import load_params_dict
        with open(filename, 'rb') as f:
            loaded = load_params_dict(f.read())
        params = self._collect_params_with_prefix()
        for name, param in params.items():
            if name not in loaded:
                if not allow_missing:
                    raise MXNetError(f"Parameter '{name}' is missing in "
                                     f"file '{filename}'")
                continue
            _load_into(param, loaded[name], ctx)
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"extra parameters in file: {sorted(extra)}")

    save_params = save_parameters
    load_params = load_parameters

    def __repr__(self):
        s = f"{type(self).__name__}("
        for name, child in self._children.items():
            s += f"\n  ({name}): {repr(child)}"
        return s + (")" if not self._children else "\n)")


class HybridBlock(Block):
    """A block whose forward can be captured (ref: block.py:827)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._cached_op = None
        self._flags = {}
        self._subgraph_backend = None

    def hybridize(self, active=True, backend=None, clear=True, **kwargs):
        """Ref: block.py:1043. ``static_alloc``/``static_shape`` are
        accepted: a CUDA graph is both. ``backend`` names a subgraph
        backend (``MXNET_SUBGRAPH_BACKEND`` when None); an unknown name
        raises."""
        self._active = active
        if backend is None:
            from .. import config as _config
            backend = _config.get('MXNET_SUBGRAPH_BACKEND') or None
        if backend is not None:
            from .. import subgraph as _subgraph
            self._subgraph_backend = _subgraph.get_backend(backend)
        elif clear:
            self._subgraph_backend = None
        self._flags.update(kwargs)
        if clear:
            self._cached_op = None
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def __deepcopy__(self, memo):
        """Copies drop the cache (its graphs hold this block's tensors)."""
        new = object.__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, None if k == '_cached_op'
                               else copy.deepcopy(v, memo))
        return new

    def __call__(self, *args, **kwargs):
        if args and _is_symbol(args[0]):
            # a symbolic trace (export) bypasses the cache
            return self.forward(*args)
        if not _has_ndarray(args):
            return self._call_tensors(args, kwargs)
        self.train(state.is_training)
        recording = state.is_recording
        datas = [(_imperative.leaf_tensor(a) if recording and
                  a._grad is not None else a._data)
                 if isinstance(a, NDArray) else a for a in args]
        if recording:
            with torch.enable_grad():
                out = self._call_tensors(datas, kwargs)
            # after the forward: it places deferred parameters
            for p in self._collect_params_with_prefix().values():
                if p._ready and p._grad_req != 'null':
                    _imperative.leaf_tensor(p.data())
        else:
            with torch.no_grad():
                out = self._call_tensors(datas, kwargs)

        def wrap(t):
            if not isinstance(t, torch.Tensor):
                return t
            arr = NDArray(t)
            if recording and t.requires_grad:
                _imperative.record_output(arr)
            return arr
        return _map_out(out, wrap)

    def _call_tensors(self, args, kwargs):
        if self._active and not kwargs and \
                getattr(_plain, 'depth', 0) == 0:
            if _capturable(args):
                if self._cached_op is None:
                    self._cached_op = CachedOp(self)
                return self._cached_op(args)
            if self._subgraph_backend is not None:
                return self._run_forward(args)
        return super().__call__(*args, **kwargs)

    def _run_forward(self, args):
        """The block's forward on tensors: its subgraph backend's
        rewritten program when it has one."""
        if self._subgraph_backend is not None:
            return self._subgraph_backend.run(self, args)
        return torch.nn.Module.__call__(self, *args)

    def forward(self, x, *args):
        """``hybrid_forward(nd, x, *args, **params)`` with the layer's
        parameter tensors (ref: block.py:1156); with a Symbol, the trace
        ``hybrid_forward(sym, x, *args, **params)``, each parameter a
        variable of its name."""
        if _is_symbol(x):
            params = {name: _symbol.var(p.name)
                      for name, p in self._reg_params.items()}
            return self.hybrid_forward(_symbol, x, *args, **params)
        params = OrderedDict()
        for name, p in self._reg_params.items():
            if not p._ready:
                if p._deferred_init and not p._is_materialized():
                    self._infer_param_shapes(x, args)
                p._check_initialized()
            params[name] = p._var
        return self.hybrid_forward(nd, x, *args, **params)

    def _infer_param_shapes(self, x, args):
        raise DeferredInitializationError(
            f"{type(self).__name__} has uninitialized parameters and no "
            "shape inference; initialize with explicit in_units/in_channels")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def infer_shape(self, *args):
        """Place deferred parameters by one forward in predict mode."""
        with _autograd.pause():
            self(*args)

    def export(self, path, epoch=0, remove_amp_cast=True,
               input_names=('data',)):
        """Write ``path-symbol.json`` and ``path-{epoch:04d}.params``
        (ref: block.py:1106): the block traced into a Symbol graph, its
        parameters keyed ``arg:<name>``, those without gradient (the
        running statistics) ``aux:<name>``; ``SymbolBlock.imports`` and the
        JAX package read the pair. Returns the two file names."""
        out = self(*[_symbol.var(n) for n in input_names])
        if isinstance(out, (list, tuple)):
            raise MXNetError(
                "export supports single-output blocks; group outputs first")
        sym_file = f"{path}-symbol.json"
        out.save(sym_file)
        arg_names = set(out.list_arguments()) - set(input_names)
        payload = {('aux:' if p.grad_req == 'null' else 'arg:') + name:
                   p.data()
                   for name, p in self.collect_params().items()
                   if name in arg_names}
        fname = f"{path}-{epoch:04d}.params"
        nd.save(fname, payload)
        return sym_file, fname

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Partition for ``backend`` and run (ref: block.py optimize_for)."""
        self.hybridize(True, backend=backend, **kwargs)
        return self(x, *args)


class _Graphed(torch.nn.Module):
    """The block as ``make_graphed_callables`` wants it: no hooks of its
    own, the block's parameters as its own, the block's plain forward."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, *xs):
        with plain_calls():
            return self.block._run_forward(xs)


class CachedOp:
    """The hybridized forward of one HybridBlock on the card (ref:
    src/imperative/cached_op.cc): one entry per key (see the module
    docstring), ``num_graphs`` of them.

    Each new key is one compile of site ``cachedop:<block name>``: its
    capture's seconds and the inputs' signature go to the compile ledger
    (``telemetry.compile``), or, with the ledger disarmed and telemetry
    on, to the per-site compile counters; a call that finds its key
    counts a cache hit. The predict graphs' memory pools are reported to
    ``telemetry.memory`` as the ``cuda_graphs`` pool."""

    def __init__(self, block):
        self.block = block
        self._cache = {}
        self._names = None
        self._names_at = None
        self.num_eager = 0

    @property
    def num_graphs(self):
        """The keys held, the eager ones (``num_eager``) among them."""
        return len(self._cache)

    def param_names(self):
        """The block's parameters' structured names, walked once and
        kept until a Block gains, loses or replaces a child or a
        Parameter (``cast`` and ``hybridize(clear=True)`` drop the
        whole CachedOp)."""
        at = _structure[0]
        if self._names_at != at:
            self._names = tuple(self.block._collect_params_with_prefix())
            self._names_at = at
        return self._names

    def key(self, args):
        """The cache key of a call: the arguments' shapes, dtypes and
        requires_grad (a non-tensor by its repr), the block's training
        flag, whether autograd records, inference mode, the AMP patch
        epoch (``amp.init``/``_deinit`` change the ops a forward runs, as
        in the JAX package's key) and the parameters' structured names
        (never the block's prefix)."""
        block = self.block
        grad = self._grad(args)
        return (tuple((tuple(a.shape), a.dtype, a.requires_grad)
                      if isinstance(a, torch.Tensor) else repr(a)
                      for a in args),
                block.training, grad, torch.is_inference_mode_enabled(),
                _amp.patch_epoch(), self.param_names())

    def _grad(self, args):
        return torch.is_grad_enabled() and (
            any(p.requires_grad for p in self.block.parameters()) or
            any(a.requires_grad for a in args
                if isinstance(a, torch.Tensor)))

    def __call__(self, args):
        key = self.key(args)
        _, training, grad, inference, _, _ = key
        entry = self._cache.get(key)
        site = f'cachedop:{self.block.name}'
        if entry is not None:
            if _telem['on']:
                _metrics.record_cache_hit(site)
            return entry(args)
        device = next(a for a in args if isinstance(a, torch.Tensor)).device
        cctx = _compile.begin(site)
        t0 = time.perf_counter()
        try:
            if grad:
                entry, out = self._build_graphed(args, device)
            else:
                entry, out = self._build_graph(args, device)
        except HostCallInCapture:
            # the forward calls an op that computes on the host: this key
            # runs eagerly
            _compile.abort(cctx)
            self.num_eager += 1
            entry = self._eager
            self._cache[key] = entry
            return entry(args)
        except BaseException:
            _compile.abort(cctx)
            raise
        if cctx is not None:
            _compile.set_signature(cctx, _compile.signature(
                [_compile.array_sig(f'in{i}', a) for i, a in enumerate(args)],
                {'training': training, 'grad': grad,
                 'inference': inference}))
            _compile.end(cctx)
        elif _telem['on']:
            _metrics.record_compile(site, repr(key[0]),
                                    time.perf_counter() - t0)
        if not self._cache:
            _memory.register_provider(self)
        self._cache[key] = entry
        return out

    def memory_pools(self):
        """{'cuda_graphs': {'<block>:<n>': bytes}}: the bytes the
        allocator holds in each predict graph's private memory pool
        (``torch.cuda.memory_snapshot()`` segments of that pool)."""
        pools = {tuple(e.graph.pool()): n
                 for n, e in enumerate(self._cache.values())
                 if getattr(e, 'graph', None) is not None}
        if not pools:
            return {}
        held = dict.fromkeys(pools.values(), 0)
        for seg in torch.cuda.memory_snapshot():
            n = pools.get(tuple(seg.get('segment_pool_id') or ()))
            if n is not None:
                held[n] += int(seg.get('total_size', 0))
        return {'cuda_graphs': {f'{self.block.name}:{n}': b
                                for n, b in held.items()}}

    def _build_graph(self, args, device):
        block = self.block
        static = [a.detach().clone() if isinstance(a, torch.Tensor) else a
                  for a in args]

        def fn():
            with torch.no_grad(), plain_calls():
                return block._run_forward(static)
        graph, out, first = capture(fn, device,
                                    graph_generators(block, device),
                                    warm_up=True)

        def replay(new_args):
            for buf, a in zip(static, new_args):
                if isinstance(a, torch.Tensor):
                    buf.copy_(a)
            graph.replay()
            return _map_out(out, torch.Tensor.clone)
        replay.graph = graph
        return replay, first

    def _eager(self, args):
        with plain_calls():
            return self.block._run_forward(args)

    def _build_graphed(self, args, device):
        block = self.block
        run = self._eager
        if (any(not isinstance(a, torch.Tensor) for a in args) or
                module_generators(block) or
                any(m._forward_hooks or m._forward_pre_hooks
                    for m in block.modules())):
            return run, run(args)
        if any(not p._is_materialized() for p in
               block._collect_params_with_prefix().values()):
            # a forward in predict mode (it writes nothing) places the
            # deferred parameters outside the capture
            training = block.training
            with plain_calls(), torch.no_grad():
                torch.nn.Module.__call__(block.eval(), *args)
            block.train(training)
        written = [p for p in block.parameters() if not p.requires_grad]
        saved = [p.detach().clone() for p in written]
        # an nd op of the forward may draw from the port's generator
        # (F.dropout, rrelu), which make_graphed_callables cannot register:
        # one forward shows whether it does, and then the key runs eagerly
        own = _random.generator(device)
        before = own.get_state()
        calls = host_calls()
        with plain_calls(), torch.no_grad():
            torch.nn.Module.__call__(block, *args)
        draws = not torch.equal(own.get_state(), before)
        own.set_state(before)
        with torch.no_grad():
            for p, s in zip(written, saved):
                p.copy_(s)
        if host_calls() != calls:
            raise HostCallInCapture(f"{block.name} calls an op that "
                                    f"computes on the host")
        if draws:
            return run, run(args)
        adapter = _Graphed(block)
        adapter.train(block.training)
        sample = tuple(a.detach().clone().requires_grad_(a.requires_grad)
                       for a in args)
        try:
            graphed = torch.cuda.make_graphed_callables(
                adapter, sample, allow_unused_input=True)
        except Exception as e:
            raise MXNetError(f"CUDA graph capture of {block.name} failed: "
                             f"{type(e).__name__}: {e}") from e
        with torch.no_grad():
            for p, s in zip(written, saved):
                p.copy_(s)

        def run(new_args):
            return _map_out(graphed(*new_args), torch.Tensor.clone)
        return run, run(args)


class SymbolBlock(HybridBlock):
    """A Symbol graph run as a block (ref: block.py:1218): one Parameter
    per argument that is not an input, and per auxiliary state (those
    without gradient), each named as its variable and registered under
    that name (dots as underscores). Called with tensors or NDArrays it
    evaluates the graph on them, differentiably; in training mode each
    BatchNorm node's new moving statistics go into its auxiliary
    parameters, as the Executor writes them."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix='', params=params)
        if isinstance(outputs, (list, tuple)):
            if len(outputs) != 1:
                raise MXNetError("SymbolBlock takes one output; group "
                                 "outputs first")
            outputs = outputs[0]
        self._sym_outputs = outputs
        self._sym_inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        input_names = {i.name for i in self._sym_inputs}
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_arguments() + sorted(aux):
            if name in input_names:
                continue
            p = self.params.get(name, allow_deferred_init=True,
                                grad_req='null' if name in aux else 'write')
            setattr(self, name.replace('.', '_'), p)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file`` whose inputs are the variables
        ``input_names``, its parameters loaded from ``param_file`` (keys
        ``arg:``/``aux:`` prefixed or bare; an ``aux:`` entry gets no
        gradient) onto ``ctx`` (the card for None)."""
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(_symbol.load(symbol_file),
                          [_symbol.var(n) for n in input_names])
        if param_file is not None:
            from ..serialization import load_params_dict
            with open(param_file, 'rb') as f:
                ret._load_arg_dict(load_params_dict(f.read(),
                                                    strip_arg_aux=False),
                                   ctx=ctx)
        return ret

    def _load_arg_dict(self, loaded, ctx=None):
        """Load {"arg:name"/"aux:name"/name: array} into this block's
        parameters; names the graph does not have are skipped."""
        params = {p.name: p for p in self.params.values()}
        for key, arr in loaded.items():
            kind, name = key.split(':', 1) if ':' in key else ('arg', key)
            p = params.get(name)
            if p is None:
                continue
            p.shape = tuple(arr.shape)
            p.initialize(init='zeros', ctx=ctx)
            p.set_data(arr.asnumpy() if isinstance(arr, NDArray) else arr)
            if kind == 'aux':
                p.grad_req = 'null'

    def forward(self, *args):
        bindings = {i.name: x for i, x in zip(self._sym_inputs, args)}
        params = {p.name: p for p in self.params.values()}
        for name, p in params.items():
            p._check_initialized()
            bindings[name] = p._var
        out, cache = _symbol._evaluate(self._sym_outputs, bindings)
        if state.is_training:
            with torch.no_grad():
                for name, t in _symbol._new_moving_stats(self._sym_outputs,
                                                         cache):
                    p = params.get(name)
                    if p is not None and p.grad_req == 'null':
                        p._var.copy_(t)
        return out
