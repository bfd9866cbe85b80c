"""Imperative runtime: eager op dispatch and autograd (counterpart of
``mxnet_tpu/_imperative.py``, ref: src/imperative/imperative.cc).

Ops run eagerly on PyTorch's streams. Autograd is ``torch.autograd``: an
op recorded inside ``autograd.record()`` runs with grad enabled, and
``backward``/``grad`` call ``torch.autograd.grad``. What MXNet (and the
JAX package's ``jax.vjp`` tape) does differently from torch is kept here:

- leafness lives on the NDArray: a variable (``attach_grad`` or
  ``mark_variables``) gets a fresh leaf tensor that requires grad when a
  recorded op first reads it, so rebinding it (``p[:] = ...``, ``+=``)
  between steps leaves it a variable;
- outside ``record()`` or inside ``pause()``, ops run under
  ``torch.no_grad()`` where an input requires grad, so no graph holds
  memory;
- gradients go into ``arr.grad`` by its ``grad_req`` ('write'
  overwrites, 'add' accumulates, 'null' skips), in the grad buffer's
  dtype, never into torch's own ``.grad``, except for a Gluon
  Parameter's ``data()``, whose gradient buffer is its tensor's
  ``.grad`` (``gluon.parameter.ParamArray``);
- ``backward()`` on a head that was never recorded does nothing;
- ``backward()`` without ``retain_graph`` consumes the head's graph: the
  recorded outputs it reached are detached, so a second ``backward()``
  does nothing, and a later graph built on them stops there, as the JAX
  tape's consumed nodes do (torch would raise);
- a fresh top-level ``record()`` (and ``grad()`` without
  ``retain_graph``) drops what the last one recorded, as the JAX package
  clears its tape.
"""
from __future__ import annotations

import threading
import time
import weakref

import torch

from .base import MXNetError, prof_flags, state

__all__ = ['invoke', 'backward', 'grad', 'tape']


class _Tape(threading.local):
    """What the current recording touched: the variables it read (with
    the leaf tensor it read) and weak references to the NDArrays it
    produced."""

    def __init__(self):
        self.variables = {}
        self.outputs = []
        self.retained = False  # a retain_graph backward keeps them alive

    def clear(self):
        _consume(None)
        self.variables = {}
        self.outputs = []
        self.retained = False


tape = _Tape()


def leaf_tensor(arr):
    """The tensor autograd differentiates for a variable: its own tensor,
    rebound to a detached copy of the handle that requires grad when it
    does not yet (no other NDArray holds that handle)."""
    t = arr._data
    if not t.requires_grad and (t.is_floating_point() or t.is_complex()):
        t = arr._data = t.detach().requires_grad_()
    # a Parameter's data() arrays are many views of one variable
    tape.variables[getattr(arr, '_tape_key', id(arr))] = (arr, t)
    return t


def record_output(arr):
    arr._in_graph = True
    tape.outputs.append(weakref.ref(arr))


def invoke(fn, args, kwargs):
    """Run ``fn`` (an op over torch tensors) on NDArray arguments.

    Returns (raw output(s), recording): ``recording`` is true when the
    call was recorded (recording is on and some input is in the graph),
    and the caller then marks the outputs with ``record_output``."""
    from .ndarray.ndarray import NDArray

    inputs = [a for a in args if isinstance(a, NDArray)]
    inputs += [v for v in kwargs.values() if isinstance(v, NDArray)]
    # the multi-tensor ops take lists of arrays: a list or tuple that
    # holds one is passed on as a list of tensors, any other as it is
    lists = {i for i, a in enumerate(args) if isinstance(a, (list, tuple))
             and any(isinstance(x, NDArray) for x in a)}
    inputs += [x for i in lists for x in args[i] if isinstance(x, NDArray)]
    recording = state.is_recording and any(a._in_graph for a in inputs)
    if recording:
        for a in inputs:
            if a._grad is not None:
                leaf_tensor(a)
    call_args = [a._data if isinstance(a, NDArray) else
                 [x._data if isinstance(x, NDArray) else x for x in a]
                 if i in lists else a for i, a in enumerate(args)]
    call_kwargs = {k: (v._data if isinstance(v, NDArray) else v)
                   for k, v in kwargs.items()}
    t0 = _profile_begin() if prof_flags['op'] else None
    try:
        if recording:
            with torch.enable_grad():
                out = fn(*call_args, **call_kwargs)
        elif any(a._data.requires_grad for a in inputs):
            with torch.no_grad():
                out = fn(*call_args, **call_kwargs)
        else:
            out = fn(*call_args, **call_kwargs)
    except (MXNetError, torch.cuda.OutOfMemoryError):
        raise
    except (TypeError, ValueError, ZeroDivisionError, IndexError,
            RuntimeError) as e:
        # the reference surfaces op failures as MXNetError
        name = getattr(fn, '__name__', str(fn))
        raise MXNetError(f"Error in operator {name}: {e}") from e
    if t0 is not None:
        _profile_end(fn, t0)
    return out, recording


def _profile_begin():
    """The start of a profiled op (``profiler.set_config(
    profile_imperative=True)``): with ``profile_sync`` (or
    ``aggregate_stats``) the card's queue drained first, so the row
    times the op to completion and not its launch."""
    if prof_flags['sync'] and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def _profile_end(fn, t0):
    from . import profiler
    if prof_flags['sync'] and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    profiler.record_op(getattr(fn, '__name__', str(fn)),
                       (time.perf_counter() - t0) * 1e6)


def _graph_nodes(tensors):
    """Every autograd node reachable backwards from ``tensors``."""
    seen = set()
    stack = [t.grad_fn for t in tensors if t.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions if n is not None)
    return seen


def _consume(nodes):
    """Detach the recorded outputs whose node is in ``nodes`` (all of
    them for None); a variable stays in the graph."""
    alive = []
    for ref in tape.outputs:
        arr = ref()
        if arr is None:
            continue
        fn = arr._data.grad_fn
        if nodes is None or (fn is not None and fn in nodes):
            arr._data = arr._data.detach()
            arr._in_graph = arr._grad is not None
        else:
            alive.append(ref)
    tape.outputs = alive


def _as_lists(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    return list(heads), list(head_grads)


def _seed(head, hg):
    from .ndarray.ndarray import NDArray
    if hg is None:
        return torch.ones_like(head._data)
    g = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
    return g.to(device=head._data.device, dtype=head._data.dtype)


def _write_grad(arr, g):
    write = getattr(arr, '_tape_write', None)
    if write is not None:
        write(g)
        return
    buf = arr._grad
    g = g.detach().to(buf._data.dtype)
    if arr._grad_req == 'add':
        buf._data = buf._data + g
    elif arr._grad_req != 'null':
        buf._data = g


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Reverse pass writing into the variables' ``.grad`` arrays (ref:
    Imperative::Backward, src/imperative/imperative.cc:280)."""
    heads, head_grads = _as_lists(heads, head_grads)
    live = [(h, g) for h, g in zip(heads, head_grads)
            if h._data.requires_grad]
    if not live:
        return
    outs = [h._data for h, _ in live]
    nodes = None if retain_graph else _graph_nodes(outs)
    variables = [(a, t) for a, t in tape.variables.values()
                 if a._grad_req != 'null' and a._grad is not None]
    if variables:
        rec = state.is_recording
        state.is_recording = False
        try:
            grads = torch.autograd.grad(
                outs, [t for _, t in variables],
                grad_outputs=[_seed(h, g) for h, g in live],
                retain_graph=retain_graph, allow_unused=True)
        finally:
            state.is_recording = rec
        for (arr, _), g in zip(variables, grads):
            if g is not None:
                _write_grad(arr, g)
    if retain_graph:
        tape.retained = True
    else:
        _consume(nodes)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """autograd.grad (ref: python/mxnet/autograd.py:271): the gradients of
    ``heads`` with respect to ``variables``, as new NDArrays (zeros where
    a variable is not reached); with ``create_graph`` they are recorded,
    for higher-order gradients."""
    from .ndarray.ndarray import NDArray

    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    heads, head_grads = _as_lists(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    live = [(h, g) for h, g in zip(heads, head_grads)
            if h._data.requires_grad]
    targets = [i for i, v in enumerate(variables) if v._data.requires_grad]
    found = {}
    if live and targets:
        rec = state.is_recording
        if not create_graph:
            state.is_recording = False
        try:
            gs = torch.autograd.grad(
                [h._data for h, _ in live],
                [variables[i]._data for i in targets],
                grad_outputs=[_seed(h, g) for h, g in live],
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
        finally:
            state.is_recording = rec
        found = {i: g for i, g in zip(targets, gs) if g is not None}
    results = []
    for i, v in enumerate(variables):
        g = found.get(i)
        out = NDArray(torch.zeros_like(v._data.detach()) if g is None
                      else g if create_graph else g.detach())
        if create_graph and g is not None and g.requires_grad:
            record_output(out)
        results.append(out)
    if retain_graph:
        tape.retained = True
    else:
        tape.clear()
    return results[0] if single else results
