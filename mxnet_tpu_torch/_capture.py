"""CUDA-graph capture for the compiled training step and the Trainer's fused
update (the port's counterpart of ``jax.jit`` on those two programs).

A captured graph replays fixed kernels on fixed addresses, so what changes
from one step to the next lives in tensors the graph reads:

- ``DeviceScalars``: per-step scalars (lr, wd, t, rescale_grad) in one f32
  device vector that the host rewrites before each replay, through a
  pinned buffer and one asynchronous copy; no sync except on the previous
  step's copy, long finished by then.
- ``capture``: runs a function once under ``torch.cuda.graph`` on a side
  stream and returns the graph and the function's outputs, which are the
  graph's static output tensors. A failure raises ``MXNetError``: nothing
  falls back to eager on the card. The capture's seconds go to the
  compile ledger (``telemetry.compile.report``) after the capture has
  ended, as a ``capture`` phase of the window the caller opened.

On the CPU nothing is captured: the same function runs eagerly, with the
scalars in a CPU tensor.
"""
from __future__ import annotations

import time

import torch

from .base import MXNetError
from .telemetry import compile as _compile

__all__ = ['DeviceScalars', 'capture', 'module_generators',
           'graph_generators', 'HostCallInCapture', 'host_call',
           'host_calls']

# calls of ops that compute on the host, in this process
_host_calls = [0]


class HostCallInCapture(MXNetError):
    """A function being captured calls an op that computes on the host."""


def host_call(name):
    """One call of the host op ``name``: counted, and refused while the
    current stream captures."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise HostCallInCapture(
            f"op {name!r} computes on the host and cannot run inside a "
            f"CUDA graph capture")
    _host_calls[0] += 1


def host_calls():
    """How many host op calls this process has made."""
    return _host_calls[0]


class DeviceScalars:
    """``n`` f32 scalars on ``device`` (``self.values``), written from the
    host with ``write`` and read on the device by whatever runs after the
    write on the current stream."""

    def __init__(self, n, device):
        device = torch.device(device)
        self.values = torch.zeros(n, dtype=torch.float32, device=device)
        self._pinned = self._copied = None
        if device.type == 'cuda':
            self._pinned = torch.zeros(n, dtype=torch.float32,
                                       pin_memory=True)
            self._copied = torch.cuda.Event()

    def write(self, values):
        if self._pinned is None:
            self.values.copy_(torch.tensor(values, dtype=torch.float32))
            return
        # the pinned buffer is read by the last copy: wait for it alone
        self._copied.synchronize()
        self._pinned.numpy()[:] = values
        self.values.copy_(self._pinned, non_blocking=True)
        self._copied.record()


def module_generators(module):
    """The CUDA ``torch.Generator``s the modules of ``module`` draw from
    (their ``generator`` attribute): a graph that draws from one must
    register it, or every replay would reuse one draw."""
    gens = {}
    for m in module.modules():
        g = getattr(m, 'generator', None)
        if isinstance(g, torch.Generator) and g.device.type == 'cuda':
            gens[id(g)] = g
    return list(gens.values())


def graph_generators(module, device):
    """``module_generators`` and the port's own generator of ``device``
    (``random.generator``, which ``nd.dropout`` draws from; made now if
    it is not yet, since the capture's warm-up may be its first use), once
    each."""
    from . import random as _random
    gens = module_generators(module)
    own = _random.generator(device)
    if all(g is not own for g in gens):
        gens.append(own)
    return gens


def capture(fn, device, generators=(), warm_up=False, stream=None):
    """(graph, out, first): fn's work captured into one ``CUDAGraph`` on a
    side stream, not run (``graph.replay()`` runs it), with ``out`` what
    fn returned during the capture, the graph's static outputs. With
    ``warm_up`` fn first runs once eagerly on the same side stream, so
    that kernels are built and libraries initialised outside the capture;
    ``first`` is what that run returned (None without it). ``generators``
    are registered with the graph, so each replay draws fresh numbers
    from them (the device's default generator is registered by torch).
    ``stream`` is the side stream (a new one by default): graphs whose
    backward continues another's forward are captured on one stream, the
    one autograd runs that backward on."""
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device) if stream is None else stream
    stream.wait_stream(current)
    first = None
    if warm_up:
        calls = _host_calls[0]
        with torch.cuda.stream(stream):
            first = fn()
        if _host_calls[0] != calls:
            raise HostCallInCapture(
                f"the function to capture called {_host_calls[0] - calls} "
                f"op(s) that compute on the host")
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=stream):
            out = fn()
    except HostCallInCapture:
        raise
    except Exception as e:
        raise MXNetError(f"CUDA graph capture failed: {type(e).__name__}: "
                         f"{e}") from e
    current.wait_stream(stream)
    _compile.report('capture', time.perf_counter() - t0, 'capture')
    return graph, out, first
