"""Device contexts (counterpart of ``mxnet_tpu/context.py``).

``Context('gpu', i)`` is CUDA device i and ``Context('cpu', 0)`` the host.
``tpu(i)`` resolves to CUDA device i, as the JAX package resolves
``gpu(i)`` to its accelerator, so scripts written for the JAX package
run. The default context is ``gpu(0)``, not the JAX package's ``cpu(0)``:
outside a ``with mx.cpu():`` scope and with no ``ctx=``, NDArrays go to
the card, and with no card they raise. Nothing falls back to the CPU.

``resolve_device`` does the same for the Gluon and serving entry points,
which take a ``device=`` argument.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ['Context', 'cpu', 'gpu', 'tpu', 'cpu_pinned', 'num_gpus',
           'current_context', 'resolve_device']

_CPU_TYPES = ('cpu', 'cpu_pinned', 'cpu_shared')


def _no_card(what):
    return MXNetError(f"{what} requested but no CUDA device is available; "
                      f"pass ctx=mx.cpu() to run on the host")


class Context:
    """A device context. devtype in {'cpu', 'gpu', 'tpu', 'cpu_pinned',
    'cpu_shared'}."""

    devtype2id = {'cpu': 1, 'gpu': 2, 'cpu_pinned': 3, 'tpu': 4,
                  'cpu_shared': 5}
    devid2type = {v: k for k, v in devtype2id.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in self.devtype2id:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = device_id

    @property
    def device_typeid(self) -> int:
        return self.devtype2id[self.device_type]

    @property
    def device(self) -> torch.device:
        """The torch device of this context; a card context raises when
        there is no such card."""
        if self.device_type in _CPU_TYPES:
            return torch.device('cpu')
        if not torch.cuda.is_available():
            raise _no_card(str(self))
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"{self}: device_id {self.device_id} out of "
                             f"range ({torch.cuda.device_count()} "
                             f"available)")
        return torch.device('cuda', self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(self._default_ctx, 'stack'):
            self._default_ctx.stack = []
        self._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc):
        self._default_ctx.stack.pop()

    @classmethod
    def default_ctx(cls) -> "Context":
        stack = getattr(cls._default_ctx, 'stack', None)
        if stack:
            return stack[-1]
        return _DEFAULT


def cpu(device_id: int = 0) -> Context:
    return Context('cpu', device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context('cpu_pinned', device_id)


def gpu(device_id: int = 0) -> Context:
    return Context('gpu', device_id)


def tpu(device_id: int = 0) -> Context:
    return Context('tpu', device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    return Context.default_ctx()


def context_of(device: torch.device) -> Context:
    """The context of a tensor's device."""
    if device.type == 'cuda':
        return Context('gpu', device.index or 0)
    return Context('cpu', 0)


_DEFAULT = Context('gpu', 0)


def resolve_device(device=None) -> torch.device:
    """``None`` means the device of the ``with mx.cpu():`` / ``with
    mx.gpu(i):`` scope around the call, and outside any scope the current
    CUDA device; ``'cpu'`` (or a CPU ``torch.device``) is honoured only
    when asked for, by name or by a scope."""
    if device is None:
        stack = getattr(Context._default_ctx, 'stack', None)
        dev = stack[-1].device if stack else torch.device('cuda')
    else:
        dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise MXNetError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ('cuda', 'cpu'):
        raise MXNetError(f"unsupported device {str(dev)!r}")
    return dev
