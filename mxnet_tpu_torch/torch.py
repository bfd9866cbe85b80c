"""The PyTorch bridge (counterpart of ``mxnet_tpu/torch.py``, ref:
python/mxnet/torch.py, plugin/torch/).

In the port an NDArray already holds a torch tensor, so the bridge moves
nothing: ``to_torch`` and ``from_torch`` share the storage, on the card
as on the CPU (the same ``data_ptr()``), without the autograd graph.

``TorchOp(fn)`` runs a torch callable (a function or an ``nn.Module``) as
a framework op. Called inside ``autograd.record()`` it records one
autograd node, whose backward is ``torch.autograd.grad`` over the
callable's own graph: the gradients of the inputs flow on to MXNet's
backward, and an ``nn.Module``'s parameters accumulate theirs in their
``.grad`` (torch's rule, so a torch optimizer can step them), as the JAX
package's bridge does. Tensors stay on their device.

This module is ``mx.torch``; it imports PyTorch as ``torch`` absolutely,
as every module of the port does.
"""
from __future__ import annotations

import torch

from .ndarray.ndarray import NDArray, _invoke

__all__ = ['to_torch', 'from_torch', 'TorchOp']


def to_torch(arr):
    """NDArray -> torch.Tensor over the same storage."""
    if not isinstance(arr, NDArray):
        raise TypeError("to_torch expects an NDArray")
    return arr._data.detach()


def from_torch(tensor):
    """torch.Tensor -> NDArray over the same storage."""
    if not isinstance(tensor, torch.Tensor):
        raise TypeError("from_torch expects a torch.Tensor")
    return NDArray(tensor.detach())


class _TorchOpNode(torch.autograd.Function):
    """One node for a torch callable: forward runs it with grad enabled
    on detached inputs and keeps its graph; backward asks that graph for
    the inputs' gradients and adds the module parameters' into their
    ``.grad``."""

    @staticmethod
    def forward(ctx, fn, params, meta, *xs):
        ins = [x.detach().requires_grad_(x.is_floating_point()) for x in xs]
        with torch.enable_grad():
            out = fn(*ins)
        meta['tuple'] = isinstance(out, (tuple, list))
        outs = list(out) if meta['tuple'] else [out]
        ctx.ins, ctx.outs, ctx.params = ins, outs, params
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        pairs = [(o, c) for o, c in zip(ctx.outs, cts)
                 if o.requires_grad and c is not None]
        diff = [x for x in ctx.ins if x.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], diff + ctx.params,
            grad_outputs=[c for _, c in pairs], retain_graph=True,
            allow_unused=True) if pairs else [None] * (len(diff) +
                                                       len(ctx.params))
        for p, g in zip(ctx.params, grads[len(diff):]):
            if g is not None:
                p.grad = g if p.grad is None else p.grad + g
        it = iter(grads[:len(diff)])
        in_grads = [next(it) if x.requires_grad else None for x in ctx.ins]
        return (None, None, None, *in_grads)


class TorchOp:
    """Run a torch callable (function or ``nn.Module``) as a framework
    op on NDArrays (or tensors, inside a ``hybrid_forward``)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *inputs):
        fn = self.fn
        params = [p for p in fn.parameters() if p.requires_grad] \
            if isinstance(fn, torch.nn.Module) else []

        def torch_op(*tensors):
            if torch.is_grad_enabled():
                meta = {}
                outs = _TorchOpNode.apply(fn, params, meta, *tensors)
                return outs if meta['tuple'] else outs[0]
            return fn(*tensors)
        torch_op.__name__ = f'TorchOp[{type(fn).__name__}]'
        return _invoke(torch_op, *inputs)
