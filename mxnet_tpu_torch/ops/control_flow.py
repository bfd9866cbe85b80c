"""Control-flow operators: ``foreach``, ``while_loop`` and ``cond``
(counterpart of ``mxnet_tpu/ops/control_flow.py``, ref:
src/operator/control_flow.cc:1089,1150,1211 and the imperative
frontends of python/mxnet/ndarray/contrib.py).

Each runs its body as a Python loop (or branch) over the port's ops, on
NDArrays or on tensors (a ``hybrid_forward`` hands its ops tensors), so
``mx.autograd`` records every iteration and parameters the body closes
over get their gradients, as MXNet's imperative frontends do. The JAX
package's traced forms (``lax.scan``/``while_loop``/``cond`` under jit)
have no counterpart: the port traces nothing, and on the card a loop's
predicate is read on the host each iteration.

``while_loop`` pads its stacked outputs with zeros to ``max_iterations``
when that is given, as the reference does; with no iteration run it
returns ``[]`` for the outputs.
"""
from __future__ import annotations

import inspect

import torch

__all__ = ['foreach', 'while_loop', 'cond']


def _is_leaf(x):
    from ..ndarray.ndarray import NDArray
    return not isinstance(x, (list, tuple)) or isinstance(x, NDArray)


def _flatten(tree):
    """(leaves, structure) of a nested list/tuple of arrays."""
    if _is_leaf(tree):
        return [tree], None
    leaves, defs = [], []
    for t in tree:
        sub, d = _flatten(t)
        leaves += sub
        defs.append((len(sub), d))
    return leaves, (type(tree), defs)


def _unflatten(structure, leaves):
    if structure is None:
        return leaves[0]
    kind, defs = structure
    out, i = [], 0
    for n, d in defs:
        out.append(_unflatten(d, leaves[i:i + n]))
        i += n
    return kind(out)


def _stack(parts, pad=0):
    """The parts stacked along a new axis 0, then ``pad`` rows of zeros:
    ``nd`` ops on NDArrays (recorded), torch ops on tensors."""
    if isinstance(parts[0], torch.Tensor):
        out = torch.stack(parts)
        if pad:
            out = torch.cat([out, out.new_zeros((pad,) + out.shape[1:])])
        return out
    from .. import ndarray as nd
    out = nd.stack(*parts, axis=0)
    if pad:
        out = nd.concat(out, nd.zeros((pad,) + out.shape[1:],
                                      ctx=out.context, dtype=out.dtype),
                        dim=0)
    return out


def _stack_outputs(outputs, pad=0):
    out_def = _flatten(outputs[0])[1]
    lists = [_flatten(o)[0] for o in outputs]
    return _unflatten(out_def, [_stack([ol[i] for ol in lists], pad)
                                for i in range(len(lists[0]))])


def _as_scalar(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(()).item()
    if hasattr(x, 'asnumpy'):
        return x.asnumpy().reshape(()).item()
    return x


def foreach(body, data, init_states):
    """Run ``body(data[t], states) -> (outputs, new_states)`` over the
    leading axis of ``data`` (an array or a nested list of arrays);
    returns (the outputs stacked, the final states). Ref:
    control_flow.cc:1089 ``_foreach``."""
    data_leaves, data_def = _flatten(data)
    states = init_states
    outputs = []
    for t in range(data_leaves[0].shape[0]):
        out, states = body(_unflatten(data_def, [d[t] for d in data_leaves]),
                           states)
        outputs.append(out)
    return _stack_outputs(outputs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func(loop_vars) -> (step_output, new_loop_vars)`` while
    ``cond(loop_vars)`` holds (at most ``max_iterations`` times); returns
    (the outputs stacked and zero-padded to ``max_iterations``, the final
    loop variables). Ref: control_flow.cc:1150 ``_while_loop``."""
    steps = 0
    outputs = []
    while bool(_as_scalar(cond(loop_vars))):
        out, loop_vars = func(loop_vars)
        outputs.append(out)
        steps += 1
        if max_iterations is not None and steps >= max_iterations:
            break
    if not outputs:
        return [], loop_vars
    pad = (max_iterations - steps) if max_iterations is not None else 0
    return _stack_outputs(outputs, pad), loop_vars


def _expects_arg(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return any(p.default is p.empty and
               p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               for p in sig.parameters.values())


def cond(pred, then_func, else_func, inputs=None):
    """``then_func`` or ``else_func`` by the scalar ``pred`` (read on the
    host); a branch that takes an argument gets ``inputs``. Ref:
    control_flow.cc:1211 ``_cond``."""
    branch = then_func if bool(_as_scalar(pred)) else else_func
    if inputs is not None and _expects_arg(branch):
        return branch(inputs)
    return branch()
