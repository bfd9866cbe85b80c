"""Checkpoint helpers for the symbolic API (counterpart of
``mxnet_tpu/model.py``, ref: python/mxnet/model.py): ``prefix-symbol.json``
and ``prefix-NNNN.params`` in the reference's binary format, keyed
``arg:<name>``/``aux:<name>``, which the JAX package and MXNet read."""
from __future__ import annotations

from . import symbol as sym_mod
from .ndarray.ndarray import array

__all__ = ['save_checkpoint', 'load_checkpoint', 'BatchEndParam']


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-{epoch:04d}.params`` (ref: model.py save_checkpoint)."""
    from .serialization import atomic_write_file, save_ndarray_file
    if symbol is not None:
        symbol.save(f'{prefix}-symbol.json')
    payload = {f'arg:{k}': v.asnumpy() for k, v in arg_params.items()}
    payload.update({f'aux:{k}': v.asnumpy() for k, v in aux_params.items()})
    atomic_write_file(f'{prefix}-{epoch:04d}.params',
                      save_ndarray_file(payload))


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) from a checkpoint pair (ref:
    model.py load_checkpoint); the arrays go to ``ctx`` (the current
    context when None)."""
    from .serialization import load_params_dict
    symbol = sym_mod.load(f'{prefix}-symbol.json')
    with open(f'{prefix}-{epoch:04d}.params', 'rb') as f:
        payload = load_params_dict(f.read(), strip_arg_aux=False)
    arg_params, aux_params = {}, {}
    for k, v in payload.items():
        tp, name = k.split(':', 1)
        (arg_params if tp == 'arg' else aux_params)[name] = array(v, ctx=ctx)
    return symbol, arg_params, aux_params


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals
