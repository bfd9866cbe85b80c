"""The legacy data-parallel executor manager (counterpart of
``mxnet_tpu/executor_manager.py``, ref: python/mxnet/executor_manager.py
DataParallelExecutorManager, the pre-Module driver of FeedForward).

One executor per context, each bound to its slice of the batch (the
slices proportional to ``work_load_list``), as Module binds them. The
contexts default to the card."""
from __future__ import annotations

import logging

import torch

from .ndarray.ndarray import NDArray, array


def _split_input_slice(batch_size, work_load_list):
    """Batch slices proportional to work loads (ref:
    executor_manager.py:_split_input_slice)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


class DataParallelExecutorManager:
    """One executor per context over sliced batches (ref:
    executor_manager.py:DataParallelExecutorManager)."""

    def __init__(self, symbol, ctx=None, train_data=None, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=logging, sym_gen=None, data_shapes=None,
                 label_shapes=None):
        self.symbol = symbol
        from .module import _default_contexts
        self.ctx = _default_contexts(ctx)
        self.logger = logger
        work_load_list = work_load_list or [1] * len(self.ctx)
        assert len(work_load_list) == len(self.ctx)
        self._work_load_list = work_load_list

        # I/O names keep the PROVIDE order (data first, then labels):
        # load_data_batch zips batch tensors against this order, so it
        # must match the iterator's, not alphabetical order
        shapes = {}
        self._io_names = []

        def add(desc_list):
            for desc in desc_list:
                name, shape = (desc.name, desc.shape) \
                    if hasattr(desc, 'name') else desc[:2]
                if name not in shapes:
                    self._io_names.append(name)
                shapes[name] = tuple(shape)

        # all DATA names first (explicit + iterator), then all LABELS —
        # the zip target must be [batch.data..., batch.label...]
        add(data_shapes or [])
        if train_data is not None:
            add(list(getattr(train_data, 'provide_data', [])))
        add(label_shapes or [])
        if train_data is not None:
            add(list(getattr(train_data, 'provide_label', [])))
        batch = shapes[self._io_names[0]][0] if self._io_names else 0
        self.slices = _split_input_slice(batch, work_load_list)

        arg_names = arg_names or symbol.list_arguments()
        self.param_names = param_names or \
            [n for n in arg_names if n not in shapes]
        self.arg_names = arg_names
        self.aux_names = aux_names or []

        self.execs = []
        for i, c in enumerate(self.ctx):
            ctx_shapes = dict(shapes)
            n = self.slices[i]
            for io in self._io_names:
                full = shapes[io]
                ctx_shapes[io] = (n.stop - n.start,) + full[1:]
            missing = [a for a in arg_names if a not in ctx_shapes]
            if missing:
                from .module import _infer_missing
                ctx_shapes.update(_infer_missing(symbol, ctx_shapes))
            self.execs.append(symbol.simple_bind(c, grad_req='write',
                                                 **ctx_shapes))

    @property
    def param_arrays(self):
        return [[e.arg_dict[n] for e in self.execs]
                for n in self.param_names]

    @property
    def grad_arrays(self):
        return [[e.grad_dict[n] for e in self.execs]
                for n in self.param_names]

    def set_params(self, arg_params, aux_params=None):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=True)

    def copy_to(self, arg_params, aux_params=None):
        """Copy current parameter VALUES out (ref: executor_manager.py
        copy_to — a snapshot, not an alias of the live weights)."""
        for name in self.param_names:
            src = self.execs[0].arg_dict[name]
            if name in arg_params:
                arg_params[name]._data = src._data.clone()
            else:
                arg_params[name] = array(src.asnumpy())
        if aux_params is not None:
            for name in self.aux_names:
                if name in self.execs[0].aux_dict:
                    aux_params[name] = array(
                        self.execs[0].aux_dict[name].asnumpy())

    def load_data_batch(self, data_batch):
        datas = list(data_batch.data) + list(data_batch.label or [])
        for arr, name in zip(datas, self._io_names):
            t = arr._data if isinstance(arr, NDArray) else \
                torch.as_tensor(arr)
            for e, sl in zip(self.execs, self.slices):
                dst = e.arg_dict[name]
                dst._data = t[sl].to(device=dst._data.device,
                                     dtype=dst._data.dtype)

    def forward(self, is_train=False):
        for e in self.execs:
            e.forward(is_train=is_train)

    def backward(self):
        for e in self.execs:
            e.backward()

    def update_metric(self, metric, labels):
        outs = [e.outputs[0] for e in self.execs]
        for out, sl in zip(outs, self.slices):
            metric.update([l[sl] for l in labels], [out])
