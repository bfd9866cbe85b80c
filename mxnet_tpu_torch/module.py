"""Module API: MXNet's symbolic training loop (counterpart of
``mxnet_tpu/module.py``, ref: python/mxnet/module/).

``BaseModule.fit`` (base_module.py:409), ``score`` and ``predict``;
``Module`` (module.py), one Executor per context, the batch split over
them as DataParallelExecutorGroup.decide_slices does (executor_group.py:
282); ``BucketingModule`` (one Module per bucket key, the parameters
shared); ``SequentialModule``.

The default context is the card (the CPU inside ``with mx.cpu():``; with
no card and no such scope the constructor raises). ``update`` sums each
parameter's gradient over the executors and applies the optimizer's
updater to it, one parameter at a time, in place on the weight the
executors share; ``rescale_grad`` defaults to 1/batch, as MXNet's
``init_optimizer`` sets it. Data and labels are bound without gradient
(``inputs_need_grad`` asks for one), as are ``fixed_param_names``.
``get_params`` returns copies of the parameters (MXNet's
``_sync_params_from_devices``), so a caller holding them does not see
later updates.
"""
from __future__ import annotations

import logging

import torch

from .base import MXNetError
from .context import Context, context_of, resolve_device
from .ndarray.ndarray import NDArray
from .ndarray.utils import split_data
from . import initializer as init_mod
from . import metric as metric_mod
from . import optimizer as opt_mod
from .model import BatchEndParam, load_checkpoint, save_checkpoint

__all__ = ['BaseModule', 'Module', 'BucketingModule', 'SequentialModule']


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]


def _desc(desc):
    return (desc.name, tuple(desc.shape)) if hasattr(desc, 'name') \
        else (desc[0], tuple(desc[1]))


class BaseModule:
    """Ref: module/base_module.py BaseModule."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    def forward_backward(self, data_batch):
        """Ref: base_module.py:193."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                bec = BatchEndParam(epoch, nbatch, eval_metric)
                for cb in _as_list(batch_end_callback):
                    cb(bec)
        if score_end_callback is not None:
            bec = BatchEndParam(epoch, nbatch, eval_metric)
            for cb in _as_list(score_end_callback):
                cb(bec)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            out = self.get_outputs()[0]
            outputs.append(out[0:out.shape[0] - pad] if pad else out)
        if merge_batches:
            from .ndarray import concat
            return concat(*outputs, dim=0) if len(outputs) > 1 \
                else outputs[0]
        return outputs

    def fit(self, train_data, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None,
            kvstore='local', optimizer='sgd',
            optimizer_params=(('learning_rate', 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint_manager=None):
        """Training loop (ref: base_module.py:409).

        ``checkpoint_manager`` (or a ``callback.module_checkpoint(...,
        manager=...)`` among the epoch-end callbacks) makes an interrupt
        resumable: KeyboardInterrupt and SIGTERM commit one last
        synchronous checkpoint and return with a "resumable from step N"
        warning. A manager given here owns the cadence (``maybe_save``
        every batch, steps counted in batches from its newest step); one
        found on a callback saves by epoch, and fit only reports it."""
        assert num_epoch is not None, 'please specify number of epochs'
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if monitor is not None:
            self.install_monitor(monitor)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        mgr = checkpoint_manager
        mgr_owns_cadence = checkpoint_manager is not None
        if mgr is None and epoch_end_callback is not None:
            for cb in _as_list(epoch_end_callback):
                if getattr(cb, 'manager', None) is not None:
                    mgr = cb.manager
                    break
        installed_hook = False
        bound_params = False
        if mgr is not None:
            if not mgr.params_bound:
                # a Module manager is usually params-unbound (the callback
                # passes arg:/aux: per save): bind a provider for this fit,
                # so cadence saves and the SIGTERM hook commit real params
                def _module_params():
                    from .callback import prefix_arg_aux_params
                    return prefix_arg_aux_params(*self.get_params())
                mgr.bind_params(_module_params)
                bound_params = True
            if not mgr.hook_installed:
                mgr.install_preemption_hook()
                installed_hook = mgr.hook_installed
        global_step = (mgr.latest_step() or 0) if mgr_owns_cadence else 0
        interrupted = None
        try:
            for epoch in range(begin_epoch, num_epoch):
                eval_metric.reset()
                nbatch = 0
                train_data.reset()
                for data_batch in train_data:
                    if monitor is not None:
                        monitor.tic()
                    self.forward_backward(data_batch)
                    self.update()
                    if monitor is not None:
                        monitor.toc_print()
                    self.update_metric(eval_metric, data_batch.label)
                    if batch_end_callback is not None:
                        bec = BatchEndParam(epoch, nbatch, eval_metric)
                        for cb in _as_list(batch_end_callback):
                            cb(bec)
                    nbatch += 1
                    global_step += 1
                    if mgr_owns_cadence:
                        mgr.maybe_save(global_step,
                                       metadata={'epoch': epoch,
                                                 'nbatch': nbatch})
                    if mgr is not None and mgr.preempted:
                        interrupted = 'SIGTERM'
                        break
                if interrupted:
                    break
                for name, val in eval_metric.get_name_value():
                    self.logger.info('Epoch[%d] Train-%s=%f', epoch, name,
                                     val)
                if epoch_end_callback is not None:
                    arg_params, aux_params = self.get_params()
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_params, aux_params)
                if eval_data is not None:
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in res:
                        self.logger.info('Epoch[%d] Validation-%s=%f',
                                         epoch, name, val)
        except KeyboardInterrupt:
            interrupted = 'KeyboardInterrupt'
        finally:
            # the interrupt save below still needs the provider: only the
            # signal hook goes here, and the provider too when an error
            # is escaping (this is then the last of fit that runs)
            if installed_hook:
                mgr.uninstall_preemption_hook()
            import sys as _sys
            if bound_params and _sys.exc_info()[0] is not None:
                mgr.bind_params(None)
                bound_params = False
        try:
            if interrupted:
                self._report_interrupt(interrupted, mgr, mgr_owns_cadence,
                                       global_step)
        finally:
            # a second Ctrl-C during the final save must not leave the
            # provider bound
            if bound_params:
                mgr.bind_params(None)

    def _report_interrupt(self, interrupted, mgr, mgr_owns_cadence,
                          global_step):
        if mgr_owns_cadence and global_step:
            try:
                if mgr.latest_step() != global_step:
                    mgr.save_now(global_step)
                self.logger.warning(
                    'training interrupted (%s); checkpoint committed — '
                    'resumable from step %d', interrupted, global_step)
            except Exception:   # noqa: BLE001  (reported, not raised)
                self.logger.exception(
                    'training interrupted (%s) but the final checkpoint '
                    'save failed', interrupted)
        elif mgr is not None:
            latest = mgr.latest_step()
            if latest is not None:
                self.logger.warning(
                    'training interrupted (%s); resumable from the '
                    'checkpoint at step %d', interrupted, latest)
            else:
                self.logger.warning(
                    'training interrupted (%s) before the first completed '
                    'checkpoint; nothing saved', interrupted)
        else:
            self.logger.warning(
                'training interrupted (%s) at step %d; no checkpoint '
                'manager bound, nothing saved', interrupted, global_step)

    @property
    def symbol(self):
        return self._symbol

    def install_monitor(self, mon):
        """Install a Monitor on every bound executor (ref:
        base_module.py install_monitor)."""
        assert self.binded, 'call bind before installing a monitor'
        for e in self._execs:
            mon.install(e)

    # abstract methods
    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError


def _default_contexts(context):
    """The contexts as a list: the card (or the ``with mx.cpu():`` scope's
    device) for None, raising when neither exists."""
    if context is None:
        return [context_of(resolve_device(None))]
    contexts = list(context) if isinstance(context, (list, tuple)) \
        else [context]
    for c in contexts:
        c.device        # raises for a card that is not there
    return contexts


class Module(BaseModule):
    """Ref: module/module.py Module. One Executor per context; batches are
    split over the contexts as DataParallelExecutorGroup splits them;
    ``group2ctxs`` (a dict, or one per context) places the symbol groups
    of ``mx.AttrScope(ctx_group=...)`` on their own devices."""

    def __init__(self, symbol, data_names=('data',),
                 label_names=('softmax_label',), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        # update() pushes nothing through a kvstore, so the error-feedback
        # codec applies to each summed gradient there (ref: module.py
        # compression_params, the JAX Module's contract)
        self._compression = None
        if compression_params is not None and \
                compression_params.get('type', '2bit') != 'none':
            from .kvstore.gradient_compression import GradientCompression
            self._compression = GradientCompression(
                compression_params.get('type', '2bit'),
                compression_params.get('threshold', 0.5),
                compression_params.get('block_size', 0))
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = _default_contexts(context)
        if isinstance(group2ctxs, dict):
            group2ctxs = [group2ctxs] * len(self._context)
        if group2ctxs is not None and len(group2ctxs) != len(self._context):
            raise ValueError(
                f"group2ctxs has {len(group2ctxs)} entries for "
                f"{len(self._context)} contexts; pass one dict (shared) "
                f"or one per context")
        self._group2ctxs = group2ctxs
        self._fixed_param_names = set(fixed_param_names or [])
        self._arg_params = None
        self._aux_params = None
        self._execs = []
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._data_shapes = {}

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    def _param_names(self):
        return [n for n in self._symbol.list_arguments()
                if n not in self._data_names and n not in self._label_names]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        shapes = dict(_desc(d) for d in data_shapes)
        shapes.update(_desc(d) for d in (label_shapes or []))
        self._data_shapes = shapes
        n = len(self._context)
        io_names = set(self._data_names) | set(self._label_names)
        arg_names = self._symbol.list_arguments()
        reqs = {}
        for name in arg_names:
            if not for_training or name in self._fixed_param_names or \
                    (name in io_names and not inputs_need_grad):
                reqs[name] = 'null'
            else:
                reqs[name] = grad_req
        self._execs = []
        for i, ctx in enumerate(self._context):
            ctx_shapes = {name: ((shape[0] // n,) + shape[1:]
                                 if name in io_names else shape)
                          for name, shape in shapes.items()}
            ctx_shapes.update(_infer_missing(self._symbol, ctx_shapes))
            g2c = self._group2ctxs[i] if self._group2ctxs else None
            self._execs.append(self._symbol.simple_bind(
                ctx, grad_req=reqs, group2ctx=g2c, **ctx_shapes))
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self._share_params(shared_module)
        elif self.params_initialized:
            # Module.load, or a rebind: the kept parameters go in
            self._place_params(self._arg_params, self._aux_params)

    def _place_params(self, arg_params, aux_params):
        """Copy parameter values into executor 0's arrays (the others
        share its tensors where they are on its device)."""
        e0 = self._execs[0]
        self._arg_params = {}
        for name in self._param_names():
            arr = e0.arg_dict[name]
            if name in arg_params:
                src = arg_params[name]
                src = src._data if isinstance(src, NDArray) else \
                    torch.as_tensor(src)
                arr._data = src.detach().to(device=arr._data.device,
                                            dtype=arr._data.dtype).clone()
            self._arg_params[name] = arr
        self._aux_params = {}
        for name, arr in e0.aux_dict.items():
            if name in aux_params:
                src = aux_params[name]
                src = src._data if isinstance(src, NDArray) else \
                    torch.as_tensor(src)
                arr._data = src.detach().to(device=arr._data.device,
                                            dtype=arr._data.dtype).clone()
            self._aux_params[name] = arr
        self._share_to_execs()

    def _share_to_execs(self):
        for e in self._execs[1:]:
            for src, dst in ((self._arg_params, e.arg_dict),
                             (self._aux_params, e.aux_dict)):
                for name, arr in src.items():
                    d = dst[name]
                    d._data = arr._data if d._data.device == \
                        arr._data.device else arr._data.to(d._data.device)

    def _share_params(self, other):
        """Bind this module's executors to ``other``'s parameter tensors
        (a BucketingModule's buckets train one set of weights)."""
        for e in self._execs:
            for src, dst in ((other._arg_params, e.arg_dict),
                             (other._aux_params, e.aux_dict)):
                for name, arr in src.items():
                    if name in dst:
                        dst[name]._data = arr._data
        e0 = self._execs[0]
        self._arg_params = {n: e0.arg_dict[n] for n in self._param_names()}
        self._aux_params = dict(e0.aux_dict)
        self.params_initialized = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, 'call bind before initializing the parameters'
        initializer = initializer or init_mod.Uniform(0.01)
        arg_params, aux_params = arg_params or {}, aux_params or {}
        e0 = self._execs[0]
        for name in self._param_names():
            if name not in arg_params:
                initializer(init_mod.InitDesc(name), e0.arg_dict[name])
        for name, arr in e0.aux_dict.items():
            if name not in aux_params:
                initializer(init_mod.InitDesc(name), arr)
        self._place_params(arg_params, aux_params)
        self.params_initialized = True

    def get_params(self):
        """Copies of (arg_params, aux_params) as they stand."""
        def snap(d):
            return {n: NDArray(a._data.detach().clone())
                    for n, a in (d or {}).items()}
        return snap(self._arg_params), snap(self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(None, arg_params, aux_params, allow_missing,
                         force_init, allow_extra)

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            # summed data-parallel gradients normalised by the global batch
            # unless the caller sets rescale_grad (ref: module.py:527-537)
            if 'rescale_grad' not in optimizer_params:
                batch = next((self._data_shapes[n][0]
                              for n in self._data_names
                              if self._data_shapes.get(n)), 0)
                if batch:
                    optimizer_params['rescale_grad'] = 1.0 / batch
                else:
                    why = ('init_optimizer called before bind'
                           if not self.binded else
                           'bound data shapes have no usable batch size')
                    self.logger.warning(
                        '%s: cannot infer batch size, rescale_grad stays '
                        '1.0 — gradients will NOT be normalized by batch '
                        'size', why)
            optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        n = len(self._execs)
        data_slices = [split_data(d, n) if n > 1 else [d]
                       for d in data_batch.data]
        label_slices = [split_data(lab, n) if n > 1 else [lab]
                        for lab in (data_batch.label or [])]
        for i, e in enumerate(self._execs):
            feed = {name: slices[i]
                    for name, slices in zip(self._data_names, data_slices)}
            feed.update({name: slices[i] for name, slices in
                         zip(self._label_names, label_slices)
                         if name in e.arg_dict})
            e.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for e in self._execs:
            e.backward(out_grads)

    def update(self):
        """One optimizer update of each parameter with its gradient summed
        over the executors (ref: module.py:488-508)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for idx, name in enumerate(self._arg_params):
            if name in self._fixed_param_names:
                continue
            grads = [e.grad_dict[name]._data for e in self._execs
                     if e.grad_dict.get(name) is not None]
            if not grads:
                continue
            weight = self._arg_params[name]._data
            total = grads[0]
            for g in grads[1:]:
                total = total + g.to(total.device)
            if self._compression is not None:
                total = self._compression.compress_decompress(
                    NDArray(total), name)._data
            self._updater(idx, total, weight)
        self._share_to_execs()

    def get_outputs(self, merge_multi_context=True):
        outs = [e.outputs[0] for e in self._execs]
        if merge_multi_context and len(outs) > 1:
            from .ndarray import concat
            return [concat(*[o.as_in_context(outs[0].context)
                             for o in outs], dim=0)]
        return outs

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def save_optimizer_states(self, fname):
        from .serialization import atomic_write_file
        atomic_write_file(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        with open(fname, 'rb') as f:
            self._updater.set_states(f.read())

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states(f'{prefix}-{epoch:04d}.states')

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix-symbol.json`` whose parameters are those of
        ``prefix-{epoch:04d}.params``: bind it and it predicts (ref:
        module.py Module.load)."""
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=Context('cpu'))
        mod = Module(symbol, **kwargs)
        mod._arg_params, mod._aux_params = arg_params, aux_params
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f'{prefix}-{epoch:04d}.states'
        return mod


def _infer_missing(symbol, known_shapes):
    """The arguments' and auxiliary states' shapes that ``known_shapes``
    (the data and label shapes) leave out: shape propagation down the
    DAG, then the variables' ``__shape__`` hints."""
    from .symbol import _iter_nodes, infer_shapes_partial
    names = symbol.list_arguments() + symbol.list_auxiliary_states()
    missing = [n for n in names if n not in known_shapes]
    if not missing:
        return {}
    inferred = {n: s for n, s in infer_shapes_partial(symbol,
                                                      known_shapes).items()
                if n in missing}
    hints = {v._name: v.attrs.get('__shape__')
             for v in _iter_nodes(symbol, 'pre') if v.op is None}
    for n in missing:
        if n in inferred:
            continue
        if hints.get(n):
            inferred[n] = tuple(hints[n])
        else:
            raise MXNetError(
                f"cannot infer shape for argument '{n}'; pass it to bind() "
                "or declare shape on the variable")
    return inferred


class BucketingModule(BaseModule):
    """Variable-length training (ref: module/bucketing_module.py): one
    Module per bucket key from ``sym_gen(key) -> (symbol, data_names,
    label_names)``, all bound to the default bucket's parameter tensors
    and sharing one optimizer updater."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, **kwargs):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = _default_contexts(context)
        self._kwargs = kwargs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    def _gen_module(self, bucket_key):
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._sym_gen(bucket_key)
            self._buckets[bucket_key] = Module(
                symbol, data_names, label_names, logger=self.logger,
                context=self._context, **self._kwargs)
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        self._curr_module = self._gen_module(self._default_bucket_key)
        self._curr_bucket_key = self._default_bucket_key
        self._curr_module.bind(data_shapes, label_shapes, for_training,
                               inputs_need_grad, force_rebind)
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        mod = self._gen_module(bucket_key)
        default = self._buckets[self._default_bucket_key]
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     shared_module=default)
            mod.optimizer_initialized = default.optimizer_initialized
            mod._optimizer = default._optimizer
            mod._updater = default._updater
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def init_optimizer(self, *args, **kwargs):
        self._curr_module.init_optimizer(*args, **kwargs)
        self.optimizer_initialized = True
        for mod in self._buckets.values():
            if mod is not self._curr_module and mod.binded:
                mod._optimizer = self._curr_module._optimizer
                mod._updater = self._curr_module._updater
                mod.optimizer_initialized = True

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            if mod.binded:
                mod.install_monitor(mon)

    def forward(self, data_batch, is_train=None):
        if data_batch.bucket_key is not None and \
                data_batch.bucket_key != self._curr_bucket_key:
            self.switch_bucket(data_batch.bucket_key,
                               data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    @property
    def symbol(self):
        return self._curr_module.symbol


class SequentialModule(BaseModule):
    """A chain of modules, each fed the previous one's outputs (ref:
    module/sequential_module.py)."""

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules = []

    def add(self, module, **kwargs):
        self._modules.append(module)
        return self

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        shapes = data_shapes
        for i, mod in enumerate(self._modules):
            last = i == len(self._modules) - 1
            mod.bind(shapes, label_shapes if last else None, for_training,
                     inputs_need_grad=for_training and i > 0)
            if not last:
                out = _out_shape(mod.symbol, dict(_desc(d) for d in shapes))
                shapes = [(self._modules[i + 1].data_names[0], out)]
        self.binded = True
        self.for_training = for_training

    def init_params(self, *args, **kwargs):
        for mod in self._modules:
            mod.init_params(*args, **kwargs)
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        for mod in self._modules:
            mod.init_optimizer(*args, **kwargs)
        self.optimizer_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    @property
    def _execs(self):
        return [e for mod in self._modules for e in mod._execs]

    def forward(self, data_batch, is_train=None):
        from .io import DataBatch
        cur = data_batch
        for mod in self._modules:
            mod.forward(cur, is_train)
            cur = DataBatch(data=mod.get_outputs(), label=data_batch.label)

    def backward(self, out_grads=None):
        """Each module's backward, fed the input gradient of the module
        after it."""
        for i in reversed(range(len(self._modules))):
            mod = self._modules[i]
            mod.backward(out_grads)
            if i:
                e = mod._execs[0]
                out_grads = [e.grad_dict[mod.data_names[0]]]

    def update(self):
        for mod in self._modules:
            mod.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._modules[-1].update_metric(eval_metric, labels)

    @property
    def symbol(self):
        return self._modules[-1].symbol


def _out_shape(symbol, known):
    from .symbol import _propagate_shapes
    _, out = _propagate_shapes(symbol, known)
    if out is None:
        raise MXNetError(f"SequentialModule: cannot infer the output shape "
                         f"of {symbol.name}")
    return out
