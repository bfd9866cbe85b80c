"""SVRG (Stochastic Variance-Reduced Gradient) training module
(counterpart of ``mxnet_tpu/contrib/svrg_optimization/svrg_module.py``,
ref: python/mxnet/contrib/svrg_optimization/svrg_module.py).

SVRG takes a snapshot w~ of the weights, and the full-dataset gradient
g~ = g(w~), every ``update_freq`` epochs; each minibatch update then uses
the variance-reduced gradient

    g_svrg = g_B(w) - g_B(w~) + g~

(ref: _svrg_grads_update_rule, svrg_module.py:360). As MXNet's module
does, a second Module over the same Symbol (``_mod_aux``, its own
Executors) holds the snapshot weights and computes g_B(w~) and g~; the
combined gradient goes through the Module's own updater. Gradients,
their sums and the combination stay on the Module's device, in float32,
in the JAX module's order of operations.
"""
from __future__ import annotations

import torch

from ...module import Module

__all__ = ['SVRGModule']


def _summed_grads(mod):
    """{parameter name: its gradient summed over ``mod``'s executors}."""
    out = {}
    for name in mod._arg_params:
        grads = [e.grad_dict[name]._data for e in mod._execs
                 if e.grad_dict.get(name) is not None]
        if grads:
            total = grads[0]
            for g in grads[1:]:
                total = total + g.to(total.device)
            out[name] = total
    return out


class SVRGModule(Module):
    """Module with SVRG updates (ref: svrg_module.py:30 SVRGModule).

    ``update_freq``: a new snapshot and full gradient every
    ``update_freq`` epochs (``update_full_grads``, which ``fit`` calls at
    those epochs' starts)."""

    def __init__(self, symbol, data_names=('data',),
                 label_names=('softmax_label',), update_freq=2, **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, **kwargs)
        self.update_freq = update_freq
        self._mod_aux = Module(symbol, data_names=data_names,
                               label_names=label_names, **kwargs)
        self._full_grads = None       # g~ {name: tensor}
        self._staged_special = None   # g_B(w~) of the current batch

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req='write'):
        super().bind(data_shapes, label_shapes, for_training,
                     inputs_need_grad, force_rebind, shared_module, grad_req)
        self._mod_aux.bind(data_shapes, label_shapes, for_training,
                           inputs_need_grad, force_rebind, None, grad_req)

    # -- snapshot ------------------------------------------------------------
    def update_full_grads(self, train_data):
        """Snapshot the weights as w~ and average the gradient over the
        whole dataset there, g~ (ref: svrg_module.py:292)."""
        arg_params, aux_params = self.get_params()
        self._mod_aux.set_params(arg_params, aux_params)
        sums = {k: torch.zeros_like(v._data, dtype=torch.float32)
                for k, v in self._mod_aux._arg_params.items()}
        nbatch = 0
        train_data.reset()
        for batch in train_data:
            self._mod_aux.forward(batch, is_train=True)
            self._mod_aux.backward()
            for name, total in _summed_grads(self._mod_aux).items():
                sums[name] += total
            nbatch += 1
        train_data.reset()
        if nbatch == 0:
            raise ValueError("update_full_grads: empty data iterator")
        self._full_grads = {k: v / nbatch for k, v in sums.items()}

    # -- training step -------------------------------------------------------
    def forward_backward_svrg(self, data_batch):
        """Forward and backward at w~ (the snapshot module) and at w,
        leaving the variance-reduced gradient staged for ``update()``."""
        if self._full_grads is None:
            raise ValueError("call update_full_grads() before SVRG steps")
        self._mod_aux.forward(data_batch, is_train=True)
        self._mod_aux.backward()
        self._staged_special = _summed_grads(self._mod_aux)
        self.forward(data_batch, is_train=True)
        self.backward()

    def update(self):
        """g_B(w) - g_B(w~) + g~ through the updater (ref:
        _svrg_grads_update_rule, svrg_module.py:360); a plain update when
        no SVRG step is staged."""
        if self._full_grads is None or self._staged_special is None:
            super().update()
            return
        current = _summed_grads(self)
        for idx, name in enumerate(self._arg_params):
            if name in self._fixed_param_names or name not in current:
                continue
            g_svrg = current[name] - self._staged_special[name] \
                + self._full_grads[name]
            self._updater(idx, g_svrg, self._arg_params[name]._data)
        self._share_to_execs()
        self._staged_special = None

    # -- fit loop ------------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None,
            kvstore='local', optimizer='sgd',
            optimizer_params=(('learning_rate', 0.01),),
            initializer=None, num_epoch=1, **kwargs):
        """SVRG fit: a snapshot every ``update_freq`` epochs (ref:
        svrg_module.py fit)."""
        from ... import initializer as init_mod
        from ... import metric as metric_mod
        if not self.binded:
            raise ValueError("call bind() before fit()")
        if not self.params_initialized:
            self.init_params(initializer or init_mod.Uniform(0.01))
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if isinstance(eval_metric, str):
            eval_metric = metric_mod.create(eval_metric)
        for epoch in range(num_epoch):
            if epoch % self.update_freq == 0:
                self.update_full_grads(train_data)
            eval_metric.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward_backward_svrg(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    batch_end_callback(type('P', (), {
                        'epoch': epoch, 'nbatch': nbatch,
                        'eval_metric': eval_metric})())
            if epoch_end_callback is not None:
                epoch_end_callback(epoch, self._symbol, *self.get_params())
        return eval_metric
