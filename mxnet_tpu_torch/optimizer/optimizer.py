"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``; ref:
python/mxnet/optimizer/optimizer.py).

The stateful Optimizer API of the JAX package: a registry, per-parameter
lr/wd multipliers, update counts, an optional ``lr_scheduler``,
multi-precision master weights and the ``Updater`` the Trainer keeps its
states in, over torch tensors updated in place. The math lives in
``ops/optimizer_ops.py``.

``fused_update = True`` marks an optimizer whose ``update()`` is pure
tensor math over (weight, grad, state) and the per-step scalars (lr, wd,
the update count t, rescale_grad), read only through ``_get_lr``,
``_get_wd``, ``_index_update_count`` and ``rescale_grad``. The Trainer
then runs every parameter's update as one program: captured once as a
CUDA graph on the card, with those scalars in device tensors that the
host rewrites before each replay. Every optimizer of the JAX package is
ported, each with its ``fused_update`` flag: LARS (it reads norms on the
host), SGLD (it draws noise) and Nadam (Python state moves each update)
take the per-parameter loop. ``create`` of any other name raises and
lists them.
"""
from __future__ import annotations

import pickle

import numpy as onp
import torch

from ..base import MXNetError
from ..ops import optimizer_ops as O

__all__ = ['Optimizer', 'SGD', 'NAG', 'Adam', 'AdamW', 'LAMB', 'Signum',
           'FTML', 'LARS', 'SGLD', 'AdaGrad', 'RMSProp', 'AdaDelta', 'Ftrl',
           'Adamax', 'Nadam', 'DCASGD', 'Test', 'Updater', 'get_updater',
           'register', 'create']

_REG = {}


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by its (case-insensitive) name; an Optimizer instance
    is returned as it is."""
    if not isinstance(name, str):
        return name
    klass = _REG.get(name.lower())
    if klass is None:
        raise MXNetError(f"optimizer {name!r} is not ported; ported: "
                         f"{sorted(_REG)}")
    return klass(**kwargs)


def _cg(v):
    return -1.0 if v is None else v


def _grad_tensor(grad):
    """(tensor, whether its stype is row_sparse) of a gradient given as a
    tensor or as an NDArray. Lazy semantics apply exactly to row-sparse
    gradients (ref: optimizer.py:526 SGD docstring; FComputeEx dispatch
    on stype), as in the JAX package."""
    from ..ndarray.ndarray import NDArray
    if isinstance(grad, NDArray):
        return grad._data, grad.stype == 'row_sparse'
    return grad, False


def _zeros32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


class Optimizer:
    """Base optimizer: rescale_grad, wd, clip_gradient, the learning rate
    (or an ``lr_scheduler`` of the update count), update counts from
    ``begin_num_update``, lr/wd multipliers (a parameter's own
    ``lr_mult``/``wd_mult`` in ``param_dict``, else ``set_lr_mult`` /
    ``set_wd_mult`` by index or name) and ``multi_precision``, which keeps
    an f32 master copy of every f16/bf16 weight. ``whole_tensor`` marks an
    update that reads a norm of the whole weight (LAMB): the Trainer's
    ZeRO-1 then keeps its states replicated."""

    fused_update = False
    whole_tensor = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}

    create_optimizer = staticmethod(create)

    def create_state(self, index, weight):
        return None

    def _low_precision(self, weight):
        return self.multi_precision and \
            weight.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """(f32 master copy, state) for a low-precision weight under
        ``multi_precision``; else the plain state."""
        if self._low_precision(weight):
            master = weight.detach().to(torch.float32).clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """``grad`` is a tensor, or an NDArray whose stype an optimizer
        with ``lazy_update`` (SGD, Adam) reads: a RowSparseNDArray
        selects the lazy row update (see ``_grad_tensor``)."""
        g, row_sparse = _grad_tensor(grad)
        if self._low_precision(weight):
            master, base_state = state
            g = g.to(torch.float32)
            self.update(index, master, self._tagged(g, row_sparse),
                        base_state)
            weight.copy_(master.to(weight.dtype))
        else:
            self.update(index, weight, self._tagged(g, row_sparse), state)

    def _tagged(self, g, row_sparse):
        """The gradient as ``update`` takes it: a RowSparseNDArray over
        ``g`` for an optimizer that reads the stype, else the tensor."""
        if row_sparse and getattr(self, 'lazy_update', None) is not None:
            from ..ndarray.sparse import RowSparseNDArray
            return RowSparseNDArray(g)
        return g

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """As MXNet: names not ending in ``_weight`` get wd_mult 0, then
        ``args_wd_mult`` overrides."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith('_weight')}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else [index]:
            count = self._index_update_count.get(idx, self.begin_num_update)
            self._index_update_count[idx] = count + 1
            self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, own, table):
        if index in self.param_dict:
            return getattr(self.param_dict[index], own, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lrs(self, indices):
        lr = self.learning_rate
        return [lr * self._mult(i, 'lr_mult', self.lr_mult) for i in indices]

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        return [self.wd * self._mult(i, 'wd_mult', self.wd_mult)
                for i in indices]

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def __getstate__(self):
        # param_dict holds live parameters; the Trainer re-attaches them
        ret = self.__dict__.copy()
        ret['param_dict'] = {}
        return ret

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}


@register
class SGD(Optimizer):
    """SGD with momentum (ref: optimizer.py:526). ``lazy_update`` (on by
    default) applies to a row-sparse gradient (a RowSparseNDArray): only
    its present rows, those with a nonzero, move, weight and momentum;
    a dense gradient updates every row."""
    fused_update = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros32(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        grad, row_sparse = _grad_tensor(grad)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_cg(self.clip_gradient),
                  lazy_update=bool(self.lazy_update and row_sparse))
        if state is not None:
            new_w, new_mom = O.sgd_mom_update(weight, grad, state,
                                              momentum=self.momentum, **kw)
            state.copy_(new_mom)
        else:
            new_w = O.sgd_update(weight, grad, **kw)
        weight.copy_(new_w)


@register
class NAG(Optimizer):
    """Nesterov momentum (plain SGD when momentum is 0)."""
    fused_update = True

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros32(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_cg(self.clip_gradient))
        if state is not None:
            new_w, new_mom = O.nag_mom_update(weight, grad, state,
                                              momentum=self.momentum, **kw)
            state.copy_(new_mom)
        else:
            new_w = O.sgd_update(weight, grad, **kw)
        weight.copy_(new_w)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into lr (ref:
    optimizer.py:1547); wd is added to the gradient. ``lazy_update``, as
    SGD's: on a row-sparse gradient the absent rows keep their weight and
    both moments."""
    fused_update = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        # ** 0.5, not math.sqrt: t may be a device tensor
        lr_t = lr * coef2 ** 0.5 / coef1
        mean, var = state
        grad, row_sparse = _grad_tensor(grad)
        new_w, new_mean, new_var = O.adam_update(
            weight, grad, mean, var, lr=lr_t, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            rescale_grad=self.rescale_grad,
            clip_gradient=_cg(self.clip_gradient),
            lazy_update=bool(self.lazy_update and row_sparse))
        weight.copy_(new_w)
        mean.copy_(new_mean)
        var.copy_(new_var)


@register
class AdamW(Optimizer):
    """Decoupled weight decay Adam (the JAX package's AdamW: no bias
    correction, the decay scaled by lr; ref: src/operator/contrib/
    adamw.cc)."""
    fused_update = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        mean, var = state
        new_w, new_mean, new_var = O.adamw_update(
            weight, grad, mean, var, rescale_grad=self.rescale_grad,
            lr=self._get_lr(index), eta=self.eta, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=self._get_wd(index),
            clip_gradient=_cg(self.clip_gradient))
        weight.copy_(new_w)
        mean.copy_(new_mean)
        var.copy_(new_var)


@register
class LAMB(Optimizer):
    """Layer-wise Adaptive Moments for Batch training (ref:
    optimizer.py:1250): phase 1, the weight's and the update's norms,
    phase 2 with their trust ratio."""
    fused_update = True
    whole_tensor = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        g_update, new_mean, new_var = O.lamb_update_phase1(
            weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, t=t, bias_correction=self.bias_correction,
            wd=wd, rescale_grad=self.rescale_grad,
            clip_gradient=_cg(self.clip_gradient))
        mean.copy_(new_mean)
        var.copy_(new_var)
        r1 = torch.linalg.vector_norm(weight.to(torch.float32))
        r2 = torch.linalg.vector_norm(g_update)
        weight.copy_(O.lamb_update_phase2(
            weight, g_update, r1, r2, lr=lr,
            lower_bound=_cg(self.lower_bound),
            upper_bound=_cg(self.upper_bound)))


@register
class Signum(Optimizer):
    """Signum: the sign of a momentum (signSGD without momentum; ref:
    optimizer.py:672)."""
    fused_update = True

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros32(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_cg(self.clip_gradient))
        if state is not None:
            new_w, new_mom = O.signum_update(weight, grad, state,
                                             momentum=self.momentum,
                                             wd_lh=self.wd_lh, **kw)
            state.copy_(new_mom)
        else:
            new_w = O.signsgd_update(weight, grad, **kw)
        weight.copy_(new_w)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (ref: optimizer.py FTML)."""
    fused_update = True

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        new = O.ftml_update(
            weight, grad, d, v, z, lr=self._get_lr(index), beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            t=self._index_update_count[index], wd=self._get_wd(index),
            rescale_grad=self.rescale_grad, clip_grad=_cg(self.clip_gradient))
        for dst, src in zip((weight, d, v, z), new):
            dst.copy_(src)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (ref: optimizer.py:797): lr scaled
    by eta * |w| / (|g| + wd |w| + epsilon). The norms are read on the
    host, so it takes the per-parameter loop, as in the JAX package."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros32(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w_norm = float(torch.linalg.vector_norm(weight.to(torch.float32)))
        g_norm = float(torch.linalg.vector_norm(
            grad.to(torch.float32) * self.rescale_grad))
        if w_norm > 0 and g_norm > 0:
            lr = lr * self.eta * w_norm / (g_norm + wd * w_norm +
                                           self.epsilon)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=_cg(self.clip_gradient))
        if state is not None:
            new_w, new_mom = O.sgd_mom_update(weight, grad, state,
                                              momentum=self.momentum, **kw)
            state.copy_(new_mom)
        else:
            new_w = O.sgd_update(weight, grad, **kw)
        weight.copy_(new_w)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    Normal(0, sqrt(lr)) noise, drawn from the port's generator on the
    parameter's device (``random.generator``, seeded by ``mx.random.seed``).
    It draws, so it takes the per-parameter loop, as in the JAX package."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        from .. import random as _random
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad.to(torch.float32) * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        noise = torch.randn(weight.shape, dtype=torch.float32,
                            device=weight.device,
                            generator=_random.generator(weight.device))
        w32 = weight.to(torch.float32)
        weight.copy_(w32 - lr / 2 * (g + wd * w32) + noise * lr ** 0.5)


@register
class AdaGrad(Optimizer):
    """AdaGrad (ref: optimizer.py AdaGrad); ``eps`` is its epsilon."""
    fused_update = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros32(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_hist = O.adagrad_update(
            weight, grad, state, lr=self._get_lr(index),
            epsilon=self.float_stable_eps, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=_cg(self.clip_gradient))
        weight.copy_(new_w)
        state.copy_(new_hist)


@register
class RMSProp(Optimizer):
    """RMSProp, plain or ``centered`` (Graves 2013), with an optional
    ``clip_weights`` (ref: optimizer.py RMSProp)."""
    fused_update = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros32(weight), _zeros32(weight), _zeros32(weight))
        return _zeros32(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), gamma1=self.gamma1,
                  epsilon=self.epsilon, wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_cg(self.clip_gradient),
                  clip_weights=_cg(self.clip_weights))
        if not self.centered:
            new_w, new_n = O.rmsprop_update(weight, grad, state, **kw)
            weight.copy_(new_w)
            state.copy_(new_n)
            return
        new = O.rmspropalex_update(weight, grad, *state, gamma2=self.gamma2,
                                   **kw)
        for dst, src in zip((weight,) + tuple(state), new):
            dst.copy_(src)


@register
class AdaDelta(Optimizer):
    """AdaDelta (ref: optimizer.py AdaDelta): no learning rate."""
    fused_update = True

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_delta = state
        new = O.adadelta_update(
            weight, grad, acc_g, acc_delta, rho=self.rho,
            epsilon=self.epsilon, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=_cg(self.clip_gradient))
        for dst, src in zip((weight, acc_g, acc_delta), new):
            dst.copy_(src)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (ref: optimizer.py Ftrl)."""
    fused_update = True

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        new = O.ftrl_update(
            weight, grad, z, n, lr=self._get_lr(index), lamda1=self.lamda1,
            beta=self.beta, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=_cg(self.clip_gradient))
        for dst, src in zip((weight, z, n), new):
            dst.copy_(src)


@register
class Adamax(Optimizer):
    """Adamax, Adam's infinity-norm variant (ref: optimizer.py Adamax)."""
    fused_update = True

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        # not in place: lr may be an entry of the captured update's
        # scalar vector
        lr = self._get_lr(index) / (1. - self.beta1 ** t)
        m, u = state
        g = O._grad_prep(grad, self.rescale_grad, _cg(self.clip_gradient),
                         self._get_wd(index), weight)
        m.copy_(self.beta1 * m + (1. - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
        weight.copy_(weight.to(torch.float32) - lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (ref: optimizer.py Nadam). Its momentum
    schedule is Python state that moves at every update, so it takes the
    per-parameter loop, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        t = self._index_update_count[index]
        g = O._grad_prep(grad, self.rescale_grad, _cg(self.clip_gradient),
                         self._get_wd(index), weight)
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 ** (t *
                                                       self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1. - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        m.copy_(self.beta1 * m + (1. - self.beta1) * g)
        v.copy_(self.beta2 * v + (1. - self.beta2) * g * g)
        grad_prime = g / (1. - self.m_schedule)
        m_t_prime = m / (1. - m_schedule_next)
        v_t_prime = v / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        weight.copy_(weight.to(torch.float32) -
                     lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (ref: optimizer.py DCASGD): the
    state keeps the previous weight."""
    fused_update = True

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        return (None if self.momentum == 0.0 else _zeros32(weight), prev)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad.to(torch.float32) * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        mon, previous_weight = state
        w32 = weight.to(torch.float32)
        delta = -lr * (g + wd * w32 + self.lamda * g * g *
                       (w32 - previous_weight))
        if mon is not None:
            mon.copy_(self.momentum * mon + delta)
            delta = mon
        previous_weight.copy_(weight)
        weight.copy_(w32 + delta)


@register
class Test(Optimizer):
    """The reference's test optimizer: weight += rescale_grad * grad."""
    fused_update = True

    def create_state(self, index, weight):
        return _zeros32(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.copy_(weight + grad * self.rescale_grad)


def _npify(s):
    if isinstance(s, torch.Tensor):
        return s.detach().cpu().numpy()
    if isinstance(s, (list, tuple)):
        return tuple(_npify(x) for x in s)
    return s


def _tensorify(s):
    if isinstance(s, onp.ndarray):
        return torch.from_numpy(onp.array(s))
    if isinstance(s, (list, tuple)):
        return tuple(_tensorify(x) for x in s)
    return s


class Updater:
    """Applies an optimizer to (index, grad, weight) and keeps each
    index's state (ref: optimizer.py:2070). ``get_states`` pickles a dict
    {index: state as numpy arrays}, paired with the optimizer when
    ``dump_optimizer``; ``set_states`` takes either form, its states as
    CPU tensors (the Trainer moves them to the parameters' devices)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
                self.states_synced[i] = True
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def set_states(self, states):
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple) and len(loaded) == 2 and \
                isinstance(loaded[1], Optimizer):
            loaded, self.optimizer = loaded
        self.states = {k: _tensorify(v) for k, v in loaded.items()}
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        states = {k: _npify(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)


def get_updater(optimizer):
    return Updater(optimizer)
