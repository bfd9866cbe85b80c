"""Optimizer update math (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``).

Plain PyTorch functions over (weight, grad, states) that return the new
values, as the JAX package's pure functions do: the arithmetic runs in
f32, in the JAX functions' order, and the weight comes back in its own
dtype. In the JAX package the whole update is one fused XLA program, not
a Pallas kernel, so there is no hand-written kernel here.

Every per-step scalar (``lr``, ``wd``, ``rescale_grad``, ``t``, the
entries of ``lrs``/``wds``) may be a Python number or a 0-d tensor on the
weight's device. A tensor is what a captured CUDA graph needs: the host
writes the step's value into it before each replay, and nothing here
reads it back. Where the JAX function branches on a scalar (``if wd``),
a tensor takes the branch that adds its term, as the JAX package's
``preloaded_*`` functions do for device scalars. ``clip_gradient``,
``lower_bound`` and ``upper_bound`` are settings and stay Python numbers.

Each is also a registered op under the JAX name, with ``mutate_inputs``
naming the inputs its outputs replace (slot 0, the weight, is written
only through ``out=``), so ``nd.adamw_update(w, g, m, v, out=w)`` updates
``w``, ``m`` and ``v`` in place as MXNet's does (``ndarray/register.py``).
"""
from __future__ import annotations

import torch

from ..base import register_op

__all__ = ['sgd_update', 'sgd_mom_update', 'mp_sgd_update',
           'mp_sgd_mom_update', 'nag_mom_update', 'adam_update',
           'adamw_update', 'ftrl_update', 'rmsprop_update',
           'rmspropalex_update', 'signsgd_update', 'signum_update',
           'adagrad_update', 'adadelta_update', 'ftml_update',
           'lamb_update_phase1', 'lamb_update_phase2', 'multi_sum_sq',
           'all_finite', 'multi_sgd_update',
           'multi_sgd_mom_update', 'multi_mp_sgd_update',
           'multi_mp_sgd_mom_update', 'preloaded_multi_sgd_update',
           'preloaded_multi_sgd_mom_update', 'preloaded_multi_mp_sgd_update',
           'preloaded_multi_mp_sgd_mom_update', 'multi_lamb_update',
           'multi_lans_update', 'multi_adamw_update']


def _on(v):
    """Whether an optional term is added: always for a tensor (its value
    is not read on the host), else when the number is nonzero."""
    return isinstance(v, torch.Tensor) or bool(v)


def _grad_prep(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """f32 cast, then ``rescale_grad``, then the clip when it is > 0, then
    ``wd * weight`` when a weight is given and wd is on."""
    g = grad.to(torch.float32) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if weight is not None and _on(wd):
        g = g + wd * weight.to(torch.float32)
    return g


def _row_mask(grad):
    """The rows of a row-sparse gradient that are present (any nonzero)."""
    if grad.dim() <= 1:
        return grad != 0
    present = (grad != 0).flatten(1).any(dim=1)
    return present.reshape((-1,) + (1,) * (grad.dim() - 1))


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False):
    """``lazy_update``: only rows with a present (nonzero) gradient move."""
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_w = (weight.to(torch.float32) - lr * g).to(weight.dtype)
    if lazy_update:
        new_w = torch.where(_row_mask(grad), new_w, weight)
    return new_w


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    new_w = (weight.to(torch.float32) + new_mom).to(weight.dtype)
    if lazy_update:
        mask = _row_mask(grad)
        new_w = torch.where(mask, new_w, weight)
        new_mom = torch.where(mask, new_mom, mom)
    return new_w, new_mom


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight32)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight32)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom + g
    new_w = weight.to(torch.float32) - lr * (g + momentum * new_mom)
    return new_w.to(weight.dtype), new_mom


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False):
    """Adam without bias correction (the optimizer class folds it into
    lr), wd added to the gradient."""
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight.to(torch.float32) - \
        lr * new_mean / (torch.sqrt(new_var) + epsilon)
    new_w = new_w.to(weight.dtype)
    if lazy_update:
        mask = _row_mask(grad)
        new_w = torch.where(mask, new_w, weight)
        new_mean = torch.where(mask, new_mean, mean)
        new_var = torch.where(mask, new_var, var)
    return new_w, new_mean, new_var


def adamw_update(weight, grad, mean, var, rescale_grad=1.0, lr=0.001,
                 eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay Adam with no bias correction, the decay scaled
    by lr: returns (new weight in weight's dtype, new mean, new var)."""
    g = _grad_prep(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w32 = weight.to(torch.float32)
    new_w = w32 - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                         + wd * lr * w32)
    return new_w.to(weight.dtype), new_mean, new_var


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return w.clamp(-clip_weights, clip_weights)
    return w


def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal: (new weight, new z, new n)."""
    g = _grad_prep(grad, rescale_grad, clip_gradient)
    w32 = weight.to(torch.float32)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * w32
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(new_z),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w.to(weight.dtype), new_z, new_n


def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight.to(torch.float32) - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_w, clip_weights).to(weight.dtype), new_n


def rmspropalex_update(weight, grad, n, g_acc, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013): (new weight, n, g, delta)."""
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_acc
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight.to(torch.float32) + new_delta
    return (_clip_weights(new_w, clip_weights).to(weight.dtype), new_n,
            new_g, new_delta)


def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient)
    w32 = weight.to(torch.float32)
    return (w32 - lr * (torch.sign(g) + wd * w32)).to(weight.dtype)


def signum_update(weight, grad, mom, lr=0.01, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - (1 - momentum) * g
    w32 = weight.to(torch.float32)
    new_w = (1 - lr * wd_lh) * w32 + lr * torch.sign(new_mom)
    return new_w.to(weight.dtype), new_mom


def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_hist = history + torch.square(g)
    new_w = weight.to(torch.float32) - \
        lr * g / (torch.sqrt(new_hist) + epsilon)
    return new_w.to(weight.dtype), new_hist


def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / \
        torch.sqrt(new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    new_w = weight.to(torch.float32) - delta
    return new_w.to(weight.dtype), new_acc_g, new_acc_delta


def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """Follow the Moving Leader: (new weight, d, v, z)."""
    g = _grad_prep(grad, rescale_grad, clip_grad, wd, weight)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * \
        (torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight.to(torch.float32)
    new_w = -new_z / d_t
    return new_w.to(weight.dtype), d_t, new_v, new_z


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's direction: (update, new mean, new var), all f32."""
    g = _grad_prep(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m_hat, v_hat = new_mean, new_var
    if bias_correction:
        m_hat = new_mean / (1 - beta1 ** t)
        v_hat = new_var / (1 - beta2 ** t)
    w32 = weight.to(torch.float32)
    update = m_hat / (torch.sqrt(v_hat) + epsilon) + wd * w32
    return update, new_mean, new_var


def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB's step: the trust ratio r1/r2 (r1 clipped to the bounds that
    are > 0; 1 where either norm is 0) times lr times the update."""
    r1v, r2v = torch.as_tensor(r1), torch.as_tensor(r2)
    if lower_bound is not None and lower_bound > 0:
        r1v = r1v.clamp_min(lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1v = r1v.clamp_max(upper_bound)
    ratio = torch.where((r1v > 0) & (r2v > 0), r1v / r2v,
                        torch.ones_like(r1v))
    new_w = weight.to(torch.float32) - lr * ratio * g_update
    return new_w.to(weight.dtype)


def multi_sum_sq(*arrays):
    """Per-array sum of squares in f32, as 0-d tensors."""
    return tuple(torch.sum(torch.square(a.to(torch.float32)))
                 for a in arrays)


def all_finite(*arrays):
    """1.0 (f32, 0-d) if every element of every array is finite, else 0."""
    ok = torch.ones((), dtype=torch.bool,
                    device=arrays[0].device if arrays else None)
    for a in arrays:
        ok = ok & torch.isfinite(a.to(torch.float32)).all()
    return ok.to(torch.float32)


# multi-tensor updates: one call over N tensors, each entry of lrs/wds
# that tensor's scalar (ref: src/operator/optimizer_op.cc multi_sgd_update;
# contrib/preloaded_multi_sgd.cc; contrib/multi_lamb.cc; contrib/adamw.cc).

def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0):
    weights, grads = _as_list(weights), _as_list(grads)
    return [sgd_update(w, g, lr=lr, wd=wd, rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient)
            for w, g, lr, wd in zip(weights, grads, lrs, wds)]


def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    weights, grads, moms = _as_list(weights), _as_list(grads), _as_list(moms)
    outs = [sgd_mom_update(w, g, m, lr=lr, momentum=momentum, wd=wd,
                           rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient)
            for w, g, m, lr, wd in zip(weights, grads, moms, lrs, wds)]
    return [o[0] for o in outs], [o[1] for o in outs]


def multi_mp_sgd_update(weights, grads, weights32, lrs, wds,
                        rescale_grad=1.0, clip_gradient=-1.0):
    weights, grads = _as_list(weights), _as_list(grads)
    outs = [mp_sgd_update(w, g, w32, lr=lr, wd=wd, rescale_grad=rescale_grad,
                          clip_gradient=clip_gradient)
            for w, g, w32, lr, wd in zip(weights, grads, _as_list(weights32),
                                         lrs, wds)]
    return [o[0] for o in outs], [o[1] for o in outs]


def multi_mp_sgd_mom_update(weights, grads, moms, weights32, lrs, wds,
                            momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0):
    weights, grads = _as_list(weights), _as_list(grads)
    outs = [mp_sgd_mom_update(w, g, m, w32, lr=lr, momentum=momentum, wd=wd,
                              rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)
            for w, g, m, w32, lr, wd in zip(weights, grads, _as_list(moms),
                                            _as_list(weights32), lrs, wds)]
    return ([o[0] for o in outs], [o[1] for o in outs],
            [o[2] for o in outs])


def _grad_prep_preloaded(grad, rescale_grad, clip_gradient, wd, weight):
    """``_grad_prep`` with the weight-decay term always added: lrs and wds
    arrive as device tensors (ref: contrib/preloaded_multi_sgd.cc)."""
    g = grad.to(torch.float32) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight.to(torch.float32)


def preloaded_multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """multi_sgd_update with lrs/wds as device tensors (indexable, one
    entry per weight)."""
    new_w = []
    for i, (w, g) in enumerate(zip(_as_list(weights), _as_list(grads))):
        g32 = _grad_prep_preloaded(g, rescale_grad, clip_gradient, wds[i], w)
        new_w.append((w.to(torch.float32) - lrs[i] * g32).to(w.dtype))
    return new_w


def preloaded_multi_sgd_mom_update(weights, grads, moms, lrs, wds,
                                   momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0):
    new_w, new_m = [], []
    for i, (w, g, m) in enumerate(zip(_as_list(weights), _as_list(grads),
                                      _as_list(moms))):
        g32 = _grad_prep_preloaded(g, rescale_grad, clip_gradient, wds[i], w)
        nm = momentum * m - lrs[i] * g32
        new_m.append(nm)
        new_w.append((w.to(torch.float32) + nm).to(w.dtype))
    return new_w, new_m


def preloaded_multi_mp_sgd_update(weights, grads, weights32, lrs, wds,
                                  rescale_grad=1.0, clip_gradient=-1.0):
    new_w, new_w32 = [], []
    for i, (w, g, w32) in enumerate(zip(_as_list(weights), _as_list(grads),
                                        _as_list(weights32))):
        g32 = _grad_prep_preloaded(g, rescale_grad, clip_gradient, wds[i],
                                   w32)
        nw32 = w32 - lrs[i] * g32
        new_w32.append(nw32)
        new_w.append(nw32.to(w.dtype))
    return new_w, new_w32


def preloaded_multi_mp_sgd_mom_update(weights, grads, moms, weights32,
                                      lrs, wds, momentum=0.0,
                                      rescale_grad=1.0,
                                      clip_gradient=-1.0):
    new_w, new_m, new_w32 = [], [], []
    for i, (w, g, m, w32) in enumerate(zip(_as_list(weights),
                                           _as_list(grads), _as_list(moms),
                                           _as_list(weights32))):
        g32 = _grad_prep_preloaded(g, rescale_grad, clip_gradient, wds[i],
                                   w32)
        nm = momentum * m - lrs[i] * g32
        nw32 = w32 + nm
        new_m.append(nm)
        new_w32.append(nw32)
        new_w.append(nw32.to(w.dtype))
    return new_w, new_m, new_w32


def _lamb_one(w, g, m, v, lr, wd, beta1, beta2, epsilon, t, bias_correction,
              rescale_grad, clip_gradient, lower_bound, upper_bound):
    """One tensor of multi_lamb_update: phase 1, the two norms, phase 2."""
    update, m_new, v_new = lamb_update_phase1(
        w, g, m, v, beta1=beta1, beta2=beta2, epsilon=epsilon, t=t,
        bias_correction=bias_correction, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient)
    r1 = torch.linalg.vector_norm(w.to(torch.float32))
    r2 = torch.linalg.vector_norm(update)
    new_w = lamb_update_phase2(w, update, r1, r2, lr=lr,
                               lower_bound=lower_bound,
                               upper_bound=upper_bound)
    return new_w, m_new, v_new


def multi_lamb_update(weights, grads, means, vars_, lrs, wds, step_count,
                      beta1=0.9, beta2=0.999, epsilon=1e-6,
                      bias_correction=True, rescale_grad=1.0,
                      clip_gradient=-1.0, lower_bound=-1.0,
                      upper_bound=-1.0):
    """LAMB over N tensors; ``step_count`` holds each tensor's t."""
    outs = [_lamb_one(w, g, m, v, lrs[i], wds[i], beta1, beta2, epsilon,
                      step_count[i], bias_correction, rescale_grad,
                      clip_gradient, lower_bound, upper_bound)
            for i, (w, g, m, v) in enumerate(zip(
                _as_list(weights), _as_list(grads), _as_list(means),
                _as_list(vars_)))]
    return ([o[0] for o in outs], [o[1] for o in outs],
            [o[2] for o in outs])


def _lans_one(w, g, m, v, lr, wd, beta1, beta2, epsilon, t,
              rescale_grad, clip_gradient):
    """One tensor of multi_lans_update: the gradient normalised by its
    norm, Adam's moments with bias correction, and two trust ratios, one
    for the momentum term and one for the gradient term."""
    g32 = _grad_prep(g, rescale_grad, clip_gradient)
    g32 = g32 / torch.linalg.vector_norm(g32).clamp_min(1e-12)
    w32 = w.to(torch.float32)
    m_new = beta1 * m + (1 - beta1) * g32
    v_new = beta2 * v + (1 - beta2) * torch.square(g32)
    mhat = m_new / (1 - beta1 ** t)
    vhat = v_new / (1 - beta2 ** t)
    r1 = torch.linalg.vector_norm(w32)
    upd_m = mhat / (torch.sqrt(vhat) + epsilon) + wd * w32
    upd_g = g32 / (torch.sqrt(vhat) + epsilon) + wd * w32
    rm = torch.linalg.vector_norm(upd_m)
    rg = torch.linalg.vector_norm(upd_g)
    one = torch.ones_like(r1)
    ratio_m = torch.where((r1 > 0) & (rm > 0), r1 / rm, one)
    ratio_g = torch.where((r1 > 0) & (rg > 0), r1 / rg, one)
    new_w = (w32 - lr * (beta1 * ratio_m * upd_m
                         + (1 - beta1) * ratio_g * upd_g)).to(w.dtype)
    return new_w, m_new, v_new


def multi_lans_update(weights, grads, means, vars_, lrs, wds, step_count,
                      beta1=0.9, beta2=0.999, epsilon=1e-6,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """LANS over N tensors (ref: contrib/multi_lans.cc); ``step_count``
    holds each tensor's t."""
    outs = [_lans_one(w, g, m, v, lrs[i], wds[i], beta1, beta2, epsilon,
                      step_count[i], rescale_grad, clip_gradient)
            for i, (w, g, m, v) in enumerate(zip(
                _as_list(weights), _as_list(grads), _as_list(means),
                _as_list(vars_)))]
    return ([o[0] for o in outs], [o[1] for o in outs],
            [o[2] for o in outs])


def multi_adamw_update(weights, grads, means, vars_, rescale_grad, lrs,
                       etas, wds, beta1=0.9, beta2=0.999, epsilon=1e-8,
                       clip_gradient=-1.0):
    """AdamW over N tensors. ``rescale_grad`` is a tensor; where it is not
    finite every weight and state keeps its value (the dynamic loss
    scale's overflow protocol), decided on the device."""
    scale = torch.as_tensor(rescale_grad, dtype=torch.float32).reshape(())
    ok = torch.isfinite(scale)
    safe = torch.where(ok, scale, torch.zeros_like(scale))
    new_ws, new_ms, new_vs = [], [], []
    for i, (w, g, m, v) in enumerate(zip(_as_list(weights), _as_list(grads),
                                         _as_list(means), _as_list(vars_))):
        g32 = g.to(torch.float32) * safe
        if clip_gradient is not None and clip_gradient > 0:
            g32 = g32.clamp(-clip_gradient, clip_gradient)
        m_new = beta1 * m + (1 - beta1) * g32
        v_new = beta2 * v + (1 - beta2) * torch.square(g32)
        w32 = w.to(torch.float32)
        upd = lrs[i] * (etas[i] * m_new / (torch.sqrt(v_new) + epsilon)
                        + wds[i] * w32)
        new_w = (w32 - upd).to(w.dtype)
        new_ws.append(torch.where(ok, new_w, w))
        new_ms.append(torch.where(ok, m_new, m))
        new_vs.append(torch.where(ok, v_new, v))
    return new_ws, new_ms, new_vs


# output j of each update replaces input _MUTATES[name][j] (0: the weight,
# through out=); the multi-tensor forms take and return lists
_MUTATES = {
    'sgd_update': (0,), 'sgd_mom_update': (0, 2), 'mp_sgd_update': (0, 2),
    'mp_sgd_mom_update': (0, 2, 3), 'nag_mom_update': (0, 2),
    'adam_update': (0, 2, 3), 'adamw_update': (0, 2, 3),
    'ftrl_update': (0, 2, 3), 'rmsprop_update': (0, 2),
    'rmspropalex_update': (0, 2, 3, 4), 'signsgd_update': (0,),
    'signum_update': (0, 2), 'adagrad_update': (0, 2),
    'adadelta_update': (0, 2, 3), 'ftml_update': (0, 2, 3, 4),
    'lamb_update_phase1': (0, 2, 3), 'lamb_update_phase2': (0,),
    'multi_sum_sq': (), 'all_finite': (),
    'multi_sgd_update': (0,), 'multi_sgd_mom_update': (0, 2),
    'multi_mp_sgd_update': (0, 2), 'multi_mp_sgd_mom_update': (0, 2, 3),
    'preloaded_multi_sgd_update': (0,),
    'preloaded_multi_sgd_mom_update': (0, 2),
    'preloaded_multi_mp_sgd_update': (0, 2),
    'preloaded_multi_mp_sgd_mom_update': (0, 2, 3),
    'multi_lamb_update': (0, 2, 3), 'multi_lans_update': (0, 2, 3),
    'multi_adamw_update': (0, 2, 3),
}
for _name in __all__:
    register_op(_name, mutate_inputs=_MUTATES[_name])(globals()[_name])
