"""The port's AdamW (ops/optimizer_ops.py and optimizer/optimizer.py)
against the JAX package's ``adamw_update`` and its AdamW optimizer class,
on the same numpy weights and gradients over a few iterations."""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import optimizer_ops as tops

RTOL, ATOL = 1e-6, 1e-7     # one f32 update: rounding order only


def _problem(seed, shape=(5, 7), steps=4):
    rng = onp.random.RandomState(seed)
    w0 = rng.randn(*shape).astype(onp.float32)
    grads = [rng.randn(*shape).astype(onp.float32) * 3 for _ in range(steps)]
    return w0, grads


@pytest.mark.parametrize('kw', [
    dict(lr=1e-2, wd=0.01),
    dict(lr=1e-3, wd=0.1, rescale_grad=0.25, clip_gradient=0.5),
    dict(lr=5e-3, wd=0.0, beta1=0.8, beta2=0.95, epsilon=1e-6, eta=0.5),
])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_adamw_update_matches_jax(kw, dtype):
    w0, grads = _problem(0)
    jw = jnp.asarray(w0).astype(dtype)
    jm = jv = jnp.zeros(w0.shape, jnp.float32)
    tw = torch.from_numpy(w0).to(getattr(torch, dtype))
    tm = tv = torch.zeros(w0.shape)
    for g in grads:
        jw, jm, jv = jops.adamw_update(jw, jnp.asarray(g).astype(dtype), jm,
                                       jv, **kw)
        tw, tm, tv = tops.adamw_update(
            tw, torch.from_numpy(g).to(getattr(torch, dtype)), tm, tv, **kw)
        assert tw.dtype == getattr(torch, dtype) and tm.dtype == torch.float32
    onp.testing.assert_allclose(tm.numpy(), onp.asarray(jm), rtol=RTOL,
                                atol=ATOL)
    onp.testing.assert_allclose(tv.numpy(), onp.asarray(jv), rtol=RTOL,
                                atol=ATOL)
    if dtype == 'float32':
        onp.testing.assert_allclose(tw.numpy(), onp.asarray(jw), rtol=RTOL,
                                    atol=ATOL)
    else:
        # the f32 results round to bf16 the same way, or one ulp apart
        onp.testing.assert_allclose(tw.float().numpy(),
                                    onp.asarray(jw.astype(jnp.float32)),
                                    rtol=2 ** -7, atol=0)


@pytest.mark.parametrize('multi_precision', [False, True])
def test_adamw_class_matches_jax_class(multi_precision):
    """create('adamw') with bf16 weights: with multi_precision an f32
    master copy carries the trajectory and the bf16 weight is its cast;
    without it the bf16 weight is updated directly (f32 states)."""
    w0, grads = _problem(1, steps=5)
    kw = dict(learning_rate=1e-2, wd=0.01, rescale_grad=0.5,
              multi_precision=multi_precision)
    jo = jopt.create('adamw', **kw)
    jw = nd.array(w0).astype('bfloat16')
    jstate = jo.create_state_multi_precision(0, jw)
    to = topt.create('AdamW', **kw)
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    tstate = to.create_state_multi_precision(0, tw)
    for g in grads:
        jo.update_multi_precision(0, jw, nd.array(g).astype('bfloat16'),
                                  jstate)
        to.update_multi_precision(0, tw, torch.from_numpy(g).to(
            torch.bfloat16), tstate)
    assert to.num_update == jo.num_update == len(grads)
    if multi_precision:
        jmaster, (jm, jv) = jstate
        tmaster, (tm, tv) = tstate
        assert tmaster.dtype == torch.float32
        onp.testing.assert_allclose(tmaster.numpy(), jmaster.asnumpy(),
                                    rtol=1e-6, atol=1e-7)
        onp.testing.assert_array_equal(
            tw.float().numpy(), jw.astype('float32').asnumpy())
    else:
        (jm, jv), (tm, tv) = jstate, tstate
        onp.testing.assert_allclose(tw.float().numpy(),
                                    jw.astype('float32').asnumpy(),
                                    rtol=2 ** -7, atol=0)
    onp.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=1e-5,
                                atol=1e-7)
    onp.testing.assert_allclose(tv.numpy(), jv.asnumpy(), rtol=1e-5,
                                atol=1e-7)


def test_lr_and_wd_multipliers_come_from_the_parameter():
    p = torch.nn.Parameter(torch.zeros(3))
    p.lr_mult, p.wd_mult = 0.5, 0.0
    o = topt.create('adamw', learning_rate=0.1, wd=0.2, param_dict={0: p})
    assert o._get_lr(0) == pytest.approx(0.05) and o._get_wd(0) == 0.0
    assert o._get_lr(1) == pytest.approx(0.1) and o._get_wd(1) == 0.2
    o.set_learning_rate(0.3)
    assert o.learning_rate == 0.3


def test_create_refuses_what_is_not_ported():
    assert isinstance(topt.create('adamw'), topt.AdamW)
    with pytest.raises(MXNetError, match=r"'sgd' is not ported.*adamw"):
        topt.create('sgd')
    with pytest.raises(MXNetError, match='lr_scheduler'):
        topt.create('adamw', lr_scheduler=object())


@pytest.mark.parametrize('call', ['step', 'update'])
def test_ignore_stale_grad_is_accepted_and_changes_nothing(call):
    """``trainer.step(bs, ignore_stale_grad=True)`` (an MXNet script's
    call) gives the update a call without it gives, for a parameter with
    a gradient and for one whose gradient the loss never reached (updated
    from a zeroed buffer, as the JAX Trainer's)."""
    from mxnet_tpu_torch import gluon
    rng = onp.random.RandomState(3)
    w0, g0, s0 = (rng.randn(4, 3).astype(onp.float32) for _ in range(3))
    results = []
    for flag in (False, True):
        used = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        stale = torch.nn.Parameter(torch.from_numpy(s0.copy()))
        used.grad = torch.from_numpy(g0.copy())
        trainer = gluon.Trainer([used, stale], 'adamw',
                                {'learning_rate': 0.1, 'wd': 0.01})
        kwargs = {'ignore_stale_grad': True} if flag else {}
        for _ in range(2):
            getattr(trainer, call)(2, **kwargs)
        results.append((used.detach().clone(), stale.detach().clone()))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(results[0][1], torch.from_numpy(s0))
