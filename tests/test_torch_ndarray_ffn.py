"""The NDArray slice end to end at a small size: the FFN block
y = dot(gelu(dot(x, w1) + b1), w2) + b2 with loss mean((y - t)^2),
trained by SGD written in NDArrays (``p[:] = p - lr * p.grad``), its GELU
an ``autograd.Function``.

The port runs on the CPU with the plain GELU Function; the JAX package
runs the same program with its GELU forward and backward as
``mx.rtc.pallas_op`` kernels (interpret mode) inside
``mxnet_tpu.autograd.Function``, the counterpart of the card's NVRTC
kernels. Same numpy inputs (16 rows, hidden 32, FFN 64, f32).

Tolerance: rtol 1e-5 on the losses, rtol 1e-4 / atol 1e-6 on the first
step's gradients and on the parameters after 3 steps (f32 products
summed in another order).
"""
import math

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.test_utils import PlainGelu, ffn_arrays, ffn_sgd
from test_torch_jax_globals import jax_globals  # noqa: F401

ROWS, HIDDEN, FFN, LR, STEPS = 16, 32, 64, 0.5, 3


def _jax_pallas_gelu():
    """GELU forward and backward as user Pallas kernels."""
    from jax.scipy.special import erf
    import jax.numpy as jnp

    def fwd_kernel(x_ref, o_ref):
        x = x_ref[...]
        o_ref[...] = 0.5 * x * (1.0 + erf(x * (1.0 / math.sqrt(2.0))))

    def bwd_kernel(x_ref, dy_ref, o_ref):
        x = x_ref[...]
        cdf = 0.5 * (1.0 + erf(x * (1.0 / math.sqrt(2.0))))
        pdf = jnp.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
        o_ref[...] = dy_ref[...] * (cdf + x * pdf)

    fwd = mj.rtc.pallas_op(fwd_kernel, out_like=0, interpret=True)
    bwd = mj.rtc.pallas_op(bwd_kernel, out_like=0, interpret=True)

    class Gelu(mj.autograd.Function):
        def forward(self, h):
            self.h = h
            return fwd(h)

        def backward(self, dy):
            return bwd(self.h, dy)

    return Gelu


@pytest.fixture(scope='module')
def runs():
    x, t, params = ffn_arrays(ROWS, HIDDEN, FFN, seed=5)
    want = ffn_sgd(mj, mj.cpu(), x, t, params, _jax_pallas_gelu(), STEPS, LR)
    got = ffn_sgd(mt, mt.cpu(), x, t, params, PlainGelu, STEPS, LR)
    return got, want


def test_losses_match_and_fall(runs):
    (got, _, _), (want, _, _) = runs
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


@pytest.mark.parametrize('i,name', enumerate(['w1', 'b1', 'w2', 'b2']))
def test_first_step_gradients_match(runs, i, name):
    (_, got, _), (_, want, _) = runs
    assert got[i].shape == want[i].shape and got[i].dtype == onp.float32
    onp.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-6,
                                err_msg=name)
    assert onp.abs(want[i]).max() > 0


@pytest.mark.parametrize('i,name', enumerate(['w1', 'b1', 'w2', 'b2']))
def test_parameters_after_three_steps_match(runs, i, name):
    (_, _, got), (_, _, want) = runs
    onp.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-6,
                                err_msg=name)


def test_plain_gelu_function_matches_registered_gelu_gradient():
    """The plain Function's backward against autograd through nd.gelu."""
    x = onp.random.RandomState(0).randn(5, 7).astype('f')
    grads = []
    for fn in (lambda h: PlainGelu()(h), mt.nd.gelu):
        h = mt.nd.array(x, ctx=mt.cpu())
        h.attach_grad()
        with mt.autograd.record():
            y = (fn(h) * 3).sum()
        y.backward()
        grads.append(h.grad.asnumpy())
    onp.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-6)
