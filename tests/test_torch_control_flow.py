"""The port's control-flow operators (``mxnet_tpu_torch.ops.control_flow``
as ``nd.contrib.foreach``/``while_loop``/``cond``) against the JAX
package's, on the CPU.

Every eager case of tests/test_control_flow.py runs through both
packages with the same code (the ``P`` fixture; the port inside ``with
mx.cpu():``), with its gradients under ``autograd.record``. The JAX
package's traced forms (under ``jax.jit``) have their port counterpart in
the same calls on tensors inside a ``hybrid_forward``, held against the
eager NDArray calls.

Tolerance: f32, rtol 1e-6 (the bodies are a few elementwise ops).
"""
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _pkg(mx):
    return types.SimpleNamespace(mx=mx, nd=mx.nd, autograd=mx.autograd,
                                 gluon=mx.gluon, port=mx is mt)


@pytest.fixture(params=['jax', 'port'])
def P(request):
    return _pkg(mj if request.param == 'jax' else mt)


def test_foreach_cumsum(P):
    nd = P.nd
    data = nd.array(onp.arange(12, dtype=onp.float32).reshape(4, 3))

    def body(x, s):
        out = x + s
        return out, out

    outs, final = nd.contrib.foreach(body, data, nd.zeros((3,)))
    expect = onp.cumsum(onp.arange(12).reshape(4, 3), axis=0)
    onp.testing.assert_allclose(outs.asnumpy(), expect, rtol=1e-6)
    onp.testing.assert_allclose(final.asnumpy(), expect[-1], rtol=1e-6)


def test_foreach_multi_state_grad(P):
    nd = P.nd
    d = onp.random.RandomState(0).rand(5, 2).astype(onp.float32)
    data = nd.array(d)
    data.attach_grad()

    def body(x, s):
        new_s = s * x
        return new_s, new_s

    with P.autograd.record():
        outs, final = nd.contrib.foreach(body, data, nd.ones((2,)))
        loss = outs.sum() + final.sum()
    loss.backward()
    # d/dx of sum_t prod_{u<=t} x_u + prod_u x_u, per column
    want = onp.zeros_like(d)
    for i in range(5):
        for j in range(2):
            want[i, j] = sum(onp.prod(d[:t + 1, j]) / d[i, j]
                             for t in range(i, 5)) + \
                onp.prod(d[:, j]) / d[i, j]
    onp.testing.assert_allclose(data.grad.asnumpy(), want, rtol=1e-5)


def test_foreach_nested_lists(P):
    """data and states as lists: body(x_list, states) over both."""
    nd = P.nd
    a = nd.array(onp.ones((3, 2), 'f'))
    b = nd.array(onp.full((3, 2), 2.0, 'f'))

    def body(xs, states):
        x0, x1 = xs
        s0, s1 = states
        return [x0 + s0, x1 * s1], [s0 + x0, s1 * x1]

    (o0, o1), (f0, f1) = nd.contrib.foreach(body, [a, b],
                                            [nd.zeros((2,)), nd.ones((2,))])
    onp.testing.assert_allclose(o0.asnumpy()[:, 0], [1, 2, 3])
    onp.testing.assert_allclose(o1.asnumpy()[:, 0], [2, 4, 8])
    onp.testing.assert_allclose(f1.asnumpy(), [8, 8])


def test_while_loop_eager(P):
    nd = P.nd

    def cond(lv):
        i, _ = lv
        return i < 5

    def func(lv):
        i, total = lv
        return total + i, (i + 1, total + i)

    outs, (i, total) = nd.contrib.while_loop(
        cond, func, (nd.array([0.0]), nd.array([0.0])), max_iterations=10)
    assert int(i.asnumpy()[0]) == 5
    assert float(total.asnumpy()[0]) == 0 + 1 + 2 + 3 + 4
    assert outs.shape[0] == 10
    onp.testing.assert_allclose(outs.asnumpy()[5:], 0.0)


def test_while_loop_eager_grad(P):
    nd = P.nd
    x = nd.array([2.0])
    x.attach_grad()

    def cond(lv):
        i, _ = lv
        return i < 3

    def func(lv):
        i, acc = lv
        return acc * x, (i + 1, acc * x)

    with P.autograd.record():
        outs, (_, acc) = nd.contrib.while_loop(
            cond, func, (nd.array([0.0]), nd.ones((1,))))
        loss = acc.sum()
    loss.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [12.0], rtol=1e-5)


def test_while_loop_without_iterations_returns_no_outputs(P):
    nd = P.nd
    outs, (i,) = nd.contrib.while_loop(lambda lv: lv[0] < 0,
                                       lambda lv: (lv[0], (lv[0] + 1,)),
                                       (nd.array([3.0]),))
    assert outs == [] and float(i.asnumpy()[0]) == 3.0


def test_foreach_closure_param_grad(P):
    nd = P.nd
    w = nd.array([2.0, 3.0])
    w.attach_grad()
    data = nd.array(onp.ones((3, 2), onp.float32))

    def body(x, s):
        out = x * w + s
        return out, out

    with P.autograd.record():
        outs, final = nd.contrib.foreach(body, data, nd.zeros((2,)))
        loss = final.sum()
    loss.backward()
    onp.testing.assert_allclose(w.grad.asnumpy(), [3.0, 3.0], rtol=1e-6)


def test_cond_eager_and_grad(P):
    nd = P.nd
    x = nd.array([3.0])
    x.attach_grad()
    with P.autograd.record():
        out = nd.contrib.cond(x.sum() > 0, lambda: x * 2, lambda: x * 5)
        out.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [2.0])
    y = nd.array([-1.0])
    out = nd.contrib.cond(y.sum() > 0, lambda: y * 2, lambda: y * 5)
    onp.testing.assert_allclose(out.asnumpy(), [-5.0])


def test_cond_with_inputs(P):
    nd = P.nd
    a = nd.array([3.0])
    for pred, want in ((True, 6.0), (False, 103.0)):
        out = nd.contrib.cond(nd.array([float(pred)]),
                              lambda t: t[0] * 2, lambda t: t[0] + 100,
                              inputs=[a])
        onp.testing.assert_allclose(out.asnumpy(), [want])


def test_foreach_in_hybrid_block(P):
    """foreach inside a hybrid_forward (tensors in the port), hybridized."""
    nd = P.nd

    class Cum(P.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            outs, _ = nd.contrib.foreach(
                lambda xi, s: (xi + s, xi + s), x, nd.zeros_like(x[0]))
            return outs

    net = Cum()
    net.hybridize()
    x = nd.array(onp.arange(6, dtype=onp.float32).reshape(3, 2))
    expect = onp.cumsum(onp.arange(6).reshape(3, 2), axis=0)
    onp.testing.assert_allclose(net(x).asnumpy(), expect, rtol=1e-6)


def test_loops_on_tensors_match_the_ndarray_calls():
    """The port's counterpart of tests/test_control_flow.py's traced
    cases: while_loop and cond on tensors (a hybrid_forward's arguments),
    with gradients through torch.autograd, against the NDArray calls."""
    cf = mt.ops.control_flow

    def cond(lv):
        return lv[0] < 4

    def func(lv):
        i, s = lv
        return s + i, (i + 1, s + i)
    outs_e, (ie, se) = mt.nd.contrib.while_loop(
        cond, func, (mt.nd.array([0.0]), mt.nd.array([1.0])),
        max_iterations=6)
    s0 = torch.ones(1, requires_grad=True)
    outs_t, (it, st) = cf.while_loop(cond, func, (torch.zeros(1), s0),
                                     max_iterations=6)
    onp.testing.assert_allclose(outs_t.detach().numpy(), outs_e.asnumpy())
    onp.testing.assert_allclose(st.detach().numpy(), se.asnumpy())
    st.sum().backward()
    assert float(s0.grad) == 1.0
    a = torch.tensor([3.0])
    assert float(cf.cond(torch.tensor(True), lambda t: t[0] * 2,
                         lambda t: t[0] + 100, inputs=[a])) == 6.0
    assert float(cf.cond(torch.tensor(False), lambda t: t[0] * 2,
                         lambda t: t[0] + 100, inputs=[a])) == 103.0
