"""The port's Python custom operators (``mxnet_tpu_torch.operator``:
``CustomOp``, ``CustomOpProp``, ``register``, ``nd.Custom``,
``sym.Custom``) against the JAX package's, on the CPU.

Every case of tests/test_custom_op.py runs through both packages with
the same user code (each package's ops registered under its own names
by ``define``), its values and gradients held against each other and
against numpy; then ``sym.Custom`` in a symbol graph through the port's
Executor (its shape from the prop's ``infer_shape``), with the user's
``backward`` as the gradient.

Tolerance: f32, rtol 1e-5 (the JAX test's rtol 1e-2 only where it takes
a numeric gradient).
"""
import types

import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def define(mx):
    """tests/test_custom_op.py's four user ops for ``mx``, registered as
    'tt_sigmoid', 'tt_addn', 'tt_swish' and 'tt_twoout'."""
    nd, op = mx.nd, mx.operator

    class Sigmoid(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], nd.array(1 / (1 + onp.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @op.register('tt_sigmoid')
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class AddN(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            acc = in_data[0]
            for a in in_data[1:]:
                acc = acc + a
            self.assign(out_data[0], req[0], acc)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for i in range(len(in_grad)):
                self.assign(in_grad[i], req[i], out_grad[0])

    @op.register('tt_addn')
    class AddNProp(op.CustomOpProp):
        def __init__(self, n='2'):
            super().__init__(need_top_grad=True)
            self.n = int(n)

        def list_arguments(self):
            return [f'in{i}' for i in range(self.n)]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return AddN()

    class Swish(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x * nd.sigmoid(x))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0]
            s = nd.sigmoid(x)
            self.assign(in_grad[0], req[0],
                        out_grad[0] * (s + x * s * (1 - s)))

    @op.register('tt_swish')
    class SwishProp(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Swish()

    class TwoOut(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)
            self.assign(out_data[1], req[1], in_data[0] * 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * 2 + out_grad[1] * 3)

    @op.register('tt_twoout')
    class TwoOutProp(op.CustomOpProp):
        def list_outputs(self):
            return ['a', 'b']

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOut()


define(mj)
define(mt)


@pytest.fixture(params=['jax', 'port'])
def P(request):
    mx = mj if request.param == 'jax' else mt
    return types.SimpleNamespace(mx=mx, nd=mx.nd, autograd=mx.autograd,
                                 port=mx is mt)


def test_custom_forward_backward(P):
    nd = P.nd
    x = nd.array([0.0, 1.0, -2.0])
    x.attach_grad()
    with P.autograd.record():
        y = nd.Custom(x, op_type='tt_sigmoid')
        loss = (y * 2).sum()
    loss.backward()
    s = 1 / (1 + onp.exp(-onp.array([0.0, 1.0, -2.0])))
    onp.testing.assert_allclose(y.asnumpy(), s, rtol=1e-6)
    onp.testing.assert_allclose(x.grad.asnumpy(), 2 * s * (1 - s),
                                rtol=1e-5)


def test_custom_multi_input_kwargs(P):
    nd = P.nd
    a, b, c = (nd.array(v) for v in ([1.0, 2.0], [3.0, 4.0], [5.0, 6.0]))
    for arr in (a, b, c):
        arr.attach_grad()
    with P.autograd.record():
        y = nd.Custom(a, b, c, op_type='tt_addn', n=3)
        y.backward()
    onp.testing.assert_allclose(y.asnumpy(), [9.0, 12.0])
    for arr in (a, b, c):
        onp.testing.assert_allclose(arr.grad.asnumpy(), onp.ones(2))


def test_custom_composes_with_builtin_ops(P):
    nd = P.nd
    x0 = onp.array([[1.0, -1.0], [0.5, 2.0]], 'f')
    x = nd.array(x0)
    x.attach_grad()
    with P.autograd.record():
        y = nd.Custom(nd.dot(x, x), op_type='tt_sigmoid')
        loss = y.sum()
    loss.backward()
    h = x0 @ x0
    s = 1 / (1 + onp.exp(-h))
    g = s * (1 - s)
    onp.testing.assert_allclose(x.grad.asnumpy(), g @ x0.T + x0.T @ g,
                                rtol=1e-5)


def test_custom_unregistered_raises(P):
    with pytest.raises(ValueError):
        P.nd.Custom(P.nd.array([1.0]), op_type='no_such_op')


def test_registry_listing(P):
    assert {'tt_sigmoid', 'tt_addn', 'tt_swish', 'tt_twoout'} <= \
        set(P.mx.operator.list_registered_ops())


def test_custom_op_hybridized(P):
    """A custom op inside a hybridized block's hybrid_forward: forward
    equal to the unhybridized one, gradient finite and non-zero."""
    gluon, nd = P.mx.gluon, P.nd

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.fc = gluon.nn.Dense(4)

        def hybrid_forward(self, F, x):
            return nd.Custom(self.fc(x), op_type='tt_swish')

    net = Net()
    net.initialize(P.mx.init.Xavier())
    x = nd.array(onp.random.RandomState(0).randn(2, 3).astype(onp.float32))
    x.attach_grad()
    eager = net(x).asnumpy()
    net.hybridize()
    with P.autograd.record():
        y = net(x)
        y.sum().backward()
    onp.testing.assert_allclose(y.asnumpy(), eager, rtol=1e-5, atol=1e-5)
    g = x.grad.asnumpy()
    assert onp.isfinite(g).all() and (g != 0).any()


def test_custom_multi_output_default_shapes(P):
    a, b = P.nd.Custom(P.nd.array([1.0, 2.0]), op_type='tt_twoout')
    onp.testing.assert_allclose(a.asnumpy(), [2.0, 4.0])
    onp.testing.assert_allclose(b.asnumpy(), [3.0, 6.0])


def test_registered_custom_op_dispatches_by_op_type(P):
    x = P.nd.array([0.0, 1.0, -2.0])
    out = P.mx.base.get_op('Custom').fn(x, op_type='tt_sigmoid')
    out = out[0] if isinstance(out, (list, tuple)) else out
    s = 1 / (1 + onp.exp(-onp.array([0.0, 1.0, -2.0])))
    onp.testing.assert_allclose(onp.asarray(out.asnumpy() if hasattr(
        out, 'asnumpy') else out), s, rtol=1e-6)


def test_custom_values_and_gradients_match_jax():
    """The swish op on the same values in both packages: output and the
    user backward's gradient."""
    v = onp.random.RandomState(1).randn(3, 4).astype('f')
    res = {}
    for mx in (mt, mj):
        x = mx.nd.array(v)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type='tt_swish')
            (y * y).sum().backward()
        res[mx is mt] = (y.asnumpy(), x.grad.asnumpy())
    for a, b in zip(res[True], res[False]):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_sym_custom_in_an_executor():
    """sym.Custom as a graph node: its output shape from the prop's
    infer_shape at bind, its gradient the user's backward."""
    x = mt.sym.Variable('x')
    y = mt.sym.Custom(mt.sym.FullyConnected(x, num_hidden=3, name='fc'),
                      op_type='tt_sigmoid', name='cs')
    exe = y.simple_bind(x=(2, 4))
    assert exe.arg_dict['fc_weight'].shape == (3, 4)
    rng = onp.random.RandomState(2)
    xv, wv = rng.randn(2, 4).astype('f'), rng.randn(3, 4).astype('f')
    out = exe.forward(is_train=True, x=xv, fc_weight=wv,
                      fc_bias=onp.zeros(3, 'f'))[0].asnumpy()
    exe.backward()
    s = 1 / (1 + onp.exp(-(xv @ wv.T)))
    onp.testing.assert_allclose(out, s, rtol=1e-6)
    onp.testing.assert_allclose(exe.grad_dict['fc_weight'].asnumpy(),
                                (s * (1 - s)).T @ xv, rtol=1e-5)
