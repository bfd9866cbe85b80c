"""The port's ``mx.autograd`` against the JAX package's on the CPU: every
case of tests/test_autograd.py, and each point where torch.autograd and
MXNet's semantics differ (a second backward, a head never recorded,
grad_req, leafness after a rebind, no graph outside record, higher-order
gradients, multi-output ops), each run through ``mxnet_tpu`` and
``mxnet_tpu_torch`` on the same inputs.

Tolerance: rtol 1e-5 for gradients that go through exp or cubes (float32
rounding), equality for the rest (small integers in float32).
"""
import numpy as onp
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def both(case, rtol=0.0):
    """Run ``case(mx)`` through both packages; its results (lists of
    NDArrays or numbers) must agree."""
    def np(v):
        return v.asnumpy() if hasattr(v, 'asnumpy') else onp.asarray(v)
    want = [np(w) for w in case(mj)]
    got = [np(g) for g in case(mt)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=0)
    return got


# ---- every case of tests/test_autograd.py ----------------------------------

def test_simple_backward():
    def case(mx):
        x = mx.nd.array([1., 2., 3.])
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        return [x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [2., 4., 6.])


def test_chain():
    def case(mx):
        x = mx.nd.array([[1., 2.], [3., 4.]])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.exp(x)
            z = (y * 2).sum()
        z.backward()
        return [x.grad]
    both(case, rtol=1e-5)


def test_head_gradient():
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 3
        y.backward(mx.nd.array([10., 100.]))
        return [x.grad]
    both(case)


def test_grad_req_add():
    def case(mx):
        x = mx.nd.array([1., 1.])
        x.attach_grad(grad_req='add')
        for _ in range(3):
            with mx.autograd.record():
                y = (x * 2).sum()
            y.backward()
        return [x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [6., 6.])


def test_detach_and_stop_gradient():
    def case(mx):
        x = mx.nd.array([2.])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            z = y.detach() * x
        z.backward()
        g1 = x.grad.asnumpy()
        with mx.autograd.record():
            w = mx.nd.blockgrad(x * x) * x
        w.backward()
        return [g1, x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[1], [4.])


def test_pause_and_modes():
    def case(mx):
        ag = mx.autograd
        x = mx.nd.array([1.])
        x.attach_grad()
        flags = [ag.is_recording()]
        with ag.record():
            flags += [ag.is_recording(), ag.is_training()]
            with ag.pause():
                flags.append(ag.is_recording())
                x * 2  # not recorded
            z = x * 3
        z.backward()
        with ag.record(train_mode=False):
            flags.append(ag.is_training())
        with ag.train_mode():
            flags.append(ag.is_training())
        with ag.predict_mode():
            flags.append(ag.is_training())
        flags += [ag.set_recording(True), ag.set_recording(False),
                  ag.set_training(True), ag.set_training(False)]
        return [x.grad, onp.array(flags)]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [3.])


def test_grad_function():
    def case(mx):
        x = mx.nd.array([3.])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        return [mx.autograd.grad(y, x), x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [6.])


def test_higher_order_grad():
    def case(mx):
        x = mx.nd.array([2.])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x * x          # y = x^3
            dx = mx.autograd.grad(y, x, create_graph=True, retain_graph=True)
            z = dx * 1
        z.backward()
        return [dx, x.grad]        # 3x^2 = 12 and 6x = 12
    got = both(case, rtol=1e-5)
    onp.testing.assert_allclose(got[1], [12.], rtol=1e-5)


def test_multi_output_backward():
    def case(mx):
        x = mx.nd.array([[1., 2., 3.], [4., 5., 6.]])
        x.attach_grad()
        with mx.autograd.record():
            parts = x.split(3, axis=1)
            y = parts[0].sum() + 2 * parts[2].sum()
        y.backward()
        return [x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [[1, 0, 2], [1, 0, 2]])


def test_multi_output_topk_both():
    """A gradient that comes back through one of two outputs."""
    def case(mx):
        x = mx.nd.array([[3., 1., 2.], [6., 5., 4.]])
        x.attach_grad()
        with mx.autograd.record():
            vals, idx = mx.nd.topk(x, k=2, ret_typ='both')
            y = (vals * mx.nd.array([[1., 10.], [100., 1000.]])).sum()
        y.backward()
        return [x.grad, idx]
    both(case)


def _square(mx):
    class Square(mx.autograd.Function):
        def forward(self, x):
            self._x = x
            return x * x

        def backward(self, dy):
            return 2 * self._x * dy
    return Square


def test_custom_function():
    def case(mx):
        x = mx.nd.array([3.])
        x.attach_grad()
        sq = _square(mx)()
        with mx.autograd.record():
            y = sq(x)
        y.backward()
        outside = _square(mx)()(mx.nd.array([4.]))
        return [x.grad, y, outside]
    both(case)


def test_custom_function_two_outputs():
    def case(mx):
        class SplitScale(mx.autograd.Function):
            def forward(self, a, b):
                return a * 2, a * b

            def backward(self, d1, d2):
                self_b = d2 * 0 + 5
                return d1 * 2 + d2 * self_b, d2 * 7

        a, b = mx.nd.array([1., 2.]), mx.nd.array([5., 5.])
        a.attach_grad()
        with mx.autograd.record():
            u, v = SplitScale()(a, b)
            loss = (u + v * 3).sum()
        loss.backward()
        return [a.grad, u, v]
    both(case)


def test_mark_variables():
    def case(mx):
        x = mx.nd.array([1., 2.])
        g = mx.nd.zeros((2,))
        mx.autograd.mark_variables([x], [g])
        with mx.autograd.record():
            y = (x * 5).sum()
        y.backward()
        return [x.grad, g]
    both(case)


def test_dropout_respects_mode():
    for mx in (mj, mt):
        x = mx.nd.ones((100, 100))
        onp.testing.assert_array_equal(mx.nd.dropout(x, p=0.5).asnumpy(),
                                       onp.ones((100, 100)))
        with mx.autograd.record():
            out = mx.nd.dropout(x, p=0.5).asnumpy()
        frac = (out == 0).mean()
        assert 0.3 < frac < 0.7
        onp.testing.assert_array_equal(out[out != 0], 2.0)
        always = mx.nd.dropout(x, p=0.25, mode='always').asnumpy()
        assert 0.15 < (always == 0).mean() < 0.35
        with mx.autograd.train_mode():
            rows = mx.nd.dropout(x, p=0.5, axes=(1,)).asnumpy()
        assert all(len(set(r)) == 1 for r in rows)


def test_dropout_draws_from_the_seeded_generator():
    x = mt.nd.ones((64, 64))
    masks = []
    for _ in range(2):
        mt.random.seed(11)
        masks.append(mt.nd.dropout(x, p=0.5, mode='always').asnumpy())
    onp.testing.assert_array_equal(masks[0], masks[1])


# ---- where torch.autograd and MXNet differ ---------------------------------

def test_second_backward_without_retain_graph_is_a_no_op():
    """JAX consumed the tape nodes: the second backward leaves x.grad as
    the first wrote it and raises nothing (torch would raise)."""
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        x.grad[:] = 7              # a second write would overwrite this
        y.backward()
        return [x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [7., 7.])


def test_graph_built_on_a_consumed_head_stops_there():
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad(grad_req='add')
        with mx.autograd.record():
            h = x * 3
            y = (h * h).sum()
            y.backward()
            z = (h * 2).sum()
        z.backward()
        return [x.grad]
    both(case)


def test_retain_graph_allows_a_second_backward():
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad(grad_req='add')
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        return [x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [4., 8.])


def test_backward_of_an_unrecorded_head_is_a_no_op():
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad()
        y = (x * x).sum()          # outside record()
        y.backward()
        with mx.autograd.record():
            with mx.autograd.pause():
                z = (x * x).sum()
        z.backward()
        return [x.grad]
    got = both(case)
    onp.testing.assert_array_equal(got[0], [0., 0.])


def test_independent_heads_keep_their_graphs():
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad(grad_req='add')
        with mx.autograd.record():
            y1 = (x * 2).sum()
            y2 = (x * x).sum()
        y1.backward()
        y2.backward()
        return [x.grad]
    both(case)


def test_a_fresh_record_drops_the_last_graph():
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad()
        with mx.autograd.record():
            old = (x * 5).sum()
        with mx.autograd.record():
            new = (x * 2).sum()
        old.backward()
        g_old = x.grad.asnumpy()
        new.backward()
        return [g_old, x.grad]
    both(case)


@pytest.mark.parametrize('req', ['write', 'add', 'null'])
def test_grad_req_into_the_grad_buffer_dtype(req):
    """'write' overwrites, 'add' accumulates, 'null' skips; the gradient
    takes the grad buffer's dtype."""
    def case(mx):
        x = mx.nd.array([1., 2.])
        x.attach_grad(grad_req=req)
        x.grad[:] = 1
        for _ in range(2):
            with mx.autograd.record():
                y = (x * x * 3).sum()
            y.backward()
        g16 = mx.nd.zeros((2,), dtype='float16')
        mx.autograd.mark_variables([x], [g16], req)
        with mx.autograd.record():
            z = (x * 0.5).sum()
        z.backward()
        return [x.grad]
    got = both(case)
    assert got[0].dtype == onp.float16


def test_rebinding_a_variable_keeps_it_a_leaf():
    """SGD written in NDArrays: ``p[:] = p - lr * p.grad`` and ``p -= ...``
    rebind the variable, and the next record still treats it as a leaf."""
    def case(mx):
        p = mx.nd.array([1., -2., 3.])
        q = mx.nd.array([0.5, 0.5, 0.5])
        p.attach_grad()
        q.attach_grad()
        traj = []
        for _ in range(3):
            with mx.autograd.record():
                loss = ((p * q - 1) ** 2).sum()
            loss.backward()
            p[:] = p - 0.1 * p.grad
            q -= 0.1 * q.grad
            traj += [p.copy(), q.copy(), loss]
        return traj
    both(case, rtol=1e-6)


def test_no_graph_outside_record():
    x = mt.nd.array([1., 2.])
    x.attach_grad()
    with mt.autograd.record():
        (x * x).sum().backward()
    assert x._data.requires_grad            # the variable's leaf tensor
    y = x * 2 + 1
    assert not y._data.requires_grad and y._data.grad_fn is None
    with mt.autograd.record():
        with mt.autograd.pause():
            z = x * 2
    assert z._data.grad_fn is None


def test_torch_grad_is_never_written():
    x = mt.nd.array([1., 2.])
    x.attach_grad()
    with mt.autograd.record():
        y = (x * x).sum()
    y.backward()
    assert x._data.grad is None
    onp.testing.assert_array_equal(x.grad.asnumpy(), [2., 4.])


def test_grad_of_an_unreached_variable_is_zero():
    def case(mx):
        x, w = mx.nd.array([1., 2.]), mx.nd.array([3., 4.])
        x.attach_grad()
        w.attach_grad()
        with mx.autograd.record():
            y = (x * 2).sum()
        return mx.autograd.grad(y, [x, w])
    both(case)


def test_recording_is_thread_local():
    import threading
    seen = []
    with mt.autograd.record():
        t = threading.Thread(target=lambda: seen.append(
            mt.autograd.is_recording()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [False]
