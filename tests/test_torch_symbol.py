"""The port's symbolic API (``mxnet_tpu_torch.symbol``, ``executor``,
``executor_manager``, ``monitor``, ``name``, ``attribute``,
``visualization`` and the ops the graphs need) against the JAX package,
on the CPU.

Every case of tests/test_misc_modules.py's symbol, executor, monitor and
name cases and of tests/test_attr_scope.py runs through both packages
with the same code (the ``P`` fixture; the port inside ``with mx.cpu():``,
its default context being the card); then the same graphs, built in both
packages with explicit names and fed the same numpy arrays, are held
against each other: the JSON byte for byte and loaded across, the
Executor's forward and every gradient, the loss ops' custom gradients
against ``jax.grad``.

Tolerance: f32; the two compute in another summation order, so outputs
agree to rtol 1e-5, atol 1e-6 and gradients to rel Frobenius 1e-5.

Two reference faults are pinned here (ROADMAP queue 3): the JAX
Executor's ``forward(is_train=True)`` leaves the ops in predict mode and
never moves the BatchNorm moving statistics (the JAX side of a training
comparison runs under ``mxnet_tpu.autograd.train_mode()``), and its
``_OpMaker`` drops a tuple passed as an input, which the port refuses.
"""
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _pkg(mx):
    return types.SimpleNamespace(mx=mx, nd=mx.nd, sym=mx.sym,
                                 port=mx is mt)


JAX, PORT = _pkg(mj), _pkg(mt)


@pytest.fixture(params=['jax', 'port'])
def P(request):
    return JAX if request.param == 'jax' else PORT


def _np(v):
    if hasattr(v, 'asnumpy'):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return onp.asarray(v)


def _set(arr, value):
    """Write a numpy value into an executor's array in either package."""
    if isinstance(arr, mt.nd.NDArray):
        arr._data = torch.tensor(onp.asarray(value, onp.float32))
    else:
        import jax.numpy as jnp
        arr._data = jnp.asarray(onp.asarray(value, onp.float32))


def rel_fro(got, want):
    got, want = _np(got).astype(onp.float64), _np(want).astype(onp.float64)
    return float(onp.linalg.norm(got - want) /
                 max(onp.linalg.norm(want), 1e-30))


def grad_close(got, want, tol=1e-5):
    """rel Frobenius within ``tol``; a gradient that is zero in exact
    arithmetic (a bias ahead of a BatchNorm: rounding noise of 1e-8) is
    held absolutely, to 1e-6."""
    if onp.linalg.norm(_np(want)) < 1e-6:
        return float(onp.abs(_np(got) - _np(want)).max()) < 1e-6
    return rel_fro(got, want) < tol


# ---------------------------------------------------------------------------
# tests/test_misc_modules.py, both packages
# ---------------------------------------------------------------------------

def test_name_manager_counters_and_prefix(P):
    sym = P.sym
    with P.mx.name.NameManager():
        a = sym.sin(sym.Variable('x'))
        b = sym.sin(sym.Variable('y'))
        c = sym.cos(a)
    assert a.name == 'sin0' and b.name == 'sin1' and c.name == 'cos0'
    with P.mx.name.Prefix('net_'):
        d = sym.sin(sym.Variable('z'))
    assert d.name == 'net_sin0'
    e, f = sym.sin(sym.Variable('u')), sym.sin(sym.Variable('v'))
    assert e.name != f.name


def test_prefix_applies_to_explicit_names(P):
    sym = P.sym
    with P.mx.name.Prefix('net1_'):
        w = sym.Variable('w')
    with P.mx.name.Prefix('net2_'):
        w2 = sym.Variable('w')
    assert w.name == 'net1_w' and w2.name == 'net2_w'
    assert w._uid != w2._uid
    with P.mx.name.Prefix('p_'):
        parts = sym.split(sym.Variable('x'), num_outputs=2, name='sp')
    assert parts[0].name == parts[1].name == 'p_sp'


def test_monitor_collects_stats(P):
    sym = P.sym
    x = sym.Variable('x')
    z = sym.cos(sym.sin(x, name='s1'), name='c1')
    exe = z.simple_bind(P.mx.cpu(0), grad_req='null', x=(2, 3))
    xv = onp.random.RandomState(0).randn(2, 3).astype('float32')
    _set(exe.arg_dict['x'], xv)
    mon = P.mx.monitor.Monitor(interval=2, pattern='.*')
    mon.install(exe)
    mon.tic()
    exe.forward()
    rows = mon.toc()
    names = {r[1] for r in rows}
    assert 's1_output' in names and 'c1_output' in names
    stats = {r[1]: float(r[2]) for r in rows}
    assert abs(stats['s1_output'] - onp.abs(onp.sin(xv)).mean()) < 1e-6
    mon.tic()
    exe.forward()
    assert mon.toc() == []
    out_m = exe.forward()[0].asnumpy()
    exe2 = z.simple_bind(P.mx.cpu(0), grad_req='null', x=(2, 3))
    _set(exe2.arg_dict['x'], xv)
    onp.testing.assert_allclose(out_m, exe2.forward()[0].asnumpy(),
                                rtol=1e-6)


def test_monitor_pattern_filter(P):
    sym = P.sym
    z = sym.cos(sym.sin(sym.Variable('x'), name='keepme'), name='dropme')
    exe = z.simple_bind(P.mx.cpu(0), grad_req='null', x=(2, 2))
    _set(exe.arg_dict['x'], onp.ones((2, 2)))
    mon = P.mx.monitor.Monitor(interval=1, pattern='keepme.*')
    mon.install(exe)
    mon.tic()
    exe.forward()
    assert [r[1] for r in mon.toc()] == ['keepme_output']


def test_monitor_all_records_inputs(P):
    sym = P.sym
    z = sym.sin(sym.Variable('xin'), name='op1')
    exe = z.simple_bind(P.mx.cpu(0), grad_req='null', xin=(2, 2))
    _set(exe.arg_dict['xin'], onp.ones((2, 2)))
    mon = P.mx.monitor.Monitor(interval=1, monitor_all=True)
    mon.install(exe)
    mon.tic()
    exe.forward()
    names = {r[1] for r in mon.toc()}
    assert 'xin_output' in names and 'op1_output' in names
    mon2 = P.mx.monitor.Monitor(interval=1)
    mon2.install(exe)
    mon2.tic()
    exe.forward()
    names2 = {r[1] for r in mon2.toc()}
    assert 'xin_output' not in names2 and 'op1_output' in names2


def test_set_monitor_callback(P):
    collected = []
    z = P.sym.sin(P.sym.Variable('x'), name='m1')
    exe = z.simple_bind(P.mx.cpu(0), grad_req='null', x=(2, 2))
    _set(exe.arg_dict['x'], onp.ones((2, 2)))
    exe.set_monitor_callback(lambda name, v: collected.append(name))
    exe.forward()
    assert 'm1_output' in collected
    exe.set_monitor_callback(None)
    collected.clear()
    exe.forward()
    assert collected == []


def test_executor_module_reexport(P):
    assert P.mx.executor.Executor is P.mx.symbol.Executor


def test_executor_manager_forward_backward(P):
    from collections import namedtuple
    em = P.mx.executor_manager
    sym = P.sym
    assert em._split_input_slice(10, [1, 1]) == [slice(0, 5), slice(5, 10)]
    x = sym.Variable('data')
    w = sym.Variable('w', shape=(1, 4))
    out = sym.FullyConnected(x, w, None, num_hidden=1, no_bias=True,
                             name='fc')
    mgr = em.DataParallelExecutorManager(
        out, ctx=[P.mx.cpu(0), P.mx.cpu(0)],
        data_shapes=[('data', (8, 4))], param_names=['w'])
    assert len(mgr.execs) == 2
    X = onp.random.RandomState(0).randn(8, 4).astype('float32')
    batch = namedtuple('B', ['data', 'label'])([P.nd.array(X)], [])
    for e in mgr.execs:
        _set(e.arg_dict['w'], onp.ones((1, 4)))
    mgr.load_data_batch(batch)
    mgr.forward(is_train=True)
    got = onp.concatenate([e.outputs[0].asnumpy() for e in mgr.execs])
    onp.testing.assert_allclose(got, X @ onp.ones((4, 1), 'float32'),
                                rtol=1e-5)
    mgr.backward()
    assert mgr.grad_arrays[0][0].shape == (1, 4)
    onp.testing.assert_allclose(mgr.grad_arrays[0][1].asnumpy(),
                                X[4:].sum(0, keepdims=True), rtol=1e-5)


def test_symbol_auto_params_json_roundtrip_binds(P):
    out = P.sym.FullyConnected(P.sym.Variable('data'), num_hidden=8,
                               name='fc1')
    rt = P.mx.symbol.fromjson(out.tojson())
    ex = rt.simple_bind(P.mx.cpu(), data=(4, 16))
    assert ex.arg_dict['fc1_weight'].shape == (8, 16)
    assert ex.arg_dict['fc1_bias'].shape == (8,)


def test_executor_reshape_threads_aux_states(P):
    sym = P.sym
    bn = sym.BatchNorm(sym.Variable('data'), name='bn')
    net = sym.FullyConnected(bn[0], num_hidden=3, name='fc')
    exe = net.simple_bind(P.mx.cpu(), data=(4, 5))
    rs = onp.random.RandomState(0)
    for n, a in exe.arg_dict.items():
        if n != 'data':
            _set(a, rs.randn(*a.shape))
    _set(exe.aux_dict['bn_moving_mean'], onp.full((5,), 0.25))
    _set(exe.aux_dict['bn_moving_var'], onp.full((5,), 2.0))
    x4 = rs.randn(4, 5).astype('float32')
    out4 = exe.forward(is_train=False, data=x4)[0].asnumpy()
    exe2 = exe.reshape(data=(8, 5))
    assert set(exe2.aux_dict) == {'bn_moving_mean', 'bn_moving_var'}
    onp.testing.assert_allclose(exe2.aux_dict['bn_moving_var'].asnumpy(),
                                2.0)
    out8 = exe2.forward(is_train=False,
                        data=onp.concatenate([x4, x4]))[0].asnumpy()
    onp.testing.assert_allclose(out8[:4], out4, atol=1e-5)
    onp.testing.assert_allclose(out8[4:], out4, atol=1e-5)


def test_batchnorm_auto_params_are_aux_states_at_bind(P):
    sym = P.sym
    c = sym.Convolution(sym.Variable('data'), kernel=(3, 3), num_filter=4,
                        name='c1')
    bn = sym.BatchNorm(c, name='bn1')
    f = sym.FullyConnected(sym.Flatten(sym.Activation(bn[0],
                                                      act_type='relu')),
                           num_hidden=2, name='fc')
    out = sym.SoftmaxOutput(f, sym.Variable('softmax_label'), name='sm')
    aux = out.list_auxiliary_states()
    assert set(aux) == {'bn1_moving_mean', 'bn1_moving_var'}
    assert not set(aux) & set(out.list_arguments())
    assert set(P.mx.symbol.fromjson(out.tojson())
               .list_auxiliary_states()) == set(aux)
    ex = out.simple_bind(P.mx.cpu(), data=(2, 3, 8, 8), softmax_label=(2,))
    onp.testing.assert_allclose(ex.aux_dict['bn1_moving_var'].asnumpy(),
                                1.0)
    ex.forward(is_train=True)
    ex.backward()
    assert 'bn1_moving_mean' not in ex.grad_dict


def test_softmax_output_inference_and_gradient(P):
    """softmax_output's forward is the softmax; its gradient is finite
    (tests/test_misc_modules.py::test_softmax_output_jit_inference)."""
    d = onp.random.RandomState(0).randn(4, 3).astype('float32')
    lab = onp.array([0, 1, 2, 1], onp.float32)
    x = P.nd.array(d)
    x.attach_grad()
    with P.mx.autograd.record():
        out = P.nd.softmax_output(x, P.nd.array(lab), use_ignore=True,
                                  ignore_label=-1)
    out.backward()
    e = onp.exp(d - d.max(1, keepdims=True))
    onp.testing.assert_allclose(out.asnumpy(), e / e.sum(1, keepdims=True),
                                rtol=1e-6)
    assert onp.isfinite(x.grad.asnumpy()).all()


# ---------------------------------------------------------------------------
# tests/test_attr_scope.py, both packages (one CPU device in the port)
# ---------------------------------------------------------------------------

def test_attr_scope_attaches_dunder_attrs(P):
    sym = P.sym
    with P.mx.AttrScope(ctx_group='stage1', lr_mult='0.5'):
        x = sym.Variable('x')
        y = sym.sin(x)
    z = sym.cos(y)
    assert x.attr('__ctx_group__') == 'stage1'
    assert y.attr('__ctx_group__') == 'stage1'
    assert y.attr('__lr_mult__') == '0.5'
    assert z.attr('__ctx_group__') is None


def test_attr_scope_nesting_inner_wins(P):
    sym = P.sym
    with P.mx.AttrScope(ctx_group='outer'):
        a = sym.Variable('a')
        with P.mx.AttrScope(ctx_group='inner'):
            b = sym.exp(a)
        c = sym.exp(a)
    assert a.attr('__ctx_group__') == 'outer'
    assert b.attr('__ctx_group__') == 'inner'
    assert c.attr('__ctx_group__') == 'outer'


def test_attr_scope_rejects_non_string(P):
    with pytest.raises(ValueError):
        P.mx.AttrScope(ctx_group=3)


def _grouped_fc(sym, mx):
    x = sym.Variable('x')
    with mx.AttrScope(ctx_group='dev1'):
        h = sym.FullyConnected(x, sym.Variable('fc1_weight'),
                               sym.Variable('fc1_bias'), num_hidden=8,
                               name='fc1')
    with mx.AttrScope(ctx_group='dev2'):
        return sym.FullyConnected(h, sym.Variable('fc2_weight'),
                                  sym.Variable('fc2_bias'), num_hidden=4,
                                  name='fc2')


SHAPES = dict(x=(2, 16), fc1_weight=(8, 16), fc1_bias=(8,),
              fc2_weight=(4, 8), fc2_bias=(4,))


def test_group2ctx_numerics_match_the_ungrouped_executor():
    """The port's group2ctx places each group's nodes on its device (on
    one CPU here; the card test mixes the CPU and the card): outputs and
    gradients equal the ungrouped executor's and the JAX package's
    grouped one over its CPU devices."""
    rng = onp.random.RandomState(0)
    vals = {n: rng.randn(*s).astype('float32') for n, s in SHAPES.items()}
    outs, grads = {}, {}
    for pkg, groups in ((PORT, {'dev1': mt.cpu(), 'dev2': mt.cpu()}),
                        (PORT, None),
                        (JAX, {'dev1': mj.Context('cpu', 0),
                               'dev2': mj.Context('cpu', 1)})):
        out = _grouped_fc(pkg.sym, pkg.mx)
        exe = out.simple_bind(pkg.mx.cpu(0), grad_req='write',
                              group2ctx=groups, **SHAPES)
        for n, v in vals.items():
            _set(exe.arg_dict[n], v)
        key = (pkg.port, groups is None)
        outs[key] = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        grads[key] = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    ref = outs[(True, True)]
    for key in outs:
        onp.testing.assert_allclose(outs[key], ref, rtol=RTOL, atol=ATOL)
        for n in SHAPES:
            assert rel_fro(grads[key][n], grads[(True, True)][n]) < 1e-5


def test_group2ctx_merging_groups(P):
    sym = P.sym
    x = sym.Variable('x')
    with P.mx.AttrScope(ctx_group='g1'):
        a = sym.sin(x)
    with P.mx.AttrScope(ctx_group='g2'):
        b = sym.cos(x)
    c = a + b
    groups = {'g1': P.mx.cpu(0), 'g2': P.mx.cpu(0)}
    exe = c.simple_bind(P.mx.cpu(0), grad_req='null', group2ctx=groups,
                        x=(2, 2))
    xv = onp.random.RandomState(0).randn(2, 2).astype('float32')
    _set(exe.arg_dict['x'], xv)
    onp.testing.assert_allclose(exe.forward()[0].asnumpy(),
                                onp.sin(xv) + onp.cos(xv), rtol=1e-5,
                                atol=1e-6)


def test_group2ctx_training_backward(P):
    x = P.sym.Variable('x')
    with P.mx.AttrScope(ctx_group='dev2'):
        y = P.sym.sin(x)
    exe = y.simple_bind(P.mx.cpu(0), grad_req='write',
                        group2ctx={'dev2': P.mx.cpu(0)}, x=(3, 3))
    xv = onp.random.RandomState(1).randn(3, 3).astype('float32')
    _set(exe.arg_dict['x'], xv)
    exe.forward(is_train=True)
    exe.backward()
    onp.testing.assert_allclose(exe.grad_dict['x'].asnumpy(), onp.cos(xv),
                                rtol=1e-5, atol=1e-6)


def test_deep_graph_traversals_no_recursion_limit(P):
    sym = P.sym
    s = sym.Variable('x0')
    for _ in range(2000):
        s = sym.sin(s)
    assert s.list_arguments() == ['x0']
    assert len(s.get_internals()) == 2001
    assert s.tojson().count('"sin"') == 2000
    d = sym.Variable('d')
    for _ in range(40):
        d = d + d
    assert d.list_arguments() == ['d']
    d.tojson()


def test_deep_graph_evaluates_without_recursion():
    """The port's executor walks the graph iteratively too: a 2000-op
    chain binds and runs (the JAX executor's evaluation recurses)."""
    s = mt.sym.Variable('x0')
    for _ in range(2000):
        s = s * 1.0
    exe = s.simple_bind(x0=(3,))
    exe.arg_dict['x0']._data = torch.tensor([1.0, 2.0, 3.0])
    onp.testing.assert_allclose(exe.forward()[0].asnumpy(), [1, 2, 3])


# ---------------------------------------------------------------------------
# The same graphs in both packages
# ---------------------------------------------------------------------------

def conv_net(sym, with_label=True):
    """conv -> BatchNorm -> relu -> max pool -> FC -> SoftmaxOutput, every
    node named (the auto-created parameters too)."""
    x = sym.Variable('data')
    c = sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name='c1')
    bn = sym.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=0.9,
                       name='bn1')
    a = sym.Activation(bn[0], act_type='relu', name='relu1')
    p = sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type='max',
                    name='pool1')
    f = sym.FullyConnected(sym.Flatten(p, name='flat'), num_hidden=3,
                           name='fc')
    if not with_label:
        return f
    return sym.SoftmaxOutput(f, sym.Variable('softmax_label'), name='sm')


def _conv_values(shapes, seed=0):
    rng = onp.random.RandomState(seed)
    vals = {}
    for n, s in shapes.items():
        if n == 'softmax_label':
            vals[n] = rng.randint(0, 3, s).astype('float32')
        elif n.endswith('moving_var'):
            vals[n] = onp.ones(s, 'float32')
        elif n.endswith('moving_mean'):
            vals[n] = onp.zeros(s, 'float32')
        else:
            vals[n] = (rng.randn(*s) * (0.3 if n != 'data' else 1.0)
                       ).astype('float32')
    return vals


def test_json_is_byte_equal_and_loads_across():
    js = conv_net(mj.sym).tojson()
    tj = conv_net(mt.sym).tojson()
    assert tj == js
    assert mj.symbol.fromjson(tj).tojson() == js
    assert mt.symbol.fromjson(js).tojson() == js


def test_json_files_load_across_and_run_alike(tmp_path):
    """A graph saved by one package is loaded by the other and computes
    the same predict-mode output on the same values."""
    mj_file, mt_file = str(tmp_path / 'j.json'), str(tmp_path / 't.json')
    conv_net(mj.sym, with_label=False).save(mj_file)
    conv_net(mt.sym, with_label=False).save(mt_file)
    shapes = dict(data=(2, 3, 8, 8))
    outs = []
    for pkg, path in ((PORT, mj_file), (JAX, mt_file)):
        s = pkg.mx.symbol.load(path)
        exe = s.simple_bind(pkg.mx.cpu(), grad_req='null', **shapes)
        vals = _conv_values({**{n: a.shape for n, a in exe.arg_dict.items()},
                             **{n: a.shape for n, a in exe.aux_dict.items()}})
        for n, v in vals.items():
            _set({**exe.arg_dict, **exe.aux_dict}[n], v)
        outs.append(exe.forward()[0].asnumpy())
    onp.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)


def test_infer_shape_matches_jax():
    shapes = dict(data=(2, 3, 8, 8), softmax_label=(2,))
    t_args, t_out, t_aux = conv_net(mt.sym).infer_shape(**shapes)
    net = conv_net(mj.sym)
    exe = net.simple_bind(mj.cpu(), **shapes)
    assert t_args == [tuple(exe.arg_dict[n].shape)
                      for n in net.list_arguments()]
    assert t_out == [(2, 3)]
    assert t_aux == [(4,), (4,)]
    assert mt.sym.Variable('w').infer_shape() == (None, None, None)


def _run_train(pkg, shapes, vals, grad_req='write', train_mode=False):
    net = conv_net(pkg.sym)
    exe = net.simple_bind(pkg.mx.cpu(), grad_req=grad_req, **shapes)
    for n, v in vals.items():
        _set({**exe.arg_dict, **exe.aux_dict}[n], v)
    if train_mode:
        with mj.autograd.train_mode():
            out = exe.forward(is_train=True)[0].asnumpy()
            exe.backward()
    else:
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
    return exe, out


def test_executor_training_step_matches_jax():
    """One training forward and backward of the conv/BN/pool/FC/
    SoftmaxOutput graph: outputs and every gradient against the JAX
    Executor (run under its train_mode, fault 1)."""
    shapes = dict(data=(4, 3, 8, 8), softmax_label=(4,))
    net = conv_net(mt.sym)
    names = net.list_arguments() + net.list_auxiliary_states()
    exe = net.simple_bind(**shapes)
    vals = _conv_values({n: ({**exe.arg_dict, **exe.aux_dict}[n].shape)
                         for n in names})
    te, tout = _run_train(PORT, shapes, vals)
    je, jout = _run_train(JAX, shapes, vals, train_mode=True)
    onp.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    for n in net.list_arguments():
        if n == 'softmax_label':
            continue
        assert grad_close(te.grad_dict[n], je.grad_dict[n]), n


def test_grad_req_add_accumulates_and_bind_takes_lists():
    x = mt.sym.Variable('x')
    y = mt.sym.sin(x) * 2.0
    xv = torch.tensor([0.1, 0.2, 0.3])
    g = mt.nd.zeros((3,))
    exe = y.bind(args=[mt.nd.array(xv.numpy())], args_grad=[g],
                 grad_req='add')
    for _ in range(2):
        exe.forward(is_train=True)
        exe.backward()
    onp.testing.assert_allclose(exe.grad_dict['x'].asnumpy(),
                                4 * onp.cos(xv.numpy()), rtol=1e-6)
    exe.backward(out_grads=mt.nd.array(onp.full(3, 0.5, 'f')))
    onp.testing.assert_allclose(exe.grad_dict['x'].asnumpy(),
                                5 * onp.cos(xv.numpy()), rtol=1e-6)
    with pytest.raises(MXNetError, match='before backward'):
        y.bind(args={'x': mt.nd.array(xv.numpy())}).backward()


def test_executor_training_forward_updates_moving_stats_as_mxnet():
    """Fault 1 (ROADMAP queue 3): forward(is_train=True) normalises with
    the batch statistics and writes the moving ones back into aux_dict
    by numpy's momentum formula, in place; the JAX Executor does
    neither (its output keeps the data's mean, its moving mean stays 0)."""
    rng = onp.random.RandomState(3)
    x = (rng.randn(8, 3, 4, 4) + 5.0).astype('float32')
    outs = {}
    for pkg in (PORT, JAX):
        bn = pkg.sym.BatchNorm(pkg.sym.Variable('data'), fix_gamma=True,
                               momentum=0.9, eps=1e-5, name='bn')
        exe = bn[0].simple_bind(pkg.mx.cpu(), data=x.shape)
        mean_arr = exe.aux_dict['bn_moving_mean']
        out = exe.forward(is_train=True, data=x)[0].asnumpy()
        outs[pkg.port] = (out, exe.aux_dict['bn_moving_mean'].asnumpy(),
                          exe.aux_dict['bn_moving_var'].asnumpy(),
                          mean_arr)
    out, mean, var, arr = outs[True]
    onp.testing.assert_allclose(out.mean(axis=(0, 2, 3)), 0, atol=1e-5)
    onp.testing.assert_allclose(mean, 0.1 * x.mean(axis=(0, 2, 3)),
                                rtol=1e-5)
    onp.testing.assert_allclose(var, 0.9 + 0.1 * x.var(axis=(0, 2, 3)),
                                rtol=1e-5)
    assert arr.asnumpy() is not None and \
        onp.allclose(arr.asnumpy(), mean)      # the same array, in place
    jout, jmean = outs[False][0], outs[False][1]
    assert jout.mean() > 4.0 and not jmean.any()


def test_tuple_input_raises_naming_the_op():
    """Fault 2 (ROADMAP queue 3): a multi-output op's tuple passed as an
    input raises in the port, naming the op; the JAX _OpMaker drops it
    silently, and its graph loses the data."""
    bn_t = mt.sym.BatchNorm(mt.sym.Variable('data'), name='bn')
    with pytest.raises(MXNetError, match='activation.*bn\\[0\\]'):
        mt.sym.Activation(bn_t, act_type='relu')
    assert 'data' in mt.sym.Activation(bn_t[0], act_type='relu') \
        .list_arguments()
    bn_j = mj.sym.BatchNorm(mj.sym.Variable('data'), name='bn')
    lost = mj.sym.Activation(bn_j, act_type='relu')
    assert 'data' not in lost.list_arguments()


def test_get_internals_feature_extraction(P):
    net = conv_net(P.sym)
    feat = net.get_internals()['flat_output']
    assert feat.name == 'flat'
    exe = feat.simple_bind(P.mx.cpu(), grad_req='null', data=(2, 3, 8, 8))
    assert exe.forward()[0].shape == (2, 64)


def test_eval_and_operators(P):
    a, b = P.sym.Variable('a'), P.sym.Variable('b')
    s = (a + b) * 2.0 - a / b + (-b) + 1.0 / a
    av, bv = onp.array([1.0, 2.0], 'f'), onp.array([3.0, 4.0], 'f')
    out = s.eval(P.mx.cpu(), a=P.nd.array(av), b=P.nd.array(bv))[0]
    onp.testing.assert_allclose(out.asnumpy(),
                                (av + bv) * 2 - av / bv - bv + 1 / av,
                                rtol=1e-6)


def test_print_summary_and_plot_network(capsys):
    net = conv_net(mt.sym)
    mt.visualization.print_summary(net)
    text = capsys.readouterr().out
    assert 'c1 (convolution)' in text and 'sm (softmax_output)' in text
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(MXNetError, match='graphviz'):
            mt.visualization.plot_network(net)


# ---------------------------------------------------------------------------
# The ops the graphs need, against the JAX ops
# ---------------------------------------------------------------------------

def _jax_grad(opname, args, kwargs, ct, argnum=0):
    import jax
    import jax.numpy as jnp
    fn = mj.base.get_op(opname).fn
    jargs = [jnp.asarray(a) for a in args]

    def f(x):
        a = list(jargs)
        a[argnum] = x
        return jnp.sum(fn(*a, **kwargs) * jnp.asarray(ct))
    out = fn(*jargs, **kwargs)
    return onp.asarray(out), onp.asarray(jax.grad(f)(jargs[argnum]))


def _port_grad(opname, args, kwargs, ct, argnum=0):
    fn = mt.base.get_op(opname).fn
    targs = [torch.tensor(a) for a in args]
    targs[argnum].requires_grad_()
    out = fn(*targs, **kwargs)
    (out * torch.tensor(ct)).sum().backward()
    return out.detach().numpy(), targs[argnum].grad.numpy()


LOSS_CASES = [
    ('softmax_output', dict()),
    ('softmax_output', dict(grad_scale=2.0, normalization='batch')),
    ('softmax_output', dict(use_ignore=True, ignore_label=1)),
    ('SoftmaxOutput', dict(multi_output=True)),
    ('MakeLoss', dict(grad_scale=0.5)),
    ('make_loss', dict(normalization='batch')),
    ('make_loss', dict(normalization='valid', valid_thresh=0.1)),
    ('gradient_multiplier', dict(scalar=-0.3)),
    ('linear_regression_output', dict(grad_scale=2.0)),
    ('mae_regression_output', dict()),
    ('logistic_regression_output', dict(grad_scale=0.5)),
]


@pytest.mark.parametrize('opname,kwargs', LOSS_CASES,
                         ids=[f'{o}-{i}' for i, (o, _) in
                              enumerate(LOSS_CASES)])
def test_loss_ops_forward_and_custom_gradient_match_jax(opname, kwargs):
    rng = onp.random.RandomState(7)
    multi = kwargs.get('multi_output')
    data = rng.randn(*((4, 3, 5) if multi else (4, 3))).astype('float32')
    ct = rng.randn(*data.shape).astype('float32')
    if opname.lower().startswith('softmax'):
        label = rng.randint(0, 3, (4, 5) if multi else (4,)) \
            .astype('float32')
        args = [data, label]
    elif 'regression' in opname:
        args = [data, rng.rand(4, 3).astype('float32')]
    else:
        args = [data]
    jout, jgrad = _jax_grad(opname, args, kwargs, ct)
    tout, tgrad = _port_grad(opname, args, kwargs, ct)
    onp.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(tgrad, jgrad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('opname', ['SliceChannel', 'slice_channel'])
def test_slice_channel_matches_jax(opname):
    x = onp.random.RandomState(0).randn(2, 6, 3).astype('float32')
    j = mj.base.get_op(opname).fn(x, num_outputs=3, axis=1,
                                  squeeze_axis=False)
    t = mt.base.get_op(opname).fn(torch.tensor(x), num_outputs=3, axis=1)
    assert len(t) == 3
    for a, b in zip(t, j):
        onp.testing.assert_array_equal(a.numpy(), onp.asarray(b))
    assert mt.base.get_op(opname).num_outputs == -1


ATTN_CASES = ['selfatt', 'encdec', 'div_sqrt_dim', 'mha_none', 'mha_mask',
              'mha_bool_mask', 'mha_causal']


@pytest.mark.parametrize('case', ATTN_CASES)
def test_attention_ops_match_jax(case):
    rng = onp.random.RandomState(2)
    T, N, H, D = 5, 2, 2, 4

    def run(pkg):
        fn = pkg.mx.base.get_op

        def arr(a):
            if pkg.port:
                return torch.tensor(a)
            import jax.numpy as jnp
            return jnp.asarray(a)
        qkv = rng_vals['qkv']
        if case == 'selfatt':
            att = fn('interleaved_matmul_selfatt_qk').fn(arr(qkv), heads=H)
            return fn('interleaved_matmul_selfatt_valatt').fn(
                arr(qkv), att, heads=H)
        if case == 'encdec':
            q = rng_vals['q']
            kv = rng_vals['kv']
            att = fn('interleaved_matmul_encdec_qk').fn(arr(q), arr(kv),
                                                        heads=H)
            return fn('interleaved_matmul_encdec_valatt').fn(arr(kv), att,
                                                             heads=H)
        if case == 'div_sqrt_dim':
            return fn('div_sqrt_dim').fn(arr(qkv))
        q, k, v = (arr(rng_vals[n]) for n in ('mq', 'mk', 'mv'))
        kw = dict(num_heads=H)
        if case == 'mha_causal':
            kw['causal'] = True
        if case == 'mha_mask':
            kw['mask'] = arr(rng_vals['mask'])
        if case == 'mha_bool_mask':
            kw['mask'] = arr(rng_vals['mask'] == 0)
        return fn('multi_head_attention').fn(q, k, v, **kw)

    rng_vals = dict(qkv=rng.randn(T, N, 3 * H * D), q=rng.randn(T, N, H * D),
                    kv=rng.randn(T + 1, N, 2 * H * D),
                    mq=rng.randn(N, T, H * D), mk=rng.randn(N, T, H * D),
                    mv=rng.randn(N, T, H * D),
                    mask=onp.where(rng.rand(N, 1, 1, T) < 0.3, -1e9, 0.0))
    rng_vals = {k: v.astype('float32') for k, v in rng_vals.items()}
    got = run(PORT)
    want = run(JAX)
    onp.testing.assert_allclose(_np(got), onp.asarray(want), rtol=RTOL,
                                atol=1e-5)


def test_attention_has_a_shape_rule_and_binds_without_running():
    """Shape inference gives multi_head_attention query's shape from its
    shape rule: no meta tensor reaches the flash kernel's wrapper."""
    from mxnet_tpu_torch import symbol as S
    q = mt.sym.Variable('q')
    out = mt.sym.multi_head_attention(q, q, q, num_heads=2, name='att')
    calls = []
    orig = S._SHAPE_RULES['multi_head_attention']
    S._SHAPE_RULES['multi_head_attention'] = \
        lambda shapes, attrs: calls.append(shapes) or orig(shapes, attrs)
    try:
        assert out.infer_shape(q=(2, 5, 8))[1] == [(2, 5, 8)]
    finally:
        S._SHAPE_RULES['multi_head_attention'] = orig
    assert calls == [[(2, 5, 8)] * 3]


def test_simple_bind_takes_the_scope_device():
    """simple_bind with no ctx binds where the context scope says: the
    CPU here, inside ``with mx.cpu():`` (without one, the card:
    tests/test_torch_isolation.py)."""
    exe = mt.sym.sin(mt.sym.Variable('x')).simple_bind(x=(2,))
    assert exe.arg_dict['x']._data.device.type == 'cpu'
