"""``contrib.quantization`` (``quantize_net``) of the port against the JAX
package's, on the CPU.

The ``quantize_net`` cases of tests/test_quantization.py run through
both packages: the entropy threshold, naive, dynamic ('none') and
entropy calibration with hybridize, a conv net, ``exclude_layers``, the
save/load round trip, channel-wise against tensor-wise, the refusals and
the in-place fallback. From the same float weights and calibration
batches both packages give the same calibration ranges (rel 1e-6: the
float layers ahead of a range round alike to a few ulps), the same int8
weights and weight ranges bitwise (numpy's arithmetic in both), and the
same outputs within rel 1e-5 (the int32 products are exact in both).
A quantized net's parameters cross between the packages by structured
name (``weights.params_from_mxnet_tpu``) and as a ``.params`` file, both
ways, giving the same outputs.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib.quantization import quantize_net as jquantize
from mxnet_tpu_torch.contrib.quantization import (
    _get_optimal_threshold, quantize_model, quantize_net)
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': jmx, 'port': mx}
QNET = {'jax': jquantize, 'port': quantize_net}


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _mlp(m, arrays=None):
    net = m.gluon.nn.HybridSequential(prefix='mlp_')
    with net.name_scope():
        net.add(m.gluon.nn.Dense(32, activation='relu', in_units=20))
        net.add(m.gluon.nn.Dense(10, in_units=32))
    return _init(m, net, arrays)


def _convnet(m, arrays=None, act='relu'):
    net = m.gluon.nn.HybridSequential(prefix='conv_')
    with net.name_scope():
        net.add(m.gluon.nn.Conv2D(8, kernel_size=3, padding=1,
                                  in_channels=3, activation=act))
        net.add(m.gluon.nn.Conv2D(4, kernel_size=3, padding=1,
                                  in_channels=8))
    return _init(m, net, arrays)


def _init(m, net, arrays):
    net.initialize(m.init.Xavier())
    if arrays is not None:
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(m.nd.array(arrays[k]))
    return net


def _arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _kinds(net):
    return [type(c).__name__ for c in net._children.values()]


def test_entropy_threshold_reasonable():
    rs = onp.random.RandomState(6)
    arr = onp.concatenate([rs.normal(0, 1, 100000),
                           onp.array([50.0, -50.0])]).astype('float32')
    mn, mx_, th, div = _get_optimal_threshold(arr, num_bins=1001)
    assert mn < 0 < mx_
    assert 1.0 < th < 25.0
    from mxnet_tpu.contrib.quantization import _get_optimal_threshold as jt
    assert (mn, mx_, th, div) == jt(arr, num_bins=1001)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_naive_mlp_close_to_float(pkg):
    m = PKGS[pkg]
    rs = onp.random.RandomState(7)
    net = _mlp(m)
    calib = m.nd.array(rs.uniform(-1, 1, (16, 20)).astype('float32'))
    qnet = QNET[pkg](net, calib_data=calib, calib_mode='naive')
    assert _kinds(qnet) == ['QuantizedDense', 'QuantizedDense']
    x = m.nd.array(rs.uniform(-1, 1, (4, 20)).astype('float32'))
    ref = net(x).asnumpy()
    out = qnet(x).asnumpy()
    assert onp.abs(out - ref).max() < 0.25 * max(1.0, onp.abs(ref).max())
    assert all(type(c).__name__ == 'Dense' for c in net._children.values())


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_dynamic_mode(pkg):
    m = PKGS[pkg]
    rs = onp.random.RandomState(8)
    net = _mlp(m)
    qnet = QNET[pkg](net, calib_mode='none')
    x = m.nd.array(rs.uniform(-1, 1, (4, 20)).astype('float32'))
    ref, out = net(x).asnumpy(), qnet(x).asnumpy()
    assert onp.abs(out - ref).max() < 0.25 * max(1.0, onp.abs(ref).max())


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_entropy_and_hybridize(pkg):
    m = PKGS[pkg]
    rs = onp.random.RandomState(9)
    net = _mlp(m)
    calib = [m.nd.array(rs.uniform(-1, 1, (8, 20)).astype('float32'))
             for _ in range(3)]
    qnet = QNET[pkg](net, calib_data=calib, calib_mode='entropy',
                     num_bins=501)
    x = m.nd.array(rs.uniform(-1, 1, (4, 20)).astype('float32'))
    out_eager = qnet(x).asnumpy()
    qnet.hybridize()
    assert onp.allclose(out_eager, qnet(x).asnumpy(), atol=1e-5)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_conv_net(pkg):
    m = PKGS[pkg]
    rs = onp.random.RandomState(10)
    net = _convnet(m)
    calib = m.nd.array(rs.uniform(-1, 1, (4, 3, 8, 8)).astype('float32'))
    qnet = QNET[pkg](net, calib_data=calib, calib_mode='naive')
    assert _kinds(qnet) == ['QuantizedConv2D', 'QuantizedConv2D']
    x = m.nd.array(rs.uniform(-1, 1, (2, 3, 8, 8)).astype('float32'))
    ref, out = net(x).asnumpy(), qnet(x).asnumpy()
    assert onp.abs(out - ref).max() < 0.3 * max(1.0, onp.abs(ref).max())


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_exclude_layers(pkg):
    m = PKGS[pkg]
    net = _mlp(m)
    calib = m.nd.array(onp.random.RandomState(11).uniform(
        -1, 1, (8, 20)).astype('float32'))
    qnet = QNET[pkg](net, calib_data=calib, calib_mode='naive',
                     exclude_layers=['0'])
    assert _kinds(qnet) == ['Dense', 'QuantizedDense']


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantized_net_save_load_roundtrip(pkg, tmp_path):
    m = PKGS[pkg]
    rs = onp.random.RandomState(14)
    net = _mlp(m)
    calib = m.nd.array(rs.uniform(-1, 1, (16, 20)).astype('float32'))
    qnet = QNET[pkg](net, calib_data=calib, calib_mode='naive')
    x = m.nd.array(rs.uniform(-1, 1, (4, 20)).astype('float32'))
    ref = qnet(x).asnumpy()
    fname = str(tmp_path / 'qnet.params')
    qnet.save_parameters(fname)
    other = QNET[pkg](net, calib_data=m.nd.array(
        rs.uniform(-5, 5, (16, 20)).astype('float32')), calib_mode='naive')
    assert not onp.allclose(other(x).asnumpy(), ref)
    other.load_parameters(fname)
    assert onp.allclose(other(x).asnumpy(), ref, atol=1e-6)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_channel_wise_beats_tensor_wise(pkg):
    m = PKGS[pkg]
    rs = onp.random.RandomState(15)
    net = m.gluon.nn.HybridSequential()
    net.add(m.gluon.nn.Conv2D(8, kernel_size=3, padding=1, in_channels=3))
    net.initialize(m.init.Xavier())
    w = net._children['0'].weight.data().asnumpy().copy()
    w[0] *= 50.0
    net._children['0'].weight.set_data(m.nd.array(w))
    calib = m.nd.array(rs.uniform(-1, 1, (4, 3, 8, 8)).astype('float32'))
    x = m.nd.array(rs.uniform(-1, 1, (2, 3, 8, 8)).astype('float32'))
    ref = net(x).asnumpy()
    qt = QNET[pkg](net, calib_data=calib, calib_mode='naive')(x).asnumpy()
    qc = QNET[pkg](net, calib_data=calib, calib_mode='naive',
                   quantize_granularity='channel-wise')(x).asnumpy()
    err_t = onp.abs(qt - ref)[:, 1:].max()
    err_c = onp.abs(qc - ref)[:, 1:].max()
    assert err_c < err_t * 0.2, (err_t, err_c)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_rejects_bad_args(pkg):
    net = _mlp(PKGS[pkg])
    with pytest.raises(ValueError):
        QNET[pkg](net, calib_mode='none', quantize_granularity='block')
    with pytest.raises(TypeError):
        QNET[pkg](net, calib_mode='none', num_calib_batchs=3)
    with pytest.raises(ValueError):
        QNET[pkg](net, calib_mode='naive')
    with pytest.raises(ValueError):
        QNET[pkg](net, quantized_dtype='uint8', calib_mode='none')


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_quantize_net_inplace_fallback_clears_cached_op(pkg, monkeypatch):
    import types
    import importlib
    m = PKGS[pkg]
    qmod = importlib.import_module(f'{m.__name__}.contrib.quantization')
    rs = onp.random.RandomState(16)
    net = _mlp(m)
    net.hybridize()
    x = m.nd.array(rs.uniform(-1, 1, (4, 20)).astype('float32'))
    net(x)

    def boom(*a, **k):
        raise TypeError("not deepcopyable")
    monkeypatch.setattr(qmod, 'copy', types.SimpleNamespace(deepcopy=boom))
    qnet = QNET[pkg](net, calib_mode='none')
    assert qnet is net
    assert _kinds(qnet) == ['QuantizedDense', 'QuantizedDense']
    assert qnet(x).asnumpy().shape == (4, 10)


def _quantize_both(build, calib_np, x_np, **kw):
    """quantize_net of the same net in both packages: {pkg: (quantized
    params by structured name, output)}."""
    out, arrays = {}, None
    for pkg, m in PKGS.items():
        net = build(m, arrays)
        arrays = arrays or _arrays(net)
        calib = [m.nd.array(c) for c in calib_np] if calib_np is not None \
            else None
        qnet = QNET[pkg](net, calib_data=calib, **kw)
        out[pkg] = (_arrays(qnet), qnet(m.nd.array(x_np)).asnumpy())
    return out


@pytest.mark.parametrize('build, kw', [
    (_mlp, dict(calib_mode='naive')),
    (_mlp, dict(calib_mode='entropy', num_bins=501)),
    (_mlp, dict(calib_mode='none')),
    (_mlp, dict(calib_mode='naive', exclude_layers=['1'])),
    (_convnet, dict(calib_mode='naive')),
    (_convnet, dict(calib_mode='naive',
                    quantize_granularity='channel-wise')),
    (_convnet, dict(calib_mode='entropy', num_bins=501,
                    quantize_granularity='channel-wise'))],
    ids=['mlp-naive', 'mlp-entropy', 'mlp-none', 'mlp-exclude',
         'conv-naive', 'conv-channel-wise', 'conv-entropy-channel-wise'])
def test_both_packages_quantize_alike(build, kw):
    rs = onp.random.RandomState(21)
    shape = (20,) if build is _mlp else (3, 8, 8)
    calib = None if kw['calib_mode'] == 'none' else \
        [rs.uniform(-1, 1, (8,) + shape).astype('float32') for _ in range(2)]
    x = rs.uniform(-1, 1, (4,) + shape).astype('float32')
    out = _quantize_both(build, calib, x, **kw)
    (tp, ty), (jp, jy) = out['port'], out['jax']
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tp[k].dtype == v.dtype, k
        if k.endswith('.calib'):
            onp.testing.assert_allclose(tp[k], v, rtol=1e-6, err_msg=k)
        else:
            onp.testing.assert_array_equal(tp[k], v, err_msg=k)
    scale = max(float(onp.abs(jy).max()), 1e-30)
    assert onp.abs(ty - jy).max() <= 1e-5 * scale


def test_quantized_params_cross_between_the_packages(tmp_path):
    """A JAX-quantized net's Constants load into the port's quantized net
    by structured name and as a .params file, and the port's into the
    JAX package's, each giving the exporter's output."""
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    rs = onp.random.RandomState(22)
    calib = rs.uniform(-1, 1, (16, 3, 8, 8)).astype('float32')
    x = rs.uniform(-1, 1, (2, 3, 8, 8)).astype('float32')
    jnet = _convnet(jmx)
    arrays = _arrays(jnet)
    jq = jquantize(jnet, calib_data=jmx.nd.array(calib), calib_mode='naive',
                   quantize_granularity='channel-wise')
    want = jq(jmx.nd.array(x)).asnumpy()
    tnet = _convnet(mx, arrays)

    def fresh():
        return quantize_net(tnet, calib_data=mx.nd.array(calib * 3),
                            calib_mode='naive',
                            quantize_granularity='channel-wise')
    by_name = fresh()
    by_name.load_state_dict(params_from_mxnet_tpu(_arrays(jq), by_name))
    assert by_name._children['0'].weight.data().dtype == onp.int8
    onp.testing.assert_array_equal(by_name(mx.nd.array(x)).asnumpy(), want)
    jfile = str(tmp_path / 'j.params')
    jq.save_parameters(jfile)
    from_file = fresh()
    from_file.load_parameters(jfile)
    onp.testing.assert_array_equal(from_file(mx.nd.array(x)).asnumpy(),
                                   want)
    tfile = str(tmp_path / 't.params')
    from_file.save_parameters(tfile)
    back = jquantize(jnet, calib_data=jmx.nd.array(calib * 3),
                     calib_mode='naive', quantize_granularity='channel-wise')
    back.load_parameters(tfile)
    onp.testing.assert_array_equal(back(jmx.nd.array(x)).asnumpy(), want)


def test_quantize_model_is_quantize_net():
    net = _mlp(mx)
    q = quantize_model(net, calib_mode='none')
    assert _kinds(q) == ['QuantizedDense', 'QuantizedDense']
    assert 'int8' in repr(q._children['0'])
