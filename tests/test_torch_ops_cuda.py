"""The port's op surface on the card: every registered op on CUDA tensors
against the same op on the CPU, and every sampler on the card against
its law, by mxnet_tpu_torch/_op_checks.py's rules, as chip_smoke.py's
``ops`` phase (a) does; the int8 product exact and equal to
torch._int_mm; and a hybridized block that draws giving fresh numbers on
every replay of its CUDA graph.

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout (the file
imports only torch, numpy, scipy and the port):

    python -m pytest --noconftest -m cuda tests/test_torch_ops_cuda.py

f32 within rel 1e-4 of the output's scale (bf16/f16 1e-2), integer,
bool and int32 outputs exactly, TF32 off.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _op_checks as K
from mxnet_tpu_torch.base import get_op, list_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield


@pytest.mark.parametrize('op', list_ops())
def test_op_on_the_card_matches_the_cpu(op):
    err, fault = K.compare_on_device(op, 'cuda', seed=5)
    assert fault is None, f'{op}: {fault}'


@pytest.mark.parametrize('op', sorted(K.LAWS))
def test_sampler_on_the_card_follows_its_law(op):
    z, p, fault = K.law_check(op, 'cuda')
    assert fault is None, f'{op}: {fault}'


def test_int8_product_is_exact_and_equals_int_mm():
    g = torch.Generator('cuda').manual_seed(3)
    a = torch.randint(-127, 128, (64, 8192), generator=g, device='cuda',
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (32, 8192), generator=g, device='cuda',
                      dtype=torch.int32).to(torch.int8)
    a[0] = 127
    w[0] = 127
    out = get_op('quantized_fully_connected').fn(
        a, w, min_data=-1.0, max_data=1.0, min_weight=-1.0, max_weight=1.0,
        no_bias=True)[0]
    assert out.dtype == torch.int32 and int(out[0, 0]) == 127 * 127 * 8192
    assert torch.equal(out, torch._int_mm(a, w.t().contiguous()))
    cpu = get_op('quantized_fully_connected').fn(
        a.cpu(), w.cpu(), min_data=-1.0, max_data=1.0, min_weight=-1.0,
        max_weight=1.0, no_bias=True)[0]
    assert torch.equal(out.cpu(), cpu)


def test_replays_of_a_block_that_draws_give_fresh_numbers():
    from mxnet_tpu_torch import gluon

    class Noisy(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random_normal_like(x) + F.random_uniform_like(x)

    net = Noisy()
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = mx.nd.zeros((4, 8), ctx=mx.gpu(0))
    draws = [net(x).asnumpy() for _ in range(4)]
    for a, b in zip(draws, draws[1:]):
        assert not onp.array_equal(a, b)
    mx.random.seed(9)
    first = net(x).asnumpy()
    mx.random.seed(9)
    again = net(x).asnumpy()
    assert onp.isfinite(first).all() and onp.isfinite(again).all()


def test_update_with_out_on_the_card():
    w = mx.nd.ones((1024,), ctx=mx.gpu(0))
    g = mx.nd.ones((1024,), ctx=mx.gpu(0))
    m, v = mx.nd.zeros((1024,), ctx=mx.gpu(0)), mx.nd.zeros(
        (1024,), ctx=mx.gpu(0))
    out = mx.nd.adamw_update(w, g, m, v, out=w, lr=0.1)
    assert out is w and w._data.is_cuda
    assert float(m.asnumpy()[0]) == pytest.approx(0.1)
    assert float(w.asnumpy()[0]) < 1.0
