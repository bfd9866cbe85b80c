"""The port stands alone: no module of ``mxnet_tpu_torch`` (nor
``chip_smoke.py``) imports jax, jaxlib or ``mxnet_tpu``, and its entry
points raise instead of running on the CPU when asked for a card that is
not there. Whether a card is present is decided inside each test."""
import ast
import glob
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import resolve_device
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models.bert import BertForPretraining, BertModel
from mxnet_tpu_torch.ops import fused_ffn, fused_layernorm
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.weights import params_from_mxnet_tpu

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
FORBIDDEN = {'jax', 'jaxlib', 'mxnet_tpu'}
SMALL = dict(vocab_size=32, hidden=16, layers=1, heads=2, intermediate=32,
             max_len=16)


def _port_files():
    files = glob.glob(os.path.join(ROOT, 'mxnet_tpu_torch', '**', '*.py'),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, 'chip_smoke.py')]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, 'attr', getattr(node.func, 'id', None)) \
                in ('import_module', '__import__'):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[-1])
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            # whole top-level names: 'mxnet_tpu_torch' is not 'mxnet_tpu'
            if mod.split('.')[0] in FORBIDDEN:
                bad.append(f'{os.path.relpath(path, ROOT)}: {mod}')
    assert not bad, bad


def test_forbidden_name_check_is_not_a_prefix_check():
    assert 'mxnet_tpu_torch'.split('.')[0] not in FORBIDDEN
    assert 'mxnet_tpu.ops'.split('.')[0] in FORBIDDEN


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: nothing to refuse')


@pytest.mark.parametrize('device', [None, 'cuda', 'cuda:0'])
def test_entry_points_refuse_a_missing_card(device):
    _require_no_card()
    with pytest.raises(MXNetError, match='no CUDA device'):
        resolve_device(device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        BertModel(**SMALL, device=device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        BertForPretraining(SMALL, device=device)
    with pytest.raises(MXNetError, match='no CUDA device'):
        nn.Dense(4, in_units=4, device=device)
    cpu_net = BertModel(**SMALL, device='cpu')
    with pytest.raises(MXNetError, match='no CUDA device'):
        mt.serving.BlockRunner(cpu_net, device=device)


def test_weights_follow_the_module_device():
    net = BertModel(**SMALL, device='cpu')
    arrays = {k: onp.zeros(tuple(p.shape), 'float32')
              for k, p in net.named_parameters()}
    out = params_from_mxnet_tpu(arrays, net)
    assert {t.device.type for t in out.values()} == {'cpu'}


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper runs its plain version, and only because
    the tensor lies on the CPU; the launch counters stay at zero."""
    mt.ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 5, 8, generator=g) for _ in range(3))
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_reference(q, k, v)[0])
    x, r = torch.randn(3, 16, generator=g), torch.randn(3, 16, generator=g)
    gm, bt = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(
        fused_layernorm.fused_add_layer_norm(x, r, gm, bt),
        fused_layernorm.add_layer_norm_reference(x, r, gm, bt))
    w, b = torch.randn(6, 16, generator=g), torch.randn(6, generator=g)
    torch.testing.assert_close(fused_ffn.fused_dense_gelu(x, w, b),
                               fused_ffn.dense_gelu_reference(x, w, b))
    assert set(mt.ops.launch_counts.values()) == {0}


def test_importing_the_port_builds_nothing():
    from mxnet_tpu_torch.ops import _build
    assert _build.SOURCES and all(
        os.path.exists(os.path.join(_build.CSRC_DIR, s))
        for s in _build.SOURCES)
    assert not _build._libs


def test_dropout_draws_on_the_tensors_device():
    """A generator on another device than the tensor raises instead of
    drawing on the host and copying; in eval mode nothing is drawn."""
    drop = nn.Dropout(0.5, generator=torch.Generator())
    x = torch.ones(4, 8, device='meta')
    assert drop.eval()(x) is x
    with pytest.raises(MXNetError, match="tensor's device"):
        drop.train()(x)
    y = drop(torch.ones(64, 64))
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0))
    assert 0.4 < kept.float().mean().item() < 0.6
