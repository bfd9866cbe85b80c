"""The flash-attention kernels at every built tile, on the card, and the
compiled step's memory knobs there.

``flash_attention.TILES`` lists the tensor-core tiles built for the
forward, dq and dk/dv kernels (``csrc/flash_fwd_tc.cuh``,
``csrc/flash_bwd_tc.cuh``); each is held against the plain version at a
ragged shape, through the autotuner's ``forced`` seam, and the launch
counts show the tile it ran at. A tile that is not built raises; the
register and spill query answers for every built one; a measured sweep
writes a DB that a fresh resolve reads. ``MXTPU_REMAT`` 'layer' and
'aggressive' replay the captured step with dropout on, and match 'none'
within the capture-vs-eager bound (PERF.md section 2).

These tests need a CUDA device and carry the ``cuda`` marker; without a
card they skip. On the card, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_tiles_cuda.py
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build, autotune
from mxnet_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# kernel vs plain version on the same inputs (PERF.md section 2)
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2),
       torch.float16: dict(atol=2e-3, rtol=2e-3)}
FWD = [(dt, D, t) for dt in TOL for t, ds in sorted(fa.TILES['fwd'].items())
       for D in ds]
BWD = [(dt, D, t) for dt in TOL for t, ds in sorted(fa.TILES['dq'].items())
       for D in ds]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    autotune.clear()
    yield torch.Generator(device='cuda').manual_seed(0)
    autotune.clear()


def _inputs(gen, dtype, D, B=2, H=3, T=200):
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen, device='cuda')
                   .to(dtype) for _ in range(4))
    m = torch.zeros(B, T, device='cuda')
    m[0, 150:] = -1e30
    return q, k, v, do, m


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('dtype,D,tile', FWD)
def test_forward_at_each_built_tile(gen, dtype, D, tile, causal):
    q, k, v, _, m = _inputs(gen, dtype, D)
    _build.reset_launch_counts()
    with autotune.forced(autotune.KERNEL_FA, 'fwd', (1,) + tile):
        out, lse = fa.flash_attention_forward(q, k, v, key_mask=m,
                                              causal=causal, dropout_p=0.1,
                                              dropout_seed=11)
    torch.cuda.synchronize()
    assert _build.tile_counts == {f'flash_attn_fwd.{tile[0]}x{tile[1]}': 1}
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, m, causal, 0.1,
                                                    11)
    torch.testing.assert_close(out, ref_out, **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('dtype,D,tile', BWD)
def test_backward_at_each_built_tile(gen, dtype, D, tile, causal):
    q, k, v, do, m = _inputs(gen, dtype, D)
    out, lse = fa.flash_attention_reference(q, k, v, m, causal, 0.1, 11)
    _build.reset_launch_counts()
    with autotune.forced(autotune.KERNEL_FA, 'bwd', (1,) + tile):
        got = fa.flash_attention_backward(q, k, v, m, causal, 0.1, 11, out,
                                          lse, do)
    torch.cuda.synchronize()
    t = f'{tile[0]}x{tile[1]}'
    assert _build.tile_counts == {f'flash_attn_bwd_dq.{t}': 1,
                                  f'flash_attn_bwd_dkv.{t}': 1}
    want = fa.flash_attention_backward_reference(q, k, v, m, causal, 0.1, 11,
                                                 out, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL[dtype])


def test_a_tile_that_is_not_built_raises(gen):
    q, k, v, _, m = _inputs(gen, torch.bfloat16, 32)
    km, div = m.contiguous(), 3
    with pytest.raises(MXNetError, match='not built'):
        fa._launch(q, k, v, km, div, False, 0.0, None, tile=(128, 128))
    with pytest.raises(MXNetError, match='not built'):
        fa._launch(q, k, v, km, div, False, 0.0, None, tile=(32, 32))
    # the SIMT kernel has its one tile
    q32, k32, v32 = (t.float() for t in (q, k, v))
    with pytest.raises(MXNetError, match='SIMT'):
        fa._launch(q32, k32, v32, km, div, False, 0.0, None, tile=(128, 64))


def test_every_built_tile_answers_the_register_query(gen):
    for kernel in ('fwd', 'dq', 'dkv'):
        for tile, ds in fa.TILES[kernel].items():
            for D in ds:
                for dt in TOL:
                    a = fa.tile_attributes(kernel, dt, D, tile)
                    assert 0 < a['registers'] <= 255, (kernel, tile, D, a)
                    threads = 2 * (tile[1] if kernel == 'dkv' else tile[0])
                    assert a['max_threads'] >= threads, (kernel, tile, D, a)


def test_measured_sweep_writes_a_db_that_resolve_reads(gen, tmp_path,
                                                       monkeypatch):
    rep = autotune.sweep_flash_attention(
        batch=2, heads=4, seq=256, head_dim=64, dtype=torch.bfloat16,
        reps=3, db_dir=str(tmp_path))
    assert rep['mode'] == 'measured'
    for kind in ('fwd', 'bwd'):
        r = rep[kind]
        assert r['registers']['checked'] and r['source'] == 'measured'
        timed = [x for x in r['ranking'] if 'median_ms' in x]
        assert timed and not [x for x in r['ranking'] if 'error' in x]
    monkeypatch.setenv('MXTPU_AUTOTUNE_DIR', str(tmp_path))
    autotune.clear()
    G, bq, bk = fa._block_sizes(8, 256, 256, 64, torch.bfloat16, 'fwd')
    assert [G, bq, bk] == rep['fwd']['winner']
    key = f"{autotune.KERNEL_FA}:{rep['fwd']['signature']}"
    assert autotune.decisions()[key]['source'] == 'db'


def _bert_step(policy, monkeypatch, seed=0):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models.bert import BertForPretraining, \
        bert_pretrain_loss
    monkeypatch.setenv('MXTPU_REMAT', policy)
    cfg = dict(vocab_size=128, hidden=128, layers=2, heads=2,
               intermediate=256, max_len=128, type_vocab=2, dropout=0.1)
    g = torch.Generator('cuda').manual_seed(1)
    ga = torch.Generator('cuda').manual_seed(2)
    net = BertForPretraining(cfg, device='cuda', dtype=torch.bfloat16,
                             generator=g, attn_generator=ga)
    rng = onp.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(net.named_parameters()):
            p.copy_(torch.from_numpy(
                rng.randn(*p.shape).astype('float32') * 0.02))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-3})
    B, T, M = 4, 128, 8
    batch = ([torch.from_numpy(rng.randint(0, 128, (B, T))).cuda(),
              torch.zeros(B, T, dtype=torch.int64, device='cuda'),
              torch.tensor([128., 100., 64., 90.], device='cuda'),
              torch.from_numpy(rng.randint(0, T, (B, M))).cuda()],
             [torch.from_numpy(rng.randint(0, 128, (B, M))).cuda(),
              torch.from_numpy(rng.randint(0, 2, (B,))).cuda()])
    losses = [float(step(*batch)) for _ in range(4)]
    # a second input signature: its own graph, captured after its own
    # eager step (the recompute's generator offsets depend on the shapes)
    half = tuple([t[:2] for t in part] for part in batch)
    losses += [float(step(*half)) for _ in range(3)]
    return losses, {n: p.detach().float().clone()
                    for n, p in net.named_parameters()}


def test_remat_policies_replay_like_none_on_the_card(gen, monkeypatch):
    """The eager first step and 3 replays with dropout 0.1, then a second
    input signature's eager step and 2 replays: the generators replayed
    through their graph twins, so each layer's recompute draws the
    forward's masks and seeds (capture vs eager bound)."""
    base, wb = _bert_step('none', monkeypatch)
    for policy in ('layer', 'aggressive'):
        got, wg = _bert_step(policy, monkeypatch)
        for a, b in zip(got, base):
            assert abs(a - b) <= 1e-5 * abs(b), (policy, got, base)
        for n in wb:
            assert float((wg[n] - wb[n]).abs().max()) <= 1e-4, (policy, n)
