"""The port's flash-attention tile autotuner (``mxnet_tpu_torch/ops/
autotune.py``) against the JAX package's (``tests/test_autotune.py``
mirrored, with Hopper rules in place of Mosaic's): static legality, the
tuning-DB round trip through ``_block_sizes``, the precedence ladder and
its clamps, the analytic CPU sweep and the compile-ledger signature, one
DB read by both packages with entries kept apart by device kind, the
remat parser, and the step's signature.

On the CPU the register rule (spills) is unchecked and the sweep ranks
analytically; the measured sweep and every built tile run on the card
(``tests/test_torch_tiles_cuda.py``). JAX runs on the CPU.
"""
import json
import os
import re
import warnings

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu import config as jconfig
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.ops import autotune as jat
from mxnet_tpu_torch import config, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import autotune
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops.flash_attention import _block_sizes
from test_torch_jax_globals import jax_globals  # noqa: F401

KNOBS = ('MXTPU_AUTOTUNE_DIR', 'MXTPU_FA_G', 'MXTPU_FA_BQ', 'MXTPU_FA_BK',
         'MXTPU_FA_BWD_G', 'MXTPU_FA_BWD_BQ', 'MXTPU_FA_BWD_BK',
         'MXTPU_REMAT')
CSRC = os.path.join(os.path.dirname(fa.__file__), os.pardir, 'csrc')
BF16 = torch.bfloat16
FA = autotune.KERNEL_FA


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No env overrides, no DB directory, clean decisions in both
    packages."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    autotune.clear()
    jat.clear()
    yield
    autotune.clear()
    jat.clear()


# ---------------------------------------------------------------------------
# API, tables, legality
# ---------------------------------------------------------------------------

def test_api_is_the_jax_modules_with_shared_memory_for_vmem():
    want = [n if n != 'vmem_bytes' else 'smem_bytes' for n in jat.__all__]
    assert autotune.__all__ == want
    assert (autotune.DB_BASENAME, autotune.DB_VERSION, autotune.KERNEL_FA) \
        == (jat.DB_BASENAME, jat.DB_VERSION, jat.KERNEL_FA)
    for dt, jdt in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        for kind in ('fwd', 'bwd'):
            assert autotune.shape_sig(96, 512, 500, 64, dt, kind) == \
                jat.shape_sig(96, 512, 500, 64, jnp.dtype(jdt), kind)


def _source_tiles(name, macro):
    text = open(os.path.join(CSRC, name)).read()
    block = re.search(r'#define ' + macro + r'((?:.*\\\n)*.*)', text).group(1)
    return {(int(d), int(q), int(k)) for d, q, k in
            re.findall(r'MXTT_TILE\((\d+), (\d+), (\d+)\)', block)}


@pytest.mark.parametrize('kernel,default_src,tiles_src,macro', [
    ('fwd', 'flash_attn_fwd.cu', 'flash_attn_fwd_tiles.cu', 'MXTT_FWD_TILES'),
    ('dq', 'flash_attn_bwd.cu', 'flash_attn_dq_tiles.cu', 'MXTT_DQ_TILES'),
    ('dkv', 'flash_attn_bwd.cu', 'flash_attn_dkv_tiles.cu',
     'MXTT_DKV_TILES')])
def test_tile_table_is_what_the_sources_build(kernel, default_src, tiles_src,
                                              macro):
    """flash_attention.TILES lists exactly the instantiations the CUDA
    sources make; the default tile is built for every tensor-core head
    dim, in the default library, and nowhere else."""
    default = _source_tiles(default_src, macro)
    others = _source_tiles(tiles_src, macro)
    assert default == {(D,) + fa.DEFAULT_TILE for D in fa.TC_HEAD_DIMS}
    assert not default & others
    table = {(D,) + t for t, ds in fa.TILES[kernel].items() for D in ds}
    assert default | others == table


def test_legality_rules_prune_with_named_reasons():
    BH, T = 96, 512
    cases = [((4, 64, 64), 'G=4'),
             ((1, 24, 64), 'multiple of the 16-row'),
             ((1, 1024, 64), 'threads'),
             ((1, 512, 512), 'shared memory'),
             ((1, 32, 32), 'not built')]
    for blocks, why in cases:
        ok, reason = autotune.check_candidate(BH, T, T, 128, BF16, 'fwd',
                                              *blocks)
        assert not ok and why in reason, (blocks, reason)
    # one backward tile must be built for dq AND dk/dv
    ok, reason = autotune.check_candidate(BH, T, T, 64, BF16, 'bwd', 1, 64,
                                          32)
    assert not ok and 'dq' in reason
    cands, pruned = autotune.legal_candidates(BH, T, T, 64, BF16, 'fwd')
    assert cands and pruned > 0


def test_legal_candidates_are_self_consistent():
    for dtype in (torch.float32, BF16, torch.float16):
        for D in (8, 64, 128):
            for kind in ('fwd', 'bwd'):
                cands, _ = autotune.legal_candidates(12, 512, 512, D, dtype,
                                                     kind)
                assert cands, (dtype, D, kind)
                for G, bq, bk in cands:
                    ok, why = autotune.check_candidate(
                        12, 512, 512, D, dtype, kind, G, bq, bk)
                    assert ok, (dtype, kind, G, bq, bk, why)
                    assert autotune.smem_bytes(G, bq, bk, D, kind,
                                               dtype.itemsize) \
                        <= autotune.SMEM_BUDGET


@pytest.mark.parametrize('dtype', [BF16, torch.float16])
def test_16_bit_tiles_against_f32_candidates(dtype):
    """The tensor-core tiles (16-row fragments) against the f32 SIMT
    kernel's one tile; the JAX rule's sublane minimum grows the other way
    (8 for f32, 16 for bf16), both named by sublane_min."""
    assert autotune.sublane_min(dtype) == 16
    assert autotune.sublane_min(torch.float32) == 64
    assert jat.sublane_min(jnp.dtype('float32')) == 8
    f32, _ = autotune.legal_candidates(96, 512, 512, 64, torch.float32, 'fwd')
    half, _ = autotune.legal_candidates(96, 512, 512, 64, dtype, 'fwd')
    bwd, _ = autotune.legal_candidates(96, 512, 512, 64, dtype, 'bwd')
    assert f32 == [(1,) + fa.DEFAULT_TILE]
    assert set(half) == {(1,) + t for t in fa.TILES['fwd']}
    assert set(bwd) == {(1,) + t for t in fa.TILES['dq']}
    # head dims outside the tensor-core set have the SIMT kernel's one tile
    only, _ = autotune.legal_candidates(96, 512, 512, 8, dtype, 'fwd')
    assert only == [(1,) + fa.DEFAULT_TILE]


def test_smem_bytes_is_the_launchers_formula():
    """The shared-memory figure the launchers opt into, read from the
    sources' constexpr formulas."""
    for D in (64, 128):
        ld = D + 8
        assert autotune.smem_bytes(1, 64, 64, D, 'fwd') == \
            2 * (64 * ld + 4 * 64 * ld) + 4 * 2 * 64
        dq = 2 * (2 * 128 * ld + 4 * 64 * ld) + 4 * (2 * 64 + 2 * 128)
        dkv = 2 * (2 * 64 * ld + 4 * 128 * ld) + 4 * 4 * 128
        assert autotune.smem_bytes(1, 128, 64, D, 'bwd') == max(dq, dkv)
    for name, form in (('flash_fwd_tc.cuh', 'sizeof(E) * (BQ * (D + 8) + '
                        '4 * BK * (D + 8)) + sizeof(float) * 2 * BK'),
                       ('flash_bwd_tc.cuh', 'sizeof(E) * (2 * BK * (D + 8) '
                        '+ 4 * BQ * (D + 8)) + sizeof(float) * 4 * BQ'),
                       ('flash_bwd_tc.cuh', 'sizeof(E) * (2 * BQ * (D + 8) '
                        '+ 4 * BK * (D + 8)) + sizeof(float) * (2 * BK + '
                        '2 * BQ)')):
        assert form in open(os.path.join(CSRC, name)).read()


def test_analytic_cost_counts_bytes_and_waves():
    """Bigger q tiles stream K and V fewer times; a shape whose blocks
    fill a wave costs no more per byte than one that leaves it ragged."""
    big = autotune.analytic_cost(96, 512, 512, 64, BF16, 'fwd', 1, 128, 64)
    small = autotune.analytic_cost(96, 512, 512, 64, BF16, 'fwd', 1, 64, 64)
    assert big < small
    # 132 blocks fill one wave exactly; 133 need two
    one = autotune.analytic_cost(132, 64, 64, 64, BF16, 'fwd', 1, 64, 64)
    two = autotune.analytic_cost(133, 64, 64, 64, BF16, 'fwd', 1, 64, 64)
    assert two > 1.9 * one


# ---------------------------------------------------------------------------
# tuning DB: round trip, corruption, precedence, clamps
# ---------------------------------------------------------------------------

def test_defaults_are_the_kernels_tile():
    """Nothing set: every launch resolves to (1, 64, 64), the tile the
    kernels always had, source 'default'."""
    for dtype in (torch.float32, BF16, torch.float16):
        for kind in ('fwd', 'bwd'):
            assert _block_sizes(96, 512, 512, 64, dtype, kind) == (1, 64, 64)
    assert set(autotune.decision_flags().values()) == {'default:1x64x64'}


def test_db_round_trip_through_block_sizes(tmp_path, monkeypatch):
    sig = autotune.shape_sig(4, 64, 64, 64, BF16, 'fwd')
    path = autotune.record_winner(FA, sig, (1, 128, 32),
                                  {'source': 'measured'}, dir_=str(tmp_path))
    doc = json.loads(open(path).read())
    assert doc['version'] == autotune.DB_VERSION
    assert doc['entries'] == {f'cpu/{FA}/{sig}': {
        'blocks': [1, 128, 32], 'source': 'measured'}}
    monkeypatch.setenv('MXTPU_AUTOTUNE_DIR', str(tmp_path))
    autotune.clear()
    assert _block_sizes(4, 64, 64, 64, BF16, 'fwd') == (1, 128, 32)
    assert autotune.decision_flags() == {f'{FA}:{sig}': 'db:1x128x32'}
    # an unknown shape falls through to the default
    assert _block_sizes(4, 128, 128, 64, BF16, 'fwd') == (1, 64, 64)
    other = autotune.shape_sig(4, 128, 128, 64, BF16, 'fwd')
    assert autotune.decisions()[f'{FA}:{other}']['source'] == 'default'


def test_corrupt_db_falls_back_with_one_warning(tmp_path, monkeypatch):
    (tmp_path / autotune.DB_BASENAME).write_text('{"version": 1, "entries": {')
    monkeypatch.setenv('MXTPU_AUTOTUNE_DIR', str(tmp_path))
    autotune.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        first = _block_sizes(4, 64, 64, 64, BF16, 'fwd')
        second = _block_sizes(4, 64, 64, 64, BF16, 'bwd')
    assert first == second == (1, 64, 64)
    corrupt = [x for x in w if issubclass(x.category, RuntimeWarning)
               and 'corrupt or truncated' in str(x.message)]
    assert len(corrupt) == 1, [str(x.message) for x in w]


def test_env_override_beats_db(tmp_path, monkeypatch):
    sig = autotune.shape_sig(4, 64, 64, 64, BF16, 'fwd')
    autotune.record_winner(FA, sig, (1, 64, 128), dir_=str(tmp_path))
    monkeypatch.setenv('MXTPU_AUTOTUNE_DIR', str(tmp_path))
    monkeypatch.setenv('MXTPU_FA_BQ', '128')
    autotune.clear()
    assert _block_sizes(4, 64, 64, 64, BF16, 'fwd') == (1, 128, 128)
    assert autotune.decision_flags()[f'{FA}:{sig}'] == 'env:1x128x128'
    # 0 means unset: back to the DB winner
    monkeypatch.setenv('MXTPU_FA_BQ', '0')
    autotune.clear()
    assert _block_sizes(4, 64, 64, 64, BF16, 'fwd') == (1, 64, 128)
    # the backward knobs are separate
    monkeypatch.setenv('MXTPU_FA_BWD_BK', '128')
    assert _block_sizes(4, 64, 64, 64, BF16, 'bwd') == (1, 64, 128)
    assert _block_sizes(4, 64, 64, 64, BF16, 'fwd') == (1, 64, 128)


def test_illegal_group_clamps_to_one_and_unbuilt_tiles_to_default(
        monkeypatch):
    """An env G clamps to 1 (JAX clamps it to a divisor of BH); a tile that
    is not built for the shape clamps to the default; each clamp is
    recorded beside the decision."""
    monkeypatch.setenv('MXTPU_FA_G', '4')
    got = autotune.resolve(FA, 6, 64, 64, 64, BF16, 'fwd', (1, 64, 64))
    assert got == (1, 64, 64)
    sig = autotune.shape_sig(6, 64, 64, 64, BF16, 'fwd')
    d = autotune.decisions()[f'{FA}:{sig}']
    assert d['source'] == 'env' and d['clamps'] == ['G=4 -> 1']
    jgot = jat.resolve(jat.KERNEL_FA, 6, 64, 64, 64, jnp.dtype('float32'),
                       'fwd', default=(4, 64, 64))
    assert 6 % jgot[0] == 0
    monkeypatch.delenv('MXTPU_FA_G')
    monkeypatch.setenv('MXTPU_FA_BQ', '32')
    assert _block_sizes(6, 64, 64, 32, BF16, 'fwd') == (1, 64, 64)
    sig = autotune.shape_sig(6, 64, 64, 32, BF16, 'fwd')
    clamp, = autotune.decisions()[f'{FA}:{sig}']['clamps']
    assert clamp.startswith('(32, 64) -> (64, 64)') and 'not built' in clamp
    # f32 has the SIMT kernel's one tile
    monkeypatch.setenv('MXTPU_FA_BQ', '128')
    assert _block_sizes(6, 64, 64, 64, torch.float32, 'fwd') == (1, 64, 64)


def test_forced_blocks_win_and_are_clamped_too(monkeypatch):
    monkeypatch.setenv('MXTPU_FA_BQ', '128')
    with autotune.forced(FA, 'fwd', (1, 64, 32)):
        assert _block_sizes(8, 64, 64, 128, BF16, 'fwd') == (1, 64, 32)
        with autotune.forced(FA, 'fwd', (2, 48, 32)):
            assert _block_sizes(8, 64, 64, 128, BF16, 'fwd') == (1, 64, 64)
        assert _block_sizes(8, 64, 64, 128, BF16, 'fwd') == (1, 64, 32)
    assert _block_sizes(8, 64, 64, 128, BF16, 'fwd') == (1, 128, 64)


# ---------------------------------------------------------------------------
# CPU sweep -> DB -> ledger signature
# ---------------------------------------------------------------------------

def test_cpu_sweep_writes_db_and_ledger_names_the_source(tmp_path,
                                                         monkeypatch):
    from mxnet_tpu_torch.telemetry import compile as _compile
    rep = autotune.sweep_flash_attention(batch=1, heads=4, seq=64,
                                         head_dim=64, dtype=BF16,
                                         db_dir=str(tmp_path))
    assert rep['mode'] == 'analytic' and rep['device_kind'] == 'cpu'
    for kind in ('fwd', 'bwd'):
        r = rep[kind]
        assert r['winner'] and r['source'] == 'analytic'
        assert r['pruned'] > 0 and r['pruned_reasons']
        assert r['registers'] == {'checked': False, 'pruned': {}}
        costs = [x['analytic_ms'] for x in r['ranking']]
        assert costs == sorted(costs) and r['winner'] == \
            r['ranking'][0]['blocks']
    monkeypatch.setenv('MXTPU_AUTOTUNE_DIR', str(tmp_path))
    autotune.clear()
    ledger = tmp_path / 'ledger.jsonl'
    _compile.enable()
    _compile.clear(ledger=str(ledger))
    try:
        ctx = _compile.begin('step:train_step')
        q = torch.from_numpy(onp.random.RandomState(0).randn(
            1, 4, 64, 64).astype('float32')).to(BF16).requires_grad_()
        fa.flash_attention(q, q, q).float().sum().backward()
        flags = autotune.decision_flags()
        assert sorted(flags.values()) == sorted(
            f"db:{'x'.join(map(str, rep[k]['winner']))}"
            for k in ('fwd', 'bwd')), flags
        _compile.set_signature(ctx, _compile.signature(
            args=[], flags={'autotune': flags}))
        _compile.end(ctx)
    finally:
        _compile.clear()
        _compile.disable()
    entries = [json.loads(x) for x in ledger.read_text().splitlines()]
    e = [x for x in entries if x.get('site') == 'step:train_step'][0]
    enc = json.dumps(e['signature'])
    assert 'db:' in enc and 'flash_attention' in enc


def test_one_db_serves_both_packages_apart_by_device_kind(tmp_path,
                                                          monkeypatch):
    """The JAX package's record_winner and the port's write one file; each
    package's load_db reads every entry, and each lookup takes only its
    own device kind's, so a TPU's winner is never applied on the card."""
    d = str(tmp_path)
    sig = jat.shape_sig(96, 512, 512, 64, jnp.dtype(jnp.bfloat16), 'fwd')
    monkeypatch.setattr(jat, 'device_kind', lambda: 'TPU_v5_lite')
    jat.record_winner(jat.KERNEL_FA, sig, (4, 256, 512), {'source': 'x'},
                      dir_=d)
    monkeypatch.setattr(autotune, 'device_kind',
                        lambda: 'NVIDIA_H100_80GB_HBM3')
    autotune.record_winner(FA, sig, (1, 128, 64), {'source': 'measured'},
                           dir_=d)
    path = os.path.join(d, autotune.DB_BASENAME)
    port_doc, jax_doc = autotune.load_db(path), jat.load_db(path)
    assert port_doc == jax_doc and set(port_doc['entries']) == {
        f'TPU_v5_lite/{FA}/{sig}', f'NVIDIA_H100_80GB_HBM3/{FA}/{sig}'}
    assert autotune.db_lookup(FA, sig, dir_=d) == (1, 128, 64)
    assert jat.db_lookup(jat.KERNEL_FA, sig, dir_=d) == (4, 256, 512)
    monkeypatch.setattr(autotune, 'device_kind', lambda: 'cpu')
    assert autotune.db_lookup(FA, sig, dir_=d) is None


# ---------------------------------------------------------------------------
# remat policy and the step's signature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('raw,want', [
    (None, 'none'), ('', 'none'), ('off', 'none'), ('0', 'none'),
    ('layer', 'layer'), ('1', 'layer'), ('on', 'layer'),
    ('aggressive', 'aggressive'), ('full', 'aggressive'), ('2', 'aggressive'),
    ('bogus', None)])
def test_remat_policy_parser_is_the_jax_packages(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv('MXTPU_REMAT', raising=False)
    else:
        monkeypatch.setenv('MXTPU_REMAT', raw)
    if want is None:
        with pytest.raises(MXNetError, match='MXTPU_REMAT'):
            config.get('MXTPU_REMAT')
        with pytest.raises(JMXNetError):
            jconfig.get('MXTPU_REMAT')
        return
    assert config.get('MXTPU_REMAT') == jconfig.get('MXTPU_REMAT') == want


def test_tile_knobs_are_the_jax_packages():
    for k in KNOBS[:-1] + ('MXTPU_AUTOTUNE_REPS',):
        assert config.get(k) == jconfig.get(k), k


def test_remat_policy_and_tiles_land_in_step_signature(monkeypatch):
    from mxnet_tpu_torch.gluon import nn
    monkeypatch.setenv('MXTPU_REMAT', 'aggressive')
    net = nn.Dense(4, in_units=3, device='cpu')
    step = parallel.ShardedTrainStep(net, lambda o, y: ((o - y) ** 2).sum(),
                                     'adam',
                                     mesh=parallel.make_mesh(devices=['cpu']))
    x, y = torch.ones(2, 3), torch.zeros(2, 4)
    step(x, y)
    sig = step.signature([x], [y])
    assert sig['flags']['remat'] == 'aggressive'
    assert sig['flags']['zero'] == 'off' and 'autotune' in sig['flags']
    assert sig['flags']['autotune'] is None
    q = torch.zeros(1, 2, 16, 16, dtype=BF16)
    fa.flash_attention_forward(q, q, q)
    flags = step.signature([x], [y])['flags']['autotune']
    assert flags == {f"{FA}:{autotune.shape_sig(2, 16, 16, 16, BF16, 'fwd')}":
                     'default:1x64x64'}
