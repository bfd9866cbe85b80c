"""The port's ``checkpoint.CheckpointManager`` (mirrors tests/test_checkpoint.py)
and checkpoints across the two packages.

Every case of tests/test_checkpoint.py whose code is ported runs here on
the port, on the CPU: the crash-consistency contract (a kill -9 between
the array writes and the manifest commit leaves the previous step
restorable, bit for bit), the async overlap telemetry (blocked < save),
retention, the preemption hook, corrupt-step fallback, the trainer
states file and the standalone manifest tool. Left out, with the code
they test: the estimator's ``CheckpointHandler`` and the
``do_checkpoint`` callback through ``Module`` (ROADMAP queue 1 items 14
and 15). The data position rides the manifest as in JAX:
``bind_data_state`` with ``ElasticShard.state()`` and
``DataLoader.data_state()`` (an ``ElasticSampler``) records the same
``meta['data']`` as the JAX manager at the same position and world, and
a restore into another world replays the exact remaining samples.

Across the packages, on a 2-layer BERT (hidden 64, dropout 0, f32): the
JAX ``CheckpointManager`` + ``ShardedTrainStep`` save at step 2, the port
restores the parameters and (through ``parallel.rename_states``) the
step's state and takes 3 steps against the JAX step continuing (loss rel
1e-5, parameters rel 1e-4, PERF.md §2's bounds); the port saves and the
JAX manager restores the parameters with every hash valid, bf16 included.
A JAX-written RNG state is reseeded from its seed (threefry is not
Philox), which ``last_restored_metadata`` says. ZeRO-1 and ZeRO-3
checkpoints written by a world of 2 gloo ranks restore at dp 1 with the
same masters.
"""
import gc
import glob
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, nd, parallel, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import (CheckpointManager,
                                        CorruptCheckpointError,
                                        validate_step_dir)
from mxnet_tpu_torch.checkpoint.manager import _TEST_HOOKS
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.parallel import dist
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
WORLD_TIMEOUT = 120.0


def _make_net_and_trainer(momentum=0.9, rescale_grad=1.0):
    with mx.cpu():
        net = nn.Dense(4, in_units=3)
        net.initialize(mx.init.Xavier())
    trainer = Trainer(net.collect_params(), 'sgd',
                      {'learning_rate': 0.1, 'momentum': momentum,
                       'rescale_grad': rescale_grad})
    return net, trainer


def _train_steps(net, trainer, n=2, batch=2):
    x = nd.array(onp.random.RandomState(0).rand(batch, 3)
                 .astype(onp.float32), ctx=mx.cpu())
    for _ in range(n):
        with mx.autograd.record():
            y = (net(x) ** 2).sum()
        y.backward()
        trainer.step(batch)


def _arr(a):
    return nd.array(onp.asarray(a, onp.float32), ctx=mx.cpu())


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    _TEST_HOOKS.clear()
    # no manager outlives its case (/healthz reads the live ones)
    gc.collect()


# ---------------------------------------------------------------------------
# round trip
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip_bit_identical(tmp_path):
    net, trainer = _make_net_and_trainer()
    _train_steps(net, trainer)
    mgr = CheckpointManager(str(tmp_path), params=net, trainer=trainer)
    mgr.save(7, block=True)
    w = net.weight.data().asnumpy().copy()
    b = net.bias.data().asnumpy().copy()
    counts = dict(trainer.optimizer._index_update_count)
    ptr = net.weight.tensor.data_ptr()
    mx.random.seed(123)   # perturb the RNG streams too
    net.weight.set_data(nd.zeros((4, 3), ctx=mx.cpu()))
    net.bias.set_data(nd.ones((4,), ctx=mx.cpu()))
    assert mgr.restore_latest() == 7
    onp.testing.assert_array_equal(net.weight.data().asnumpy(), w)
    onp.testing.assert_array_equal(net.bias.data().asnumpy(), b)
    assert net.weight.tensor.data_ptr() == ptr        # written in place
    assert dict(trainer.optimizer._index_update_count) == counts
    mgr.close()


def test_restore_rng_stream_resumes(tmp_path):
    """Every stream a step draws from comes back: the port's generator,
    torch's default one, a module's own and numpy's."""
    mx.random.seed(42)
    with mx.cpu():
        net = nn.Dense(2, in_units=2)
        net.initialize()
    net.generator = torch.Generator().manual_seed(5)
    g = mx.random.generator('cpu')
    torch.rand(2, generator=g)                     # advance the stream

    def draw():
        return (torch.rand(4, generator=g), torch.rand(3),
                torch.rand(2, generator=net.generator),
                onp.random.rand(3))
    mgr = CheckpointManager(str(tmp_path), params=net)
    mgr.save(1, block=True)
    expected = draw()
    mx.random.seed(999)                            # diverge
    torch.manual_seed(3)
    net.generator.manual_seed(1)
    assert mgr.restore_latest() == 1
    assert mgr.last_restored_metadata['rng_restored'] == 'exact'
    for got, want in zip(draw(), expected):
        onp.testing.assert_array_equal(onp.asarray(got), onp.asarray(want))
    mgr.close()


def test_restore_latest_empty_dir_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), params={})
    assert mgr.restore_latest() is None
    mgr.close()


def test_restore_apply_false_returns_payload(tmp_path):
    arrs = {'w': _arr(onp.arange(6).reshape(2, 3))}
    mgr = CheckpointManager(str(tmp_path), params=arrs)
    mgr.save(3, metadata={'note': 'hello'}, block=True)
    ck = mgr.restore_latest(apply=False)
    assert ck.step == 3
    assert ck.metadata['note'] == 'hello'
    # every step records the world it was committed under
    assert ck.metadata['world']['processes'] == 1
    onp.testing.assert_array_equal(ck.params['w'], arrs['w'].asnumpy())
    mgr.close()


def test_tensor_params_are_snapshotted_at_save(tmp_path):
    """An async save copies a tensor when save() is called: the training
    loop rewriting it in place afterwards cannot tear the write."""
    w = torch.full((8, 8), 1.0)
    mgr = CheckpointManager(str(tmp_path), params={'w': w})
    _TEST_HOOKS['during_write'] = lambda path: time.sleep(0.05)
    mgr.save(1)
    w += 41.0
    mgr.wait()
    ck = mgr.restore_latest(apply=False)
    onp.testing.assert_array_equal(ck.params['w'], onp.ones((8, 8)))
    mgr.close()


def test_host_buffers_are_reused_across_saves(tmp_path):
    """The snapshot's host buffers are allocated at the first save and
    reused by the next ones, each step still holding its own values."""
    w = torch.zeros(4, 4)
    mgr = CheckpointManager(str(tmp_path), params={'w': w, 'b': torch.ones(3)})
    for step in (1, 2, 3):
        w.fill_(float(step))
        mgr.save(step)
        pool = list(mgr._host_pool)
        assert len(pool) == 2
        if step > 1:
            assert all(a is b for a, b in zip(pool, first))
        else:
            first = pool
    mgr.wait()
    for step in (1, 2, 3):
        ck = mgr.restore(step, apply=False)
        onp.testing.assert_array_equal(ck.params['w'],
                                       onp.full((4, 4), float(step)))
    mgr.close()


# ---------------------------------------------------------------------------
# trainer states invariants
# ---------------------------------------------------------------------------

def test_trainer_states_file_roundtrip(tmp_path):
    net, trainer = _make_net_and_trainer(rescale_grad=2.0)
    _train_steps(net, trainer, n=3, batch=2)
    counts = dict(trainer.optimizer._index_update_count)
    num_update = trainer.optimizer.num_update
    rescale = trainer.optimizer.rescale_grad
    assert counts, "training must have counted updates"
    f = str(tmp_path / 'trainer.states')
    trainer.save_states(f)

    net2, trainer2 = _make_net_and_trainer(momentum=0.0, rescale_grad=1.0)
    trainer2.load_states(f)
    assert dict(trainer2.optimizer._index_update_count) == counts
    assert trainer2.optimizer.num_update == num_update
    assert trainer2.optimizer.rescale_grad == rescale
    st = trainer2._updater.states
    assert set(st) == set(trainer._updater.states)
    # the restored optimizer re-binds the live params for lr/wd mults
    assert trainer2.optimizer.param_dict[0] is trainer2._params[0]


def test_trainer_states_atomic_write_keeps_previous_on_failure(tmp_path):
    net, trainer = _make_net_and_trainer()
    _train_steps(net, trainer)
    f = str(tmp_path / 'trainer.states')
    trainer.save_states(f)
    before = open(f, 'rb').read()
    real_replace = os.replace

    def boom(src, dst):
        if dst == f:
            raise OSError("disk gone")
        return real_replace(src, dst)
    os.replace = boom
    try:
        with pytest.raises(OSError):
            trainer.save_states(f)
    finally:
        os.replace = real_replace
    assert open(f, 'rb').read() == before
    assert glob.glob(str(tmp_path / '*.tmp-*')) == []


# ---------------------------------------------------------------------------
# atomicity / crash consistency
# ---------------------------------------------------------------------------

_KILL9_SCRIPT = r"""
import os, signal, sys
import torch
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.checkpoint.manager import _TEST_HOOKS

root = sys.argv[1]
params = {'w': torch.arange(12, dtype=torch.float32).reshape(3, 4),
          'b': torch.full((4,), 7.0)}
mgr = CheckpointManager(root, params=params)
mgr.save(1, block=True)                      # the checkpoint that must survive
params['w'] += 100                           # step-2 state differs
_TEST_HOOKS['before_commit'] = \
    lambda path: os.kill(os.getpid(), signal.SIGKILL)
mgr.save(2, block=True)                      # dies between arrays and commit
print('UNREACHABLE')
"""


def test_kill9_between_write_and_commit_preserves_previous_step(tmp_path):
    root = str(tmp_path / 'ckpt')
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', _KILL9_SCRIPT, root],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert res.returncode == -signal.SIGKILL, (res.returncode, res.stderr)
    assert 'UNREACHABLE' not in res.stdout
    assert [os.path.basename(p) for p in
            glob.glob(os.path.join(root, 'step_*')) if '.tmp-' not in p] \
        == ['step_0000000001']
    assert glob.glob(os.path.join(root, '*.tmp-*')), \
        "expected the torn step-2 write to remain as a tmp dir"
    mgr = CheckpointManager(root, params=None)
    ck = mgr.restore_latest(apply=False)
    assert ck.step == 1
    onp.testing.assert_array_equal(
        ck.params['w'], onp.arange(12).reshape(3, 4).astype(onp.float32))
    onp.testing.assert_array_equal(ck.params['b'],
                                   onp.full((4,), 7.0, onp.float32))
    assert glob.glob(os.path.join(root, '*.tmp-*')) == []
    mgr.close()


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    telemetry.enable()
    telemetry.reset()
    try:
        arrs = {'w': torch.eye(3)}
        mgr = CheckpointManager(str(tmp_path), params=arrs)
        mgr.save(1, block=True)
        arrs['w'] += 1
        mgr.save(2, block=True)
        f = glob.glob(str(tmp_path / 'step_0000000002' / 'arrays' / '*'))[0]
        with open(f, 'r+b') as fh:
            fh.seek(os.path.getsize(f) - 4)
            fh.write(b'\xde\xad\xbe\xef')
        with pytest.warns(RuntimeWarning, match='falling back'):
            ck = mgr.restore_latest(apply=False)
        assert ck.step == 1
        onp.testing.assert_array_equal(ck.params['w'], onp.eye(3))
        assert telemetry.value('mxnet_tpu_checkpoint_corrupt_total') == 1
        mgr.close()
    finally:
        telemetry.disable()
        telemetry.reset()


def test_truncated_manifest_is_skipped_with_warning(tmp_path):
    arrs = {'w': torch.eye(3)}
    mgr = CheckpointManager(str(tmp_path), params=arrs)
    mgr.save(1, block=True)
    arrs['w'] += 1
    mgr.save(2, block=True)
    man = str(tmp_path / 'step_0000000002' / 'manifest.json')
    with open(man, 'r+b') as fh:
        fh.truncate(os.path.getsize(man) // 2)
    with pytest.warns(RuntimeWarning, match='failed validation'):
        ck = mgr.restore_latest(apply=False)
    assert ck.step == 1
    onp.testing.assert_array_equal(ck.params['w'], onp.eye(3))
    mgr.close()


def test_garbage_manifest_json_is_skipped_with_warning(tmp_path):
    arrs = {'w': torch.ones(2, 2)}
    mgr = CheckpointManager(str(tmp_path), params=arrs)
    mgr.save(1, block=True)
    arrs['w'] += 3
    mgr.save(2, block=True)
    with open(str(tmp_path / 'step_0000000002' / 'manifest.json'),
              'w') as fh:
        fh.write('{"format_version": 1, "step": 2, '
                 '"arrays": ["not", "entries"], "blobs": []}')
    with pytest.warns(RuntimeWarning, match='failed validation'):
        ck = mgr.restore_latest(apply=False)
    assert ck.step == 1
    mgr.close()


def test_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2, 2)})
    mgr.save(1, block=True)
    os.unlink(glob.glob(str(tmp_path / 'step_0000000001' / 'arrays'
                            / '*'))[0])
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with pytest.raises(CorruptCheckpointError):
            mgr.restore_latest()
    mgr.close()


def test_validate_step_dir_reports_all_problems(tmp_path):
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2, 2),
                                                   'b': torch.zeros(2)})
    mgr.save(5, block=True)
    d = str(tmp_path / 'step_0000000005')
    validate_step_dir(d)
    files = sorted(glob.glob(os.path.join(d, 'arrays', '*')))
    os.unlink(files[0])
    with open(files[1], 'ab') as fh:
        fh.write(b'junk')
    with pytest.raises(CorruptCheckpointError) as ei:
        validate_step_dir(d)
    msg = str(ei.value)
    assert 'missing' in msg and 'size' in msg
    mgr.close()


# ---------------------------------------------------------------------------
# async overlap: blocked < save in telemetry
# ---------------------------------------------------------------------------

def test_async_save_blocked_time_less_than_save_time(tmp_path):
    telemetry.enable()
    telemetry.reset()
    try:
        _TEST_HOOKS['during_write'] = lambda path: time.sleep(0.02)
        arrs = {f'p{i}': torch.from_numpy(onp.random.RandomState(i)
                                          .rand(32, 32).astype(onp.float32))
                for i in range(5)}
        mgr = CheckpointManager(str(tmp_path), params=arrs, async_save=True)
        mgr.save(1)                      # returns after the snapshot only
        overlapped = 0.0
        t0 = time.perf_counter()
        while mgr._pending is not None and mgr._pending.is_alive():
            overlapped = time.perf_counter() - t0   # "training" continues
        mgr.wait()
        n_blk, blocked = telemetry.value(
            'mxnet_tpu_checkpoint_blocked_seconds')
        n_sav, saved = telemetry.value('mxnet_tpu_checkpoint_save_seconds')
        assert n_blk == 1 and n_sav == 1
        assert blocked < saved, (blocked, saved)
        assert saved >= 5 * 0.02
        assert (mgr.last_blocked_seconds, mgr.last_save_seconds) == \
            (blocked, saved)
        assert telemetry.value('mxnet_tpu_checkpoint_saves_total') == 1
        assert telemetry.value('mxnet_tpu_checkpoint_last_step') == 1
        assert telemetry.value('mxnet_tpu_checkpoint_bytes') > 0
        assert overlapped > 0
        assert mgr.restore_latest(apply=False).step == 1
        mgr.close()
    finally:
        telemetry.disable()
        telemetry.reset()


def test_background_write_error_surfaces_on_next_call(tmp_path):
    def boom(path):
        raise RuntimeError("injected write failure")
    _TEST_HOOKS['after_arrays'] = boom
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2)})
    mgr.save(1)
    with pytest.raises(MXNetError, match='injected write failure'):
        mgr.wait()
    _TEST_HOOKS.clear()
    mgr.save(2, block=True)
    assert mgr.all_steps() == [2]
    mgr.close()


# ---------------------------------------------------------------------------
# retention / GC
# ---------------------------------------------------------------------------

def test_retention_keep_last_n_and_every_k(tmp_path):
    telemetry.enable()
    telemetry.reset()
    try:
        mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2, 2)},
                                keep_last_n=2, keep_every_k_steps=10,
                                async_save=False)
        for s in range(1, 13):
            mgr.save(s)
        assert mgr.all_steps() == [10, 11, 12]
        assert telemetry.value('mxnet_tpu_checkpoint_gc_total') == 9
        mgr.close()
    finally:
        telemetry.disable()
        telemetry.reset()


def test_autosave_steps_cadence(tmp_path):
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2)},
                            autosave_steps=3, async_save=False)
    saved = [s for s in range(1, 8) if mgr.maybe_save(s)]
    assert saved == [3, 6]
    assert mgr.all_steps() == [3, 6]
    mgr.close()


# ---------------------------------------------------------------------------
# preemption hook
# ---------------------------------------------------------------------------

def test_sigterm_hook_saves_current_step_and_sets_preempted(tmp_path):
    arrs = {'w': torch.full((2, 2), 3.0)}
    mgr = CheckpointManager(str(tmp_path), params=arrs)
    prev_calls = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: prev_calls.append(s))
    try:
        mgr.install_preemption_hook()
        mgr.maybe_save(41)
        assert mgr.all_steps() == []
        signal.raise_signal(signal.SIGTERM)
        assert mgr.preempted
        assert mgr.all_steps() == [41]
        assert prev_calls == [signal.SIGTERM]
        ck = mgr.restore_latest(apply=False)
        onp.testing.assert_array_equal(ck.params['w'],
                                       onp.full((2, 2), 3.0, onp.float32))
        mgr.close()
        assert signal.getsignal(signal.SIGTERM) is not mgr._on_signal
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_resave_same_step_failure_rolls_back_in_live_manager(tmp_path):
    arrs = {'w': torch.full((2, 2), 1.0)}
    mgr = CheckpointManager(str(tmp_path), params=arrs, async_save=False)
    mgr.save(3)

    def die(path):
        raise RuntimeError('disk full mid-swap')
    _TEST_HOOKS['after_retire_old'] = die
    arrs['w'] += 9
    with pytest.raises(MXNetError, match='write failed'):
        mgr.save(3)
    _TEST_HOOKS.clear()
    assert mgr.all_steps() == [3]
    ck = mgr.restore_latest(apply=False)
    onp.testing.assert_array_equal(ck.params['w'], onp.ones((2, 2)))
    assert glob.glob(str(tmp_path / '*.old-*')) == []
    assert glob.glob(str(tmp_path / '*.tmp-*')) == []
    mgr.close()


def test_midswap_kill_recovered_by_next_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2, 2)},
                            async_save=False)
    mgr.save(4)
    mgr.close()
    final = str(tmp_path / 'step_0000000004')
    os.replace(final, final + '.old-99999')
    assert checkpoint.committed_steps(str(tmp_path)) == []
    mgr2 = CheckpointManager(str(tmp_path), params=None)
    assert mgr2.all_steps() == [4]
    assert mgr2.restore_latest(apply=False).step == 4
    assert glob.glob(str(tmp_path / '*.old-*')) == []
    mgr2.close()


def test_plain_numpy_params_are_copied_not_aliased(tmp_path):
    w = onp.full((8, 8), 1.0, onp.float32)
    mgr = CheckpointManager(str(tmp_path), params={'w': w})
    _TEST_HOOKS['during_write'] = lambda path: time.sleep(0.05)
    mgr.save(1)
    w += 41.0
    mgr.wait()
    _TEST_HOOKS.clear()
    ck = mgr.restore_latest(apply=False)
    onp.testing.assert_array_equal(ck.params['w'], onp.ones((8, 8)))
    mgr.close()


def test_sigterm_during_save_does_not_destroy_inflight_write(tmp_path):
    arrs = {'w': torch.full((2, 2), 5.0)}
    mgr = CheckpointManager(str(tmp_path), params=arrs, async_save=False)
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        mgr.install_preemption_hook()
        _TEST_HOOKS['during_write'] = \
            lambda path: signal.raise_signal(signal.SIGTERM)
        mgr.save(9)
        assert mgr.preempted
        assert mgr.all_steps() == [9]
        ck = mgr.restore_latest(apply=False)
        onp.testing.assert_array_equal(ck.params['w'],
                                       onp.full((2, 2), 5.0, onp.float32))
        mgr.close()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_manifest_cli_tool_ok_and_corrupt(tmp_path):
    """tools/check_checkpoint_manifest.py (standalone) on the port's
    directories."""
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(3, 3)},
                            async_save=False)
    mgr.save(1)
    mgr.save(2)
    mgr.close()
    tool = os.path.join(ROOT, 'tools', 'check_checkpoint_manifest.py')
    res = subprocess.run([sys.executable, tool, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count('OK') == 2
    f = glob.glob(str(tmp_path / 'step_0000000002' / 'arrays' / '*'))[0]
    with open(f, 'r+b') as fh:
        fh.write(b'\x00\x00\x00\x00')
    res = subprocess.run([sys.executable, tool, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert 'step_0000000002' in res.stderr


def test_replication_waits_for_the_membership_world(tmp_path):
    """No membership world: a manager attaches no replica (as the JAX one
    does then), and an explicit attach names ROADMAP item 10."""
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2)})
    assert mgr.replica is None and mgr.last_restore_source is None
    with pytest.raises(MXNetError, match='item 10'):
        mgr.attach_replication(object())
    with pytest.raises(MXNetError, match='item 10'):
        checkpoint.ReplicaManager(mgr)
    mgr.close()


def test_healthz_reports_the_committed_step(tmp_path):
    from mxnet_tpu_torch.telemetry import server
    srv = server.TelemetryServer(port=0, start=False)
    assert checkpoint.last_committed_step() is None
    mgr = CheckpointManager(str(tmp_path), params={'w': torch.ones(2)},
                            async_save=False)
    assert srv.health()['last_committed_step'] is None
    mgr.save(12)
    mgr.save(15)
    assert srv.health()['last_committed_step'] == 15
    mgr.close()
    del mgr
    gc.collect()
    assert srv.health()['last_committed_step'] is None


def test_the_step_restores_in_place(tmp_path):
    """A ShardedTrainStep bound to the manager: its parameters are read
    through ``full_parameters`` and written back in place, masters and
    moments through ``set_states_bytes``; the step then continues exactly
    where the saving step did."""
    from mxnet_tpu_torch import gluon
    rng = onp.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 6).astype('float32'))
    y = torch.from_numpy(rng.randn(16, 1).astype('float32'))
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(8, activation='relu', in_units=6))
        net.add(nn.Dense(1, in_units=8))
        net.initialize(mx.init.Xavier())
    net.cast('bfloat16')
    step = parallel.ShardedTrainStep(net, gluon.loss.L2Loss(), 'adamw',
                                     {'learning_rate': 0.01},
                                     mesh=parallel.make_mesh(devices=['cpu']))
    for _ in range(2):
        step(x, y)
    mgr = CheckpointManager(str(tmp_path), params=net, trainer=step)
    mgr.save(2)
    mgr.wait()
    ref = [float(step(x, y)) for _ in range(2)]
    want = {n: p.detach().clone() for n, p in net.named_parameters()}
    ptrs = {n: p.data_ptr() for n, p in net.named_parameters()}
    assert mgr.restore_latest() == 2
    assert {n: p.data_ptr() for n, p in net.named_parameters()} == ptrs
    assert [float(step(x, y)) for _ in range(2)] == ref
    for n, p in net.named_parameters():
        assert torch.equal(p, want[n]), n
    doc = checkpoint.read_manifest(mgr.step_dir(2))
    assert {e['dtype'] for e in doc['arrays']} == {'bfloat16'}
    assert doc['metadata']['optimizer_state_layout'] == {
        'format': 'gathered-host', 'zero1': False, 'stage': 0, 'dp': 1}
    mgr.close()


def test_bfloat16_bits_without_ml_dtypes():
    """Where numpy has no bfloat16 type, a bf16 array is its raw bits
    under the same type flag: the same file bytes, read back bit for
    bit."""
    from mxnet_tpu_torch import serialization as S
    t = torch.randn(5, 3).bfloat16()
    bits = t.view(torch.int16).numpy().view(S.BF16_BITS)
    a = S.to_numpy(t)
    assert S.save_ndarray_file({'x': bits}) == S.save_ndarray_file({'x': a})
    assert torch.equal(S.to_tensor(bits), t) and torch.equal(S.to_tensor(a), t)
    assert S.is_bfloat16(bits) and S.is_bfloat16(a)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=256, hidden=64, layers=2, heads=2, intermediate=128,
           max_len=64, type_vocab=2, dropout=0.0)
B, T, M = 4, 32, 8
LOSS_RTOL, RTOL = 1e-5, 1e-4
ADAMW = {'learning_rate': 1e-3, 'wd': 0.01, 'eps': 1e-6}


def _bert_batch(seed):
    rng = onp.random.RandomState(seed)
    tokens = rng.randint(0, CFG['vocab_size'], (B, T)).astype('int32')
    types = rng.randint(0, 2, (B, T)).astype('int32')
    valid = rng.randint(T // 2, T + 1, B).astype('float32')
    mpos = onp.stack([rng.choice(T, M, replace=False)
                      for _ in range(B)]).astype('int32')
    labels = rng.randint(0, CFG['vocab_size'], (B, M)).astype('int32')
    labels[rng.rand(B, M) < 0.25] = -1
    nsp = rng.randint(0, 2, B).astype('int32')
    return [tokens, types, valid, mpos], [labels, nsp]


def _rel_fro(got, want):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    den = onp.linalg.norm(want)
    return onp.linalg.norm(got - want) / (den if den > 0 else 1.0)


@pytest.fixture(scope='module')
def jax_bert():
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.models.bert import BertForPretraining as JBert
    from mxnet_tpu.models.bert import bert_pretrain_loss as jloss
    from mxnet_tpu.parallel import ShardedTrainStep as JStep
    from mxnet_tpu.parallel.mesh import make_mesh as jmesh
    jmx.random.seed(0)
    net = JBert(CFG)
    net.initialize(jmx.init.Normal(0.02))
    net(jmx.nd.array(onp.zeros((1, 8), 'int32')))

    def step_of(n):
        return JStep(n, jloss, 'adamw', dict(ADAMW),
                     mesh=jmesh((1,), ('dp',), devices=jax.devices()[:1]))
    return jmx, net, step_of


def _jcall(jmx, step, batch):
    ins, labs = batch
    return float(step([jmx.nd.array(a) for a in ins],
                      [jmx.nd.array(a) for a in labs]).asnumpy())


def _tcall(step, batch):
    ins, labs = batch
    return float(step([torch.from_numpy(a) for a in ins],
                      [torch.from_numpy(a) for a in labs]))


def _port_bert(arrays=None, dtype=torch.float32):
    from mxnet_tpu_torch.models.bert import BertForPretraining
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    net = BertForPretraining(CFG, device='cpu', dtype=dtype)
    if arrays is not None:
        net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _jnames(jnet):
    by_id = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    return {n: by_id[id(p)] for n, p in jnet.collect_params().items()}


def test_jax_checkpoint_restores_into_the_port_and_trains_on(jax_bert,
                                                             tmp_path):
    """The JAX manager and step save at step 2; the port's manager reads
    the step (every hash checked), its parameters go into the port's
    model, the step state through ``rename_states``; 3 more steps on both
    sides agree within loss rel 1e-5 and parameters rel 1e-4. The JAX
    RNG state is reseeded, and the manager says so."""
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu_torch.models.bert import bert_pretrain_loss
    jmx, jnet, jstep_of = jax_bert
    jstep = jstep_of(jnet)
    batches = [_bert_batch(60 + i) for i in range(5)]
    for b in batches[:2]:
        _jcall(jmx, jstep, b)
    jmgr = JManager(str(tmp_path), params=jnet, trainer=jstep,
                    async_save=False)
    jmgr.save(2)
    jmgr.close()

    net = _port_bert()
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     dict(ADAMW),
                                     mesh=parallel.make_mesh(devices=['cpu']))
    mgr = CheckpointManager(str(tmp_path), params=net)
    ck = mgr.restore_latest(apply=False)
    assert ck.step == 2
    assert mgr.restore(2) == 2                    # params, then the RNG
    assert mgr.last_restored_metadata['rng_restored'] == 'reseeded'
    step.set_states_bytes(parallel.rename_states(ck.trainer_states,
                                                 _jnames(jnet)))
    for b in batches[2:]:
        lj, lt = _jcall(jmx, jstep, b), _tcall(step, b)
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (lt, lj)
    jp = jnet._collect_params_with_prefix()
    worst = max((_rel_fro(p.detach().numpy(), jp[n].data().asnumpy()), n)
                for n, p in net.named_parameters())
    assert worst[0] <= RTOL, worst
    mgr.close()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_port_checkpoint_restores_into_jax(jax_bert, tmp_path, dtype):
    """The port's manager saves its step (bf16 parameters under the JAX
    type flag); the JAX manager restores the parameters with every hash
    valid, bit for bit, and validates the directory."""
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu.checkpoint import validate_step_dir as jvalidate
    from mxnet_tpu_torch.models.bert import bert_pretrain_loss
    jmx, jnet, _ = jax_bert
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    net = _port_bert(arrays, dtype=getattr(torch, dtype))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     dict(ADAMW),
                                     mesh=parallel.make_mesh(devices=['cpu']))
    for i in range(2):
        _tcall(step, _bert_batch(80 + i))
    mgr = CheckpointManager(str(tmp_path), params=net, trainer=step,
                            async_save=False)
    mgr.save(2)
    mgr.close()
    jvalidate(mgr.step_dir(2))
    ck = JManager(str(tmp_path)).restore_latest(apply=False)
    assert ck.step == 2 and set(ck.params) == set(arrays)
    for n, p in net.named_parameters():
        got = ck.params[n]
        assert str(got.dtype) == dtype, (n, got.dtype)
        onp.testing.assert_array_equal(
            got.astype(onp.float32), p.detach().float().numpy())
    doc = pickle.loads(ck.trainer_states)
    assert doc['format'] == 'sharded_train_step_v1' and doc['step_count'] == 2


WORKER = r'''
import os, pickle, sys
import numpy as onp
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, gluon, parallel
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import dist

tmp, zero = sys.argv[1], int(sys.argv[2])
dist.init(device='cpu')
r, n = dist.rank(), dist.num_workers()
ref = onp.load(os.path.join(tmp, 'ref.npz'))
with mx.cpu():
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation='relu', in_units=16))
    net.add(nn.Dense(8, in_units=32))
    net.initialize()
net.load_state_dict({k: torch.from_numpy(ref[k]) for k in
                     ('0.weight', '0.bias', '1.weight', '1.bias')})
net.cast('bfloat16')
mesh = parallel.make_mesh((n,), ('dp',), devices=['cpu'])
step = parallel.ShardedTrainStep(
    net, gluon.loss.SoftmaxCrossEntropyLoss(), 'adamw',
    {'learning_rate': 0.01}, mesh=mesh, zero=zero)
b = ref['x'].shape[0] // n
x = torch.from_numpy(ref['x'][r * b:(r + 1) * b])
y = torch.from_numpy(ref['y'][r * b:(r + 1) * b])
for _ in range(3):
    step(x, y)
mgr = checkpoint.CheckpointManager(os.path.join(tmp, f'z{zero}_r{r}'),
                                   params=net, trainer=step)
mgr.save(3)
mgr.close()
full = {k: v.float().numpy() for k, v in step.full_parameters().items()}
masters = pickle.loads(step.get_states_bytes())['master']
step(x, y)
after = pickle.loads(step.get_states_bytes())
full_after = {k: v.float().numpy()
              for k, v in step.full_parameters().items()}
if r == 0:
    with open(os.path.join(tmp, f'z{zero}.pkl'), 'wb') as f:
        pickle.dump(dict(full=full, masters=masters, after=after,
                         stage=step.zero_stage, full_after=full_after), f)
dist.shutdown()
'''


@pytest.fixture(scope='module')
def zero_worlds(tmp_path_factory):
    """Worlds of 2 gloo ranks, under ZeRO-1 and ZeRO-3, each saving step
    3 through its own manager."""
    tmp = tmp_path_factory.mktemp('ckpt_zero')
    rng = onp.random.RandomState(0)
    w = {'0.weight': rng.randn(32, 16) * 0.2, '0.bias': rng.randn(32) * 0.1,
         '1.weight': rng.randn(8, 32) * 0.2, '1.bias': rng.randn(8) * 0.1}
    onp.savez(tmp / 'ref.npz', x=rng.randn(16, 16).astype('float32'),
              y=rng.randint(0, 8, 16).astype('float32'),
              **{k: v.astype('float32') for k, v in w.items()})
    script = tmp / 'worker.py'
    script.write_text(WORKER)
    codes = {}

    def run(zero):
        codes[zero] = dist.launch_local(
            [str(script), str(tmp), str(zero)], n=2,
            env={'OMP_NUM_THREADS': '1', 'PYTHONPATH': ROOT},
            coordinator=f'file://{tmp}/z{zero}.store', timeout=WORLD_TIMEOUT)
    threads = [threading.Thread(target=run, args=(z,)) for z in (1, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert codes == {1: [0, 0], 3: [0, 0]}, codes
    return tmp


BF16_STEP_RTOL = 1e-2


@pytest.mark.parametrize('zero', [1, 3])
def test_zero_checkpoint_at_dp2_restores_at_dp1(zero_worlds, zero):
    """A checkpoint a ZeRO world of 2 wrote (bf16 parameters, each rank
    its own directory, the payload gathered to whole tensors) restores
    into one process: the same parameters and f32 masters, bit for bit
    (read back through a step at lr 0, which moves no weight), and one
    more step lands where the world's next step did, within the bf16
    forward's rounding (the world splits the batch: rel 1e-2 on the
    moments and masters)."""
    from mxnet_tpu_torch import gluon
    with open(zero_worlds / f'z{zero}.pkl', 'rb') as f:
        doc = pickle.load(f)
    assert doc['stage'] == zero
    ref = onp.load(zero_worlds / 'ref.npz')
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation='relu', in_units=16))
        net.add(nn.Dense(8, in_units=32))
        net.initialize()
    net.cast('bfloat16')
    x, y = torch.from_numpy(ref['x']), torch.from_numpy(ref['y'])

    def step_of():
        return parallel.ShardedTrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), 'adamw',
            {'learning_rate': 0.01},
            mesh=parallel.make_mesh(devices=['cpu']))
    step = step_of()
    mgr = CheckpointManager(str(zero_worlds / f'z{zero}_r0'), params=net,
                            trainer=step)
    assert mgr.restore_latest() == 3
    layout = mgr.last_restored_metadata['optimizer_state_layout']
    assert layout == {'format': 'gathered-host', 'zero1': True,
                      'stage': zero, 'dp': 2}
    for n, p in net.named_parameters():
        onp.testing.assert_array_equal(p.detach().float().numpy(),
                                       doc['full'][n])
    step(x, y, lr=0.0)
    masters = pickle.loads(step.get_states_bytes())['master']
    assert set(masters) == set(doc['masters'])
    for n, m in doc['masters'].items():
        onp.testing.assert_array_equal(masters[n], m, err_msg=n)
    step = step_of()
    mgr = CheckpointManager(str(zero_worlds / f'z{zero}_r0'), params=net,
                            trainer=step)
    assert mgr.restore_latest() == 3
    step(x, y)
    got = pickle.loads(step.get_states_bytes())
    for n, st in doc['after']['opt_state'].items():
        for a, b in zip(st[:2], got['opt_state'][n][:2]):
            assert _rel_fro(b, a) <= BF16_STEP_RTOL, n
        assert int(got['opt_state'][n][2]) == int(st[2]) == 4
    for n, m in doc['after']['master'].items():
        assert _rel_fro(got['master'][n], m) <= BF16_STEP_RTOL, n
    mgr.close()


# ---------------------------------------------------------------------------
# the data position in the manifest (tests/test_resharding.py's cases)
# ---------------------------------------------------------------------------

def _jax_manager(path, shard_state):
    import mxnet_tpu as jmx
    from mxnet_tpu import checkpoint as jcheckpoint
    net = jmx.gluon.nn.Dense(2, in_units=1, prefix='rsdata_')
    net.initialize(jmx.init.Xavier())
    mgr = jcheckpoint.CheckpointManager(str(path), params=net,
                                        async_save=False)
    mgr.bind_data_state(shard_state)
    return mgr


@pytest.mark.parametrize('provider', ['shard', 'loader'])
def test_manifest_data_position_matches_jax_and_round_trips(tmp_path,
                                                           provider):
    """The port's manifest records the same meta['data'] as the JAX
    manager at the same position and world, and a restore into another
    world (dp=4 -> 2 -> 4) replays the exact remaining samples."""
    from mxnet_tpu import io as jio
    from mxnet_tpu.gluon import data as jdata
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader, \
        ElasticSampler
    from mxnet_tpu_torch.io import ElasticShard
    G, N = 8, 32
    net, _ = _make_net_and_trainer()
    mgr = CheckpointManager(str(tmp_path / 'port'), params=net,
                            async_save=False)
    if provider == 'shard':
        shard = ElasticShard(N, G, rank=0, world=4, seed=3)
        jshard = jio.ElasticShard(N, G, rank=0, world=4, seed=3)
        for _ in range(3):
            shard.next_batch()
            jshard.next_batch()
        mgr.bind_data_state(shard.state)
        jstate = jshard.state
    else:
        x = onp.arange(N, dtype=onp.float32).reshape(N, 1)
        with mx.cpu():
            loader = DataLoader(ArrayDataset(x), batch_sampler=ElasticSampler(
                N, G, rank=0, world=4, seed=3))
            list(loader)                        # one pass: 4 global batches
        jloader = jdata.DataLoader(jdata.ArrayDataset(x),
                                   batch_sampler=jdata.ElasticSampler(
                                       N, G, rank=0, world=4, seed=3))
        list(jloader)
        mgr.bind_data_state(loader.data_state)
        jstate = jloader.data_state
    mgr.save(3)
    jmgr = _jax_manager(tmp_path / 'jax', jstate)
    jmgr.save(3)
    port_meta = mgr.restore(3, apply=False).metadata
    jax_meta = jmgr.restore(3, apply=False).metadata
    assert port_meta['data'] == jax_meta['data']
    assert 'world' in port_meta

    net2, _ = _make_net_and_trainer()
    mgr2 = CheckpointManager(str(tmp_path / 'port'), params=net2,
                             async_save=False)
    assert mgr2.restore_latest() == 3
    ds = mgr2.last_restored_metadata['data']
    steps = 3 if provider == 'shard' else 4
    assert ds['position'] == steps * G and ds['world'] == 4
    assert ds['assignment']['0'] == [0, G // 4]
    ref = ElasticShard(N, G, rank=0, world=1, seed=3)
    want = [[ref.sample_at(s * G + j) for j in range(G)] for s in range(8)]
    halves = [ElasticShard.from_state(ds, rank=r, world=2) for r in range(2)]
    assert [x for sh in halves for x in sh.next_batch()] == want[steps]
    quarters = [ElasticShard.from_state(halves[0].state(), rank=r, world=4)
                for r in range(4)]
    assert [x for sh in quarters for x in sh.next_batch()] == \
        want[steps + 1]
    for m in (mgr, mgr2, jmgr):
        m.close()

