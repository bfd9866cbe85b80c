"""The port's multi-process world (``mxnet_tpu_torch.parallel.dist``),
its collectives and ``SyncBatchNorm``, across real ranks on the CPU.

Worlds of 2 and 4 gloo ranks are spawned once for the module
(``dist.launch_local``, a ``FileStore`` under ``tmp_path`` for the
rendezvous, one thread per rank, 120 s for each world after which every
rank is killed and the tests fail). Each rank runs the worker below,
which imports only the port and numpy, and pickles its readings. The
collectives are held against numpy on the ranks' numpy-seeded inputs,
their gradients against the JAX transposes' definitions, and
SyncBatchNorm at dp = 2 against the JAX package's ``sync_batch_norm_op``
under ``shard_map`` on a two-device CPU mesh (outputs, running statistics
and gradients within 1e-5). The ``dist_sync`` KVStore pushes over both
worlds, plain and through the 2bit codec, and a Trainer steps through
'device' and 'dist_sync' stores, against numpy. ``init`` runs from the
MXNET_TPU_* names (``launch_local``) and, in a second world, from the
DMLC_* drop-ins.
"""
import os
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mxnet_tpu.base import state as jflags
from mxnet_tpu.ops.nn import sync_batch_norm_op as j_sync_bn
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import collectives, dist
from mxnet_tpu_torch.resilience import retry_call
from mxnet_tpu_torch import telemetry
from test_torch_jax_globals import jax_globals  # noqa: F401

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
WORLD_TIMEOUT = 120.0
SBN_SHAPE = (8, 3, 4, 4)
SBN_EPS = 1e-5

WORKER = r'''
import os, pickle, sys
import numpy as onp
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import collectives as C, dist, make_mesh

tmp, name = sys.argv[1], sys.argv[2]
dist.init(device='cpu')
r, n = dist.rank(), dist.num_workers()
out = {'rank': r, 'size': n, 'backend': dist.backend(),
       'device': str(dist.device())}


def a(rank, shape=(4, 6)):
    return onp.random.RandomState(10 + rank).randn(*shape).astype('float32')


x = torch.from_numpy(a(r))
out['psum'] = C.psum(x, 'dp').numpy()
out['pmean'] = C.pmean(x, 'dp').numpy()
out['pmax'] = C.pmax(x, 'dp').numpy()
out['ag0'] = C.all_gather(x, 'dp', axis=0).numpy()
out['ag1'] = C.all_gather(x, 'dp', axis=1).numpy()
out['ag_stack'] = C.all_gather(x, 'dp', axis=1, tiled=False).numpy()
big = torch.from_numpy(a(r, (4 * n, 2 * n)))
out['rs0'] = C.reduce_scatter(big, 'dp', scatter_dimension=0).numpy()
out['rs1'] = C.reduce_scatter(big, 'dp', scatter_dimension=1).numpy()
out['index'], out['axis_size'] = C.axis_index('dp'), C.axis_size('dp')
# gradients: each rank weighs its output by its own numpy weights
for key, fn, shape in (
        ('psum', lambda t: C.psum(t, 'dp'), (4, 6)),
        ('ag0', lambda t: C.all_gather(t, 'dp', axis=0), (4, 6)),
        ('ag_stack', lambda t: C.all_gather(t, 'dp', axis=1, tiled=False),
         (4, 6)),
        ('rs1', lambda t: C.reduce_scatter(t, 'dp', scatter_dimension=1),
         (4 * n, 2 * n))):
    t = torch.from_numpy(a(r, shape)).requires_grad_()
    y = fn(t)
    w = torch.from_numpy(onp.random.RandomState(50 + r).randn(
        *y.shape).astype('float32'))
    (y * w).sum().backward()
    out['grad_' + key] = t.grad.numpy()
mesh = make_mesh((n,), ('dp',), devices=['cpu'])
out['mesh'] = (mesh.shape, str(mesh.device), mesh.rank)
out['topology'] = dist.host_topology()
out['split'] = dist.dp_host_split()
for key, call in (('tp_mesh', lambda: make_mesh((n // 2, 2), ('dp', 'tp'))),
                  ('ppermute', lambda: C.ppermute(x, 'dp', [(0, 1)])),
                  ('ordered_barrier', lambda: C.ordered_barrier(x)),
                  ('forced_split', lambda: dist.dp_host_split(force=2)),
                  ('membership', lambda: dist.start_membership())):
    try:
        call()
        out[key] = 'ran'
    except MXNetError as e:
        out[key] = str(e)
dist.barrier()
# the dist store over the world: a plain push, then 3 pushes through the
# 2bit codec (each rank carries its own residual)
with mx.cpu():
    kv = mx.kv.create('dist_sync')
    out['kv_rank'], out['kv_workers'] = kv.rank, kv.num_workers
    kv.init(0, mx.nd.zeros((4, 6)))
    kv.push(0, mx.nd.array(a(r)))
    o = mx.nd.zeros((4, 6))
    kv.pull(0, out=o)
    out['kv_sum'] = o.asnumpy()
    kc = mx.kv.create('dist_sync')
    kc.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
    kc.init(0, mx.nd.zeros((4, 6)))
    out['kv_2bit'] = []
    for i in range(3):
        kc.push(0, mx.nd.array(a(r) * 0.4))
        kc.pull(0, out=o)
        out['kv_2bit'].append(o.asnumpy())
    kc.barrier()
# the Trainer over the world through each store: 2 SGD steps on this
# rank's batch from the same weights
out['trainer'] = {}
for label, kw in (('device', dict(kvstore='device')),
                  ('dist_sync', dict(kvstore='dist_sync')),
                  ('dist_sync_on_kvstore', dict(kvstore='dist_sync',
                                                update_on_kvstore=True)),
                  ('dist_sync_2bit', dict(
                      kvstore='dist_sync',
                      compression_params={'type': '2bit',
                                          'threshold': 0.5}))):
    with mx.cpu():
        net = nn.Dense(5, in_units=6)
        net.initialize()
        net.weight.set_data(mx.nd.array(a(0, (5, 6)) * 0.3))
        net.bias.set_data(mx.nd.zeros((5,)))
        tr = mx.gluon.Trainer(net.collect_params(), 'sgd',
                              {'learning_rate': 0.1, 'momentum': 0.9}, **kw)
        for step in range(2):
            with mx.autograd.record():
                loss = (net(mx.nd.array(a(r + 20 * step))) ** 2).sum()
            loss.backward()
            tr.step(4 * n)
    out['trainer'][label] = [net.weight.data().asnumpy(),
                             net.bias.data().asnumpy()]
if n == 2:
    # SyncBatchNorm: this rank's rows of the global batch
    rng = onp.random.RandomState(3)
    xs = rng.randn(8, 3, 4, 4).astype('float32')
    w = rng.randn(8, 3, 4, 4).astype('float32')
    gamma, beta = rng.rand(3).astype('float32') + 0.5, rng.randn(3).astype(
        'float32')
    b = 8 // n
    with mx.cpu():
        bn = nn.SyncBatchNorm(in_channels=3, epsilon=1e-5, momentum=0.9)
        bn.initialize()
    bn.load_state_dict({'gamma': torch.from_numpy(gamma),
                        'beta': torch.from_numpy(beta),
                        'running_mean': torch.zeros(3),
                        'running_var': torch.ones(3)})
    loc = torch.from_numpy(xs[r * b:(r + 1) * b]).requires_grad_()
    bn.train()
    with C.data_axis('dp'):
        y = bn(loc)
    (y * torch.from_numpy(w[r * b:(r + 1) * b])).sum().backward()
    out['sbn'] = dict(out=y.detach().numpy(), dx=loc.grad.numpy(),
                      dgamma=bn.gamma.tensor.grad.numpy(),
                      dbeta=bn.beta.tensor.grad.numpy(),
                      mean=bn.running_mean.tensor.detach().numpy().copy(),
                      var=bn.running_var.tensor.detach().numpy().copy())
    # outside a data axis it is BatchNorm on the rank's rows
    y2 = bn(torch.from_numpy(xs[r * b:(r + 1) * b]))
    ref = nn.BatchNorm(in_channels=3, epsilon=1e-5, device='cpu')
    ref.initialize()
    ref.load_state_dict({'gamma': torch.from_numpy(gamma),
                         'beta': torch.from_numpy(beta),
                         'running_mean': torch.zeros(3),
                         'running_var': torch.ones(3)})
    ref.train()
    out['sbn_local'] = (y2.detach().numpy(),
                        ref(torch.from_numpy(xs[r * b:(r + 1) * b]))
                        .detach().numpy())
with open(os.path.join(tmp, f'{name}_r{r}.pkl'), 'wb') as f:
    pickle.dump(out, f)
dist.shutdown()
'''


def _run(tmp, name, n, env=None):
    script = tmp / 'worker.py'
    if not script.exists():
        script.write_text(WORKER)
    e = {'OMP_NUM_THREADS': '1', 'PYTHONPATH': ROOT}
    e.update(env or {})
    codes = dist.launch_local([str(script), str(tmp), name], n=n, env=e,
                              coordinator=f'file://{tmp}/{name}.store',
                              timeout=WORLD_TIMEOUT)
    return codes


def _run_dmlc(tmp, name, n):
    """A world started from the DMLC_* drop-in names alone."""
    script = tmp / 'worker.py'
    procs = []
    base = {k: v for k, v in os.environ.items()
            if not k.startswith('MXNET_TPU_')}
    base.update(OMP_NUM_THREADS='1', PYTHONPATH=ROOT)
    try:
        for r in range(n):
            e = dict(base, DMLC_NUM_WORKER=str(n), DMLC_WORKER_ID=str(r),
                     MXNET_TPU_COORDINATOR=f'file://{tmp}/{name}.store')
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(tmp), name], env=e))
        return [p.wait(timeout=WORLD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dist')
    (tmp / 'worker.py').write_text(WORKER)
    codes = {}
    runs = [('env2', lambda: _run(tmp, 'env2', 2)),
            ('env4', lambda: _run(tmp, 'env4', 4)),
            ('dmlc2', lambda: _run_dmlc(tmp, 'dmlc2', 2))]
    threads = [threading.Thread(target=lambda k=k, f=f: codes.__setitem__(
        k, f())) for k, f in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for k, _ in runs:
        assert codes.get(k) == [0] * len(codes.get(k) or [1]), \
            (k, codes.get(k))
        n = int(k[-1])
        out[k] = [pickle.loads((tmp / f'{k}_r{r}.pkl').read_bytes())
                  for r in range(n)]
    return out


def _a(rank, shape=(4, 6)):
    return onp.random.RandomState(10 + rank).randn(*shape).astype('float32')


def _w(rank, shape):
    return onp.random.RandomState(50 + rank).randn(*shape).astype('float32')


@pytest.mark.parametrize('world', ['env2', 'env4', 'dmlc2'])
def test_init_from_the_environment(worlds, world):
    ranks = worlds[world]
    n = len(ranks)
    assert [o['rank'] for o in ranks] == list(range(n))
    assert all(o['size'] == n and o['backend'] == 'gloo' and
               o['device'] == 'cpu' for o in ranks)


@pytest.mark.parametrize('world', ['env2', 'env4'])
def test_reductions_against_numpy(worlds, world):
    ranks = worlds[world]
    n = len(ranks)
    xs = [_a(r) for r in range(n)]
    for o in ranks:
        onp.testing.assert_allclose(o['psum'], sum(xs), rtol=1e-6, atol=1e-6)
        onp.testing.assert_allclose(o['pmean'], sum(xs) / n, rtol=1e-6,
                                    atol=1e-6)
        onp.testing.assert_array_equal(o['pmax'], onp.max(xs, axis=0))
        assert o['index'] == o['rank'] and o['axis_size'] == n


@pytest.mark.parametrize('world', ['env2', 'env4'])
def test_dist_kvstore_against_numpy(worlds, world):
    """``kvstore.create('dist_sync')`` across the ranks: rank and
    num_workers are the world's; a push is all-reduced over the world
    (the numpy sum; bitwise at two ranks); with 2bit compression each
    rank's push is quantized against its own residual before the sum,
    as numpy's replay of the codec gives, bitwise."""
    ranks = worlds[world]
    n = len(ranks)
    xs = [_a(r) for r in range(n)]
    residual = [onp.zeros_like(x) for x in xs]
    want_2bit = []
    for _ in range(3):
        total = onp.zeros_like(xs[0])
        for r in range(n):
            acc = residual[r] + xs[r] * onp.float32(0.4)
            q = onp.where(acc >= 0.5, onp.float32(0.5),
                          onp.where(acc <= -0.5, onp.float32(-0.5),
                                    onp.float32(0.0))).astype('float32')
            residual[r] = acc - q
            total = total + q
        want_2bit.append(total)
    for o in ranks:
        assert (o['kv_rank'], o['kv_workers']) == (o['rank'], n)
        if n == 2:
            onp.testing.assert_array_equal(o['kv_sum'], xs[0] + xs[1])
        onp.testing.assert_allclose(o['kv_sum'], sum(xs), rtol=1e-6,
                                    atol=1e-6)
        for got, want in zip(o['kv_2bit'], want_2bit):
            onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('world', ['env2', 'env4'])
def test_trainer_over_each_store_against_numpy(worlds, world):
    """A Trainer of 2 SGD steps (momentum 0.9) on each rank's batch:
    'device' and 'dist_sync' take the Trainer's own f32 reduction, so the
    world's weights are numpy's replay of the summed gradients; with the
    optimizer in the dist store (its push all-reduces) they agree within
    f32 rounding; with the 2bit codec every rank ends with the same
    weights."""
    ranks = worlds[world]
    n = len(ranks)
    w, b = _a(0, (5, 6)) * onp.float32(0.3), onp.zeros(5, 'float32')
    mom = [onp.zeros_like(w), onp.zeros_like(b)]
    for step in range(2):
        gw, gb = onp.zeros_like(w), onp.zeros_like(b)
        for r in range(n):
            x = _a(r + 20 * step)
            dy = 2 * (x @ w.T + b)
            gw, gb = gw + dy.T @ x, gb + dy.sum(0)
        for k, (p, g) in enumerate(((w, gw), (b, gb))):
            mom[k] = onp.float32(0.9) * mom[k] - onp.float32(0.1) * (
                g / onp.float32(4 * n))
        w, b = w + mom[0], b + mom[1]
    for o in ranks:
        got = o['trainer']
        for label in ('device', 'dist_sync', 'dist_sync_on_kvstore'):
            for t, want in zip(got[label], (w, b)):
                onp.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-6)
        for t, d in zip(got['dist_sync'], got['device']):
            onp.testing.assert_array_equal(t, d)
        for t, r0 in zip(got['dist_sync_2bit'], ranks[0]['trainer'][
                'dist_sync_2bit']):
            onp.testing.assert_array_equal(t, r0)


@pytest.mark.parametrize('world', ['env2', 'env4'])
def test_gathers_and_scatters_against_numpy(worlds, world):
    ranks = worlds[world]
    n = len(ranks)
    xs = [_a(r) for r in range(n)]
    bigs = [_a(r, (4 * n, 2 * n)) for r in range(n)]
    for o in ranks:
        r = o['rank']
        onp.testing.assert_array_equal(o['ag0'], onp.concatenate(xs, 0))
        onp.testing.assert_array_equal(o['ag1'], onp.concatenate(xs, 1))
        onp.testing.assert_array_equal(o['ag_stack'], onp.stack(xs, 1))
        total = sum(bigs)
        onp.testing.assert_allclose(o['rs0'], total[4 * r:4 * (r + 1)],
                                    rtol=1e-6, atol=1e-6)
        onp.testing.assert_allclose(o['rs1'], total[:, 2 * r:2 * (r + 1)],
                                    rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('world', ['env2', 'env4'])
def test_collective_gradients_are_the_jax_transposes(worlds, world):
    """psum's gradient is the psum of the output gradients, all_gather's
    their reduce-scatter (this rank's slice of their sum), and
    reduce_scatter's their all-gather."""
    ranks = worlds[world]
    n = len(ranks)
    ws = {k: [_w(r, s) for r in range(n)]
          for k, s in (('psum', (4, 6)), ('ag0', (4 * n, 6)),
                       ('ag_stack', (4, n, 6)), ('rs1', (4 * n, 2)))}
    for o in ranks:
        r = o['rank']
        onp.testing.assert_allclose(o['grad_psum'], sum(ws['psum']),
                                    rtol=1e-6, atol=1e-6)
        onp.testing.assert_allclose(o['grad_ag0'],
                                    sum(ws['ag0'])[4 * r:4 * (r + 1)],
                                    rtol=1e-6, atol=1e-6)
        onp.testing.assert_allclose(o['grad_ag_stack'],
                                    sum(ws['ag_stack'])[:, r], rtol=1e-6,
                                    atol=1e-6)
        onp.testing.assert_allclose(o['grad_rs1'],
                                    onp.concatenate(ws['rs1'], 1),
                                    rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('world', ['env2', 'env4'])
def test_mesh_topology_and_refusals_in_a_world(worlds, world):
    ranks = worlds[world]
    n = len(ranks)
    for o in ranks:
        shape, device, rank = o['mesh']
        assert shape == {'dp': n} and device == 'cpu' and rank == o['rank']
        assert o['topology'] == [(0, list(range(n)))]
        assert o['split'] == (1, n)
        assert 'item 6a' in o['tp_mesh']
        assert 'item 13' in o['ppermute']
        # ZeRO-3's gather chain is ported (item 7): an identity
        assert o['ordered_barrier'] == 'ran'
        assert 'item 8' in o['forced_split']
        assert 'item 10' in o['membership']


def _jax_sync_bn():
    rng = onp.random.RandomState(3)
    xs = rng.randn(*SBN_SHAPE).astype('float32')
    w = rng.randn(*SBN_SHAPE).astype('float32')
    gamma = rng.rand(3).astype('float32') + 0.5
    beta = rng.randn(3).astype('float32')
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    mesh = jmake_mesh((2,), ('dp',))
    mmean, mvar = jnp.zeros(3), jnp.ones(3)

    def local(xb, g, b):
        return j_sync_bn(xb, g, b, mmean, mvar, axis_name='dp', eps=SBN_EPS,
                         momentum=0.9, fix_gamma=False)

    f = shard_map(local, mesh=mesh, in_specs=(JP('dp'), JP(), JP()),
                  out_specs=(JP('dp'), JP(), JP()))
    jflags.is_training = True
    try:
        out, mean, var = f(jnp.asarray(xs), jnp.asarray(gamma),
                           jnp.asarray(beta))
        grads = jax.grad(lambda x, g, b: jnp.sum(f(x, g, b)[0] * w),
                         argnums=(0, 1, 2))(jnp.asarray(xs),
                                            jnp.asarray(gamma),
                                            jnp.asarray(beta))
    finally:
        jflags.is_training = False
    return [onp.asarray(t) for t in (out, mean, var) + tuple(grads)], xs


def test_sync_batchnorm_matches_jax_across_two_ranks(worlds):
    """Mirrors tests/test_parallel.py::test_sync_batchnorm_in_shard_map:
    the layer at dp = 2 under ``data_axis`` against the JAX op under
    shard_map, outputs, running statistics and every gradient (gamma's
    and beta's summed over the ranks, as the dp reduction sums them)."""
    (out, mean, var, dx, dgamma, dbeta), _ = _jax_sync_bn()
    ranks = worlds['env2']
    tol = dict(rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(
        onp.concatenate([o['sbn']['out'] for o in ranks]), out, **tol)
    onp.testing.assert_allclose(
        onp.concatenate([o['sbn']['dx'] for o in ranks]), dx, **tol)
    onp.testing.assert_allclose(sum(o['sbn']['dgamma'] for o in ranks),
                                dgamma, **tol)
    onp.testing.assert_allclose(sum(o['sbn']['dbeta'] for o in ranks),
                                dbeta, **tol)
    for o in ranks:
        onp.testing.assert_allclose(o['sbn']['mean'], mean, **tol)
        onp.testing.assert_allclose(o['sbn']['var'], var, **tol)
        got, want = o['sbn_local']
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_launch_local_runs_a_short_script(tmp_path):
    script = tmp_path / 'hello.py'
    script.write_text(
        'import os, sys\n'
        'r = os.environ["MXNET_TPU_PROC_ID"]\n'
        'n = os.environ["MXNET_TPU_NUM_PROCS"]\n'
        'c = os.environ["MXNET_TPU_COORDINATOR"]\n'
        'open(os.path.join(sys.argv[1], "rank" + r), "w").write(n + c)\n'
        'sys.exit(int(r))\n')
    codes = dist.launch_local([str(script), str(tmp_path)], n=3,
                              coordinator='file:///x', timeout=60)
    assert codes == [0, 1, 2]
    for r in range(3):
        assert (tmp_path / f'rank{r}').read_text() == '3file:///x'
    hang = tmp_path / 'hang.py'
    hang.write_text('import time\ntime.sleep(60)\n')
    assert dist.launch_local([str(hang)], n=2, timeout=0.5) == [None, None]


def test_backend_resolution_refuses_two_ranks_on_one_card():
    cuda0 = torch.device('cuda', 0)
    hosts = ['h', 'h']
    with pytest.raises(MXNetError, match="backend='gloo'"):
        dist._resolve_backend(None, [cuda0, cuda0], hosts, ['u0', 'u0'])
    with pytest.raises(MXNetError, match='one card per rank'):
        dist._resolve_backend('nccl', [cuda0, cuda0], hosts, ['u0', 'u0'])
    assert dist._resolve_backend('gloo', [cuda0, cuda0], hosts,
                                 ['u0', 'u0']) == 'gloo'
    cuda1 = torch.device('cuda', 1)
    assert dist._resolve_backend(None, [cuda0, cuda1], hosts,
                                 ['u0', 'u1']) == 'nccl'
    # the same card index on two hosts is two cards
    assert dist._resolve_backend(None, [cuda0, cuda0], ['a', 'b'],
                                 ['u0', 'u1']) == 'nccl'
    cpu = torch.device('cpu')
    assert dist._resolve_backend(None, [cpu, cpu], hosts,
                                 [None, None]) == 'gloo'
    with pytest.raises(MXNetError, match='one card per rank'):
        dist._resolve_backend('nccl', [cpu, cpu], hosts, [None, None])
    with pytest.raises(MXNetError, match='mix'):
        dist._resolve_backend(None, [cpu, cuda0], hosts, [None, 'u0'])
    with pytest.raises(MXNetError, match="'gloo' or 'nccl'"):
        dist._resolve_backend('mpi', [cpu, cpu], hosts, [None, None])


def test_world_of_one_and_its_resolution(monkeypatch):
    """Outside a world every collective is the identity, and the world
    resolves from the MXNET_TPU_* names before the DMLC_* ones."""
    assert dist.num_workers() == 1 and dist.rank() == 0
    x = torch.arange(6.).reshape(2, 3)
    assert collectives.psum(x, 'dp') is x
    assert collectives.all_gather(x, 'dp', axis=1, tiled=False).shape == \
        (2, 1, 3)
    assert collectives.axis_size('dp') == 1
    monkeypatch.setenv('DMLC_NUM_WORKER', '4')
    monkeypatch.setenv('DMLC_WORKER_ID', '3')
    monkeypatch.setenv('DMLC_PS_ROOT_URI', 'node0')
    monkeypatch.setenv('DMLC_PS_ROOT_PORT', '9100')
    assert dist._resolve_world() == ('node0:9100', 4, 3)
    monkeypatch.setenv('MXNET_TPU_NUM_PROCS', '2')
    monkeypatch.setenv('MXNET_TPU_PROC_ID', '1')
    monkeypatch.setenv('MXNET_TPU_COORDINATOR', 'file:///s')
    assert dist._resolve_world() == ('file:///s', 2, 1)


def test_retry_call_bounded_and_counted():
    """Mirrors tests/test_resilience.py::test_retry_call_bounded_and_counted
    on the port's copy."""
    was_on = telemetry.enabled()
    telemetry.enable()
    try:
        telemetry.reset()
        calls = []

        def flaky(x):
            calls.append(x)
            if len(calls) < 3:
                raise OSError('transient')
            return x * 2

        assert retry_call(flaky, 21, retries=2, backoff_seconds=0,
                          site='unit.test') == 42
        assert len(calls) == 3
        assert telemetry.value('mxnet_tpu_resilience_retries_total',
                               site='unit.test') == 2
        calls.clear()
        with pytest.raises(OSError, match='transient'):
            retry_call(flaky, 1, retries=1, backoff_seconds=0,
                       site='unit.test')
        assert len(calls) == 2
        calls.clear()
        with pytest.raises(ValueError):
            retry_call(lambda: (_ for _ in ()).throw(ValueError('no')),
                       retries=5, backoff_seconds=0)
    finally:
        if not was_on:
            telemetry.disable()
