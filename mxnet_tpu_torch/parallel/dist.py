"""Multi-process worlds over ``torch.distributed`` (counterpart of the
``init`` part of ``mxnet_tpu/parallel/dist.py``).

One process per card and one rank per process, every rank a symmetric
worker, as the JAX package runs one process per host over
``jax.distributed``. The environment protocol is the JAX package's:

    MXNET_TPU_COORDINATOR  host:port of rank 0 (or file:///path)
    MXNET_TPU_NUM_PROCS    total processes
    MXNET_TPU_PROC_ID      this process's rank

with the DMLC_* names of the reference's launch scripts as drop-ins
(DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT, DMLC_NUM_WORKER, DMLC_WORKER_ID).
``init`` connects to rank 0's store (a ``TCPStore`` at host:port, or a
``FileStore`` for ``file://`` coordinators), retried with backoff
(``MXTPU_DIST_INIT_RETRIES``), and every rank publishes its host and
device there before the process group is made, so the backend is
resolved from the whole world with no silent fallback:

- CPU tensors use gloo;
- one card per rank uses NCCL;
- ranks that share a card raise ``MXNetError`` (NCCL refuses two ranks on
  one card), unless the caller passes ``backend='gloo'``.

gloo takes CUDA tensors for every collective the port runs (it copies
through host memory itself), which is how ranks that share one card
train. The NCCL route is written for one card per rank; it has run only
where a machine with two or more cards ran it.

Not ported, each raising by name: the elastic membership side channel,
``reinit`` and the checkpoint replica transport (ROADMAP queue 1 item
10), and a forced hierarchical split (item 8).
"""
from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as tdist

from ..base import MXNetError

__all__ = ['init', 'shutdown', 'rank', 'num_workers',
           'device', 'backend', 'devices', 'hosts', 'host_topology',
           'dp_host_split', 'barrier', 'launch_local', 'start_membership',
           'membership', 'reinit']

_log = logging.getLogger('mxnet_tpu_torch.dist')

_world = None        # the initialized world's facts, see init()


def _resolve_world(coordinator=None, num_processes=None, process_id=None,
                   need_coordinator=True):
    """(coordinator, world size, rank) from the arguments, then the
    MXNET_TPU_* names, then the DMLC_* drop-ins (the JAX package's
    resolution, one place for both)."""
    from .. import config as _config
    num_processes = num_processes \
        or _config.get('MXNET_TPU_NUM_PROCS') \
        or int(os.environ.get('DMLC_NUM_WORKER', '1'))
    if process_id is None:
        pid = _config.get('MXNET_TPU_PROC_ID')
        process_id = pid if pid >= 0 \
            else int(os.environ.get('DMLC_WORKER_ID', '0'))
    if need_coordinator:
        coordinator = coordinator \
            or _config.get('MXNET_TPU_COORDINATOR') \
            or _dmlc_coordinator()
    return coordinator, int(num_processes), int(process_id)


def _dmlc_coordinator():
    uri = os.environ.get('DMLC_PS_ROOT_URI')
    port = os.environ.get('DMLC_PS_ROOT_PORT', '9000')
    if uri:
        return f"{uri}:{port}"
    _log.warning(
        "dist.init: no coordinator address configured — looked for "
        "MXNET_TPU_COORDINATOR, then DMLC_PS_ROOT_URI[:DMLC_PS_ROOT_PORT] "
        "— falling back to localhost:12345 (fine on one host; workers on "
        "other hosts wait at init until one of those names rank 0)")
    return 'localhost:12345'


def _default_device(rank):
    """This rank's device: the CPU without a card, else card
    ``rank % device_count()``."""
    if not torch.cuda.is_available():
        return torch.device('cpu')
    return torch.device('cuda', rank % torch.cuda.device_count())


def _make_store(coordinator, world, rank, timeout):
    if coordinator.startswith('file://'):
        return tdist.FileStore(coordinator[len('file://'):], world)
    addr = coordinator[len('tcp://'):] if coordinator.startswith('tcp://') \
        else coordinator
    host, port = addr.rsplit(':', 1)
    return tdist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timedelta(seconds=timeout))


def _card_key(d):
    """What identifies a card across processes of one host."""
    if d.type != 'cuda':
        return None
    try:
        return str(torch.cuda.get_device_properties(d).uuid)
    except Exception:
        return f'cuda:{d.index}'


def _resolve_backend(requested, devs, hosts_, cards):
    """The process group's backend for a world whose ranks hold
    ``devs``: gloo on the CPU, NCCL with one card per rank; ranks that
    share a card need ``backend='gloo'`` asked for by name."""
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise MXNetError(f"dist.init: the ranks' devices mix "
                         f"{sorted(kinds)}; a world is all CPU or all CUDA")
    seen, shared = {}, []
    for r, (h, c) in enumerate(zip(hosts_, cards)):
        if c is not None:
            if (h, c) in seen:
                shared.append((seen[(h, c)], r, devs[r]))
            seen.setdefault((h, c), r)
    if requested is not None:
        if requested not in ('gloo', 'nccl'):
            raise MXNetError(f"dist.init: backend {requested!r}: the port "
                             f"runs 'gloo' or 'nccl'")
        if requested == 'nccl' and (kinds == {'cpu'} or shared):
            why = 'the ranks are on the CPU' if kinds == {'cpu'} else \
                f'ranks {shared[0][0]} and {shared[0][1]} share ' \
                f'{shared[0][2]}'
            raise MXNetError(f"dist.init: NCCL needs one card per rank; "
                             f"{why}")
        return requested
    if kinds == {'cpu'}:
        return 'gloo'
    if shared:
        a, b, d = shared[0]
        raise MXNetError(
            f"dist.init: ranks {a} and {b} share {d} on one host; NCCL "
            f"refuses two ranks on one card (Duplicate GPU detected). Give "
            f"each rank its own card, or pass backend='gloo' to run the "
            f"world through host memory")
    return 'nccl'


def init(coordinator=None, num_processes=None, process_id=None,
         local_device_ids=None, backend=None, device=None, timeout=120.0):
    """Join the world from the arguments or the environment (see the
    module docstring). ``device`` (or ``local_device_ids``, the JAX
    name: one card index) is this rank's device, by default card
    ``rank % device_count()``, or the CPU without a card. A world of one
    process makes no process group. ``timeout`` bounds the rendezvous
    and every collective, in seconds."""
    global _world
    if _world is not None:
        return
    from .. import config as _config
    from ..resilience.retry import retry_call
    _, world, rank_ = _resolve_world(None, num_processes, process_id,
                                     need_coordinator=False)
    if device is None and local_device_ids is not None:
        ids = local_device_ids if isinstance(local_device_ids,
                                             (list, tuple)) \
            else [local_device_ids]
        device = torch.device('cuda', int(ids[0]))
    dev = torch.device(device) if device is not None else \
        _default_device(rank_)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    host = socket.gethostname()
    if world <= 1:
        _world = dict(rank=0, size=1, device=dev, devices=[dev],
                      hosts=[host], backend=None)
        return
    coordinator, _, _ = _resolve_world(coordinator, world, rank_)
    store = retry_call(
        _make_store, coordinator, world, rank_, timeout,
        retries=_config.get('MXTPU_DIST_INIT_RETRIES'),
        backoff_seconds=0.25,
        retry_on=(RuntimeError, ConnectionError, OSError),
        give_up_on=(MXNetError,), site='dist.init')
    # every rank's host and device, so the backend is chosen from the
    # whole world, the same on every rank
    store.set(f'mxtt/rank{rank_}', f'{host}|{dev}|{_card_key(dev) or ""}')
    store.wait([f'mxtt/rank{r}' for r in range(world)],
               timedelta(seconds=timeout))
    facts = [store.get(f'mxtt/rank{r}').decode().split('|')
             for r in range(world)]
    hosts_ = [f[0] for f in facts]
    devs = [torch.device(f[1]) for f in facts]
    cards = [f[2] or None for f in facts]
    chosen = _resolve_backend(backend, devs, hosts_, cards)
    kw = dict(device_id=dev) if chosen == 'nccl' else {}
    tdist.init_process_group(chosen, store=store, rank=rank_,
                             world_size=world,
                             timeout=timedelta(seconds=timeout), **kw)
    _world = dict(rank=rank_, size=world, device=dev, devices=devs,
                  hosts=hosts_, backend=chosen)


def shutdown(timeout=5.0):
    """Leave the world (the process group is destroyed). Returns True."""
    global _world
    if _world is not None and _world['backend'] is not None and \
            tdist.is_initialized():
        tdist.destroy_process_group()
    _world = None
    return True


def rank():
    return _world['rank'] if _world is not None else 0


def num_workers():
    return _world['size'] if _world is not None else 1


def device():
    """This rank's device (the current CUDA device outside a world)."""
    if _world is not None:
        return _world['device']
    from ..context import resolve_device
    return torch.device(resolve_device(None))


def devices():
    """Every rank's device, by rank."""
    return list(_world['devices']) if _world is not None else [device()]


def hosts():
    """Every rank's host name, by rank."""
    return list(_world['hosts']) if _world is not None else \
        [socket.gethostname()]


def backend():
    """'gloo', 'nccl', or None outside a world of more than one rank."""
    return _world['backend'] if _world is not None else None


def host_topology(ranks=None):
    """``[(host_index, [rank, ...]), ...]``: ``ranks`` (default: the
    world, in order) grouped into runs by the host they run on, as the
    JAX package groups devices by their process. Contiguous runs only:
    an order that interleaves hosts yields more groups than hosts, which
    ``dp_host_split`` treats as no clean hierarchy."""
    names = hosts()
    ranks = list(range(len(names))) if ranks is None else list(ranks)
    index = {}
    groups = []
    for r in ranks:
        h = index.setdefault(names[r], len(index))
        if groups and groups[-1][0] == h:
            groups[-1][1].append(r)
        else:
            groups.append((h, [r]))
    return groups


def dp_host_split(ranks=None, force=None):
    """(n_hosts, ranks_per_host) of a dp run of ``ranks``, or (1, n)
    where there is no clean hierarchy. ``force`` (or
    ``MXTPU_HIERARCHICAL_DP`` when None): 0 detects from the hosts, 1
    forces flat; a forced split (N >= 2) raises, since hierarchical dp
    is ROADMAP queue 1 item 8."""
    from .. import config as _config
    groups = host_topology(ranks)
    n = sum(len(rs) for _h, rs in groups)
    if force is None:
        force = int(_config.get('MXTPU_HIERARCHICAL_DP') or 0)
    force = int(force)
    if force >= 2:
        raise MXNetError(f"MXTPU_HIERARCHICAL_DP={force}: a forced "
                         f"hierarchical dp split is not ported (ROADMAP "
                         f"queue 1 item 8)")
    if force == 1 or n <= 1:
        return 1, n
    sizes = {len(rs) for _h, rs in groups}
    hs = {h for h, _rs in groups}
    if len(groups) <= 1 or len(sizes) != 1 or len(hs) != len(groups):
        return 1, n
    return len(groups), n // len(groups)


def barrier(tag='barrier', timeout=None):
    """Every rank waits for every other (no-op in a world of one). The
    ``dist.barrier`` fault site fires on entry, in a world of one too."""
    from ..resilience import faults as _faults
    _faults.fire('dist.barrier')
    if num_workers() > 1:
        if backend() == 'nccl':
            tdist.barrier(device_ids=[device().index])
        else:
            tdist.barrier()
    return None


def launch_local(script, n=2, env=None, coordinator='localhost:29500',
                 raw_command=False, timeout=None):
    """Spawn ``n`` local worker processes (the ``--launcher local`` of
    tools/launch.py), each with MXNET_TPU_COORDINATOR, _NUM_PROCS and
    _PROC_ID set; returns their exit codes. ``raw_command`` runs
    ``script`` verbatim, else it is a python argv run under this
    interpreter. With ``timeout`` (seconds, for the whole world) every
    worker still running then is killed and its code is None."""
    procs = []
    cmd = list(script) if raw_command else [sys.executable] + list(script)
    try:
        for i in range(n):
            e = dict(os.environ)
            e.update(env or {})
            e['MXNET_TPU_COORDINATOR'] = coordinator
            e['MXNET_TPU_NUM_PROCS'] = str(n)
            e['MXNET_TPU_PROC_ID'] = str(i)
            procs.append(subprocess.Popen(cmd, env=e))
        deadline = None if timeout is None else time.monotonic() + timeout
        codes = []
        for p in procs:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                codes.append(None)
        return codes
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _not_ported(what):
    raise MXNetError(f"{what}: the elastic membership layer is not ported "
                     f"(ROADMAP queue 1 item 10)")


def start_membership(*args, **kwargs):
    _not_ported('dist.start_membership')


def membership():
    """None: the port has no membership layer (item 10)."""
    return None


def reinit(*args, **kwargs):
    _not_ported('dist.reinit (elastic re-form)')
