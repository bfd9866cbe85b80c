"""Fault-tolerant async CheckpointManager (counterpart of
``mxnet_tpu/checkpoint/manager.py``).

- **Async**: ``save(step)`` snapshots params + optimizer state + step +
  RNG state on the calling (training) thread, then a background thread
  serializes, hashes and commits. The snapshot of a tensor on the card
  is an asynchronous copy into pinned host memory on the current stream,
  so it is ordered before any later step that rewrites the tensor in
  place, and the training thread does not wait for it: the writer thread
  waits for the copies' event. The pinned buffers are the manager's,
  allocated at its first save and reused by every later one (the
  previous write has finished with them by then). A trainer that offers ``states_doc``
  (``parallel.ShardedTrainStep``) hands over its states payload as
  tensors copied the same way, and the writer pickles it. Telemetry
  reports both sides under the JAX names:
  ``mxnet_tpu_checkpoint_blocked_seconds`` (training thread) and
  ``mxnet_tpu_checkpoint_save_seconds`` (end to end).
- **Atomic**: per-array reference-format files (bfloat16 under the JAX
  package's type flag) + a JSON manifest with sha256 content hashes are
  written into ``step_NNNNNNNNNN.tmp-<pid>`` and committed with one
  ``os.replace`` (see manifest.py). A kill at any instant leaves either
  the previous committed checkpoint intact or a tmp dir that readers
  never look at.
- **Retention**: keep-last-N plus keep-every-K-steps; GC deletes only
  committed-but-expired steps and sweeps stale tmp dirs left by killed
  processes; a re-save of a committed step that died mid-swap is rolled
  back by the next manager.
- **Preemption-safe resume**: ``restore_latest()`` re-verifies every
  content hash and falls back to the previous committed step on
  corruption; ``install_preemption_hook()`` wires SIGTERM to an
  immediate synchronous ``save_now()``.

The directory layout and the payloads are the JAX package's: the arrays
keyed by the block's structured names (``_collect_params_with_prefix``),
the states blob the trainer's ``get_states_bytes`` (``Trainer``, or the
``sharded_train_step_v1`` payload of ``ShardedTrainStep``, whose names
cross between the packages through ``parallel.rename_states``), so either
package validates and reads the other's steps. Bound to a
``ShardedTrainStep`` (``trainer=step``, ``params=step.block``) the
parameters are read through ``step.full_parameters()`` and written back
through ``step.load_full_parameters()``: under ZeRO-3 a parameter's own
tensor holds no storage between steps. Every restore writes in place, so
a captured CUDA graph stays valid.

Peer replication needs the membership world of ROADMAP queue 1 item 10.
As in the JAX package with no membership world, a manager attaches
nothing; an explicit ``attach_replication`` raises and names item 10.
"""
from __future__ import annotations

import os
import pickle
import shutil
import signal as _signal
import threading
import time as _time
import warnings
import weakref
from typing import Any, Dict, Optional

import numpy as onp

from ..base import MXNetError, telem_flags as _telem
from ..resilience import faults as _faults
from ..resilience.faults import InjectedFault
from ..resilience.retry import retry_call
from ..telemetry import metrics as _metrics, trace as _trace
from . import manifest as mf
from .manifest import CorruptCheckpointError

__all__ = ['CheckpointManager', 'RestoredCheckpoint',
           'CorruptCheckpointError', 'last_committed_step']

# every live manager, weakly: the /healthz endpoint reports the newest
# committed step without holding a reference into any training loop
_live_managers: 'weakref.WeakSet' = weakref.WeakSet()


def last_committed_step() -> Optional[int]:
    """Newest committed step across every live CheckpointManager in this
    process (the /healthz "can this rank resume, and from where" answer).
    None when no manager exists or nothing is committed."""
    best = None
    for mgr in list(_live_managers):
        try:
            s = mgr.latest_step()
        except Exception:
            continue
        if s is not None and (best is None or s > best):
            best = s
    return best


# test-only fault-injection points: name -> fn(path)
#   'after_arrays'     — payload files written, manifest not yet
#   'before_commit'    — manifest written, final os.replace not yet
#   'during_write'     — once per payload file, before its bytes hit disk
#   'after_retire_old' — a re-save's committed copy moved aside
_TEST_HOOKS: Dict[str, Any] = {}


def _run_hook(name: str, path: str) -> None:
    fn = _TEST_HOOKS.get(name)
    if fn is not None:
        fn(path)


class _HostCopies:
    """The device->host copies of one snapshot, into the manager's host
    buffers (``pool``, one per tensor in the order the snapshot copies
    them, reused from one save to the next: the previous write has
    finished with them before the next snapshot starts). A tensor on the
    card is copied into pinned memory without waiting, on the current
    stream; ``wait`` (the writer thread) waits for all of them. A CPU
    tensor is copied at once."""

    def __init__(self, pool):
        self._pool = pool
        self._n = 0
        self._event = None

    def __call__(self, t):
        import torch
        from ..serialization import to_numpy
        t = t.detach()
        cuda = t.device.type == 'cuda'
        k, self._n = self._n, self._n + 1
        h = self._pool[k] if k < len(self._pool) else None
        if h is None or h.shape != t.shape or h.dtype != t.dtype or \
                h.is_pinned() != cuda:
            # pinning host memory is slow: done once per buffer
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            if k < len(self._pool):
                self._pool[k] = h
            else:
                self._pool.append(h)
        h.copy_(t, non_blocking=cuda)
        if cuda and self._event is None:
            self._event = torch.cuda.Event()
        return to_numpy(h)

    def record(self):
        if self._event is not None:
            self._event.record()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()


def _value_tensor(v):
    """The tensor behind a Parameter (Gluon or torch), an NDArray or a
    tensor; None for anything else."""
    import torch
    from ..gluon.parameter import Parameter
    from ..ndarray.ndarray import NDArray
    if isinstance(v, Parameter):
        if not v._is_materialized():
            raise MXNetError(f"checkpoint: parameter '{v.name}' is "
                             f"uninitialized")
        return v.tensor
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return None


def _params_dict(target):
    """A params-like object as {name: value}: a Gluon Block by structured
    name, another ``torch.nn.Module`` by ``named_parameters()``, a
    ParameterDict or a dict as it is; a zero-arg callable is called."""
    import torch
    if target is None:
        return {}
    if callable(target) and not hasattr(target, 'items') \
            and not isinstance(target, torch.nn.Module):
        target = target()
    if hasattr(target, '_collect_params_with_prefix'):   # Gluon Block
        return target._collect_params_with_prefix()
    if isinstance(target, torch.nn.Module):
        return dict(target.named_parameters())
    if not hasattr(target, 'items'):
        raise MXNetError(
            f"checkpoint params must be a Block, a torch Module, a "
            f"ParameterDict or a dict, got {type(target)}")
    return dict(target.items())


def _snapshot_params(target, host) -> Dict[str, Any]:
    """{name: host array} of a params-like object: a tensor's through
    ``host`` (the device->host copy, the only work the training thread
    pays for an async save), plain numpy by copy (numpy is mutable in
    place: an alias would let the writer serialize a torn state)."""
    out = {}
    for name, v in _params_dict(target).items():
        t = _value_tensor(v)
        out[str(name)] = host(t) if t is not None else \
            onp.array(v, copy=True)
    return out


def _apply_params(target, loaded: Dict[str, onp.ndarray], strict: bool):
    """Write restored host arrays into a params-like object, in place."""
    import torch
    from ..gluon.parameter import Parameter
    from ..ndarray.ndarray import NDArray
    from ..serialization import to_tensor
    if callable(target) and not hasattr(target, 'items') \
            and not isinstance(target, torch.nn.Module):
        # a zero-arg provider is snapshot-only: writing into the dict it
        # RETURNS would be a silent no-op on the real model state
        raise MXNetError(
            "checkpoint restore: params are bound as a callable provider, "
            "which only supports saving — restore with apply=False and "
            "apply the arrays yourself")
    params = _params_dict(target)
    for name, p in params.items():
        if name not in loaded:
            if strict:
                raise MXNetError(
                    f"checkpoint restore: parameter '{name}' missing from "
                    f"checkpoint (pass strict=False to skip)")
            continue
        v = to_tensor(loaded[name])
        if isinstance(p, Parameter):
            p.set_data(v)
        elif isinstance(p, NDArray):
            with torch.no_grad():
                p._data.copy_(v)
        elif isinstance(p, torch.Tensor):
            with torch.no_grad():
                p.copy_(v)
        elif hasattr(target, 'items'):
            target[name] = loaded[name]


class _Deferred:
    """A blob the writer thread makes: the states payload pickled after
    its host copies land."""

    __slots__ = ('fn',)

    def __init__(self, fn):
        self.fn = fn


class RestoredCheckpoint:
    """What ``restore_latest(apply=False)`` hands back: the committed step
    plus the validated payloads (host numpy params, opaque state blobs,
    manifest metadata, RNG state)."""

    def __init__(self, step, directory, params, blobs, metadata, rng):
        self.step = step
        self.directory = directory
        self.params = params          # {name: numpy}
        self.blobs = blobs            # {name: bytes} ('trainer_states', ...)
        self.metadata = metadata
        self.rng = rng

    @property
    def trainer_states(self) -> Optional[bytes]:
        return self.blobs.get('trainer_states')

    def __repr__(self):
        return (f"<RestoredCheckpoint step={self.step} "
                f"arrays={len(self.params)} blobs={sorted(self.blobs)}>")


class CheckpointManager:
    """Async, atomic, retained checkpoints for a training loop.

    ::

        mgr = checkpoint.CheckpointManager(
            'ckpts/', params=net, trainer=trainer,
            keep_last_n=3, keep_every_k_steps=1000, autosave_steps=500)
        mgr.install_preemption_hook()            # SIGTERM -> save_now()
        start = mgr.restore_latest() or 0        # resume (0 on fresh run)
        for step in range(start, total):
            ... train ...
            mgr.maybe_save(step + 1)             # autosave cadence
        mgr.close()

    ``trainer`` is a ``gluon.Trainer`` or a ``parallel.ShardedTrainStep``.
    ``restore_latest()`` returns the restored step number when ``params``
    / ``trainer`` are bound (state applied in place), or a
    ``RestoredCheckpoint`` when called with ``apply=False``.
    """

    def __init__(self, directory: str, params=None, trainer=None,
                 keep_last_n: int = 3, keep_every_k_steps: Optional[int] = None,
                 autosave_steps: Optional[int] = None,
                 autosave_seconds: Optional[float] = None,
                 async_save: bool = True, save_rng: bool = True):
        if keep_last_n < 1:
            raise MXNetError("keep_last_n must be >= 1 (the latest "
                             "checkpoint can never be retention-expired)")
        if keep_every_k_steps is not None and keep_every_k_steps < 1:
            raise MXNetError("keep_every_k_steps must be >= 1")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._params = params
        self._trainer = trainer
        self.keep_last_n = int(keep_last_n)
        self.keep_every_k_steps = keep_every_k_steps
        self.autosave_steps = autosave_steps
        self.autosave_seconds = autosave_seconds
        self.async_save = bool(async_save)
        self.save_rng = bool(save_rng)
        self.preempted = False
        self._current_step = None
        # a provider whose dict (the data position) rides every manifest
        # under meta['data'] — see bind_data_state
        self._data_state = None
        self.last_restored_metadata = None
        # the last save's and restore's seconds (the telemetry histograms'
        # samples, kept for callers that print them)
        self.last_blocked_seconds = None
        self.last_save_seconds = None
        self.last_restore_seconds = None
        self._last_autosave_time = _time.monotonic()
        self._pending: Optional[threading.Thread] = None
        self._host_pool = []      # the snapshots' host buffers (_HostCopies)
        self._error: Optional[BaseException] = None
        # RLock: a SIGTERM arriving while the main thread is inside save()
        # re-enters via the handler's save_now() on the same thread
        self._lock = threading.RLock()    # serializes save entry points
        self._in_signal_save = False
        self._in_save = False
        self._old_handlers = {}
        # a crashed predecessor may have left partial tmp writes (swept)
        # or a half-finished same-step re-save swap (recovered); nothing
        # of ours is in flight yet, so pid-reuse leftovers go too
        self._recover_and_sweep(sweep_own=True)
        _live_managers.add(self)

    # -- introspection ----------------------------------------------------

    def all_steps(self):
        return mf.committed_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, mf.step_dir_name(step))

    # -- replication (ROADMAP queue 1 item 10) ----------------------------

    @property
    def replica(self):
        """The attached ReplicaManager: None (no membership world)."""
        return None

    @property
    def last_restore_source(self):
        """Where the last restore's bytes came from: None, the local
        directory (no replica fallback without item 10)."""
        return None

    def attach_replication(self, replica_manager) -> None:
        raise MXNetError(
            "CheckpointManager.attach_replication: peer replication runs "
            "over the membership side channel, which is not ported "
            "(ROADMAP queue 1 item 10)")

    # -- data-position state ----------------------------------------------

    def bind_data_state(self, provider) -> None:
        """Bind a callable returning the data-position state dict, recorded
        in every manifest under ``metadata['data']`` beside the ``world``
        metadata. Read it back after a restore from
        ``last_restored_metadata['data']``."""
        self._data_state = provider

    def bind_params(self, params) -> None:
        """(Re)bind the params provider that save() snapshots: a Block,
        ParameterDict, dict, or a zero-arg callable returning one (None
        unbinds). Callable providers are snapshot-only — restore them with
        ``apply=False``."""
        self._params = params

    @property
    def params_bound(self) -> bool:
        return self._params is not None

    def bind_trainer(self, trainer) -> None:
        """(Re)bind the trainer whose states payload rides every step (a
        ``gluon.Trainer`` or a ``ShardedTrainStep``): a step built with
        ``guard=NonFiniteGuard(manager=mgr)`` exists only after the
        manager does."""
        self._trainer = trainer

    # -- save -------------------------------------------------------------

    def save(self, step: int, params=None, states: Optional[bytes] = None,
             metadata: Optional[dict] = None, block: bool = False,
             extra_blobs: Optional[Dict[str, bytes]] = None) -> None:
        """Checkpoint `step`. Snapshots state on the calling thread, then
        (async mode) hands the write to a background thread. `params` /
        `states` override the bound providers for this call only;
        `extra_blobs` adds opaque byte payloads that ride in the manifest
        next to the trainer states."""
        t_blocked0 = _time.perf_counter()
        with self._lock:
            self._current_step = int(step)
            # back-pressure: at most one write in flight — a second save
            # waits for the first (that wait is honest blocked time)
            self._join_pending()
            # a previous async write's failure surfaces here, after its
            # thread is joined
            self._reraise_write_error()
            self._in_save = True
            try:
                with _trace.span('checkpoint.snapshot', step=int(step)):
                    snapshot = self._snapshot(step, params, states,
                                              metadata, extra_blobs)
                if self.async_save and not block:
                    t = threading.Thread(
                        target=self._write_and_commit,
                        args=(snapshot, _time.perf_counter()),
                        name=f'ckpt-write-{step}', daemon=True)
                    self._pending = t
                    t.start()
                else:
                    self._write_and_commit(snapshot, _time.perf_counter())
                    self._reraise_write_error()
            finally:
                self._in_save = False
        blocked = _time.perf_counter() - t_blocked0
        self.last_blocked_seconds = blocked
        self._last_autosave_time = _time.monotonic()
        if _telem['on']:
            _metrics.observe('mxnet_tpu_checkpoint_blocked_seconds', blocked)

    def save_now(self, step: Optional[int] = None, **kwargs) -> None:
        """Synchronous save (used by the SIGTERM hook): returns only once
        the checkpoint is committed and durable."""
        if step is None:
            step = self._current_step
        if step is None:
            raise MXNetError("save_now: no step given and no prior save/"
                             "maybe_save call to infer it from")
        self.save(step, block=True, **kwargs)

    def save_due(self, step: int) -> bool:
        """Would the autosave cadence save at `step`? (The guard's
        maybe_save gates the actual save on the step's flag.)"""
        if self.autosave_steps and step % self.autosave_steps == 0:
            return True
        if self.autosave_seconds is not None and \
                _time.monotonic() - self._last_autosave_time \
                >= self.autosave_seconds:
            return True
        if self.preempted and self.latest_step() != int(step):
            return True
        return False

    def maybe_save(self, step: int, metadata: Optional[dict] = None) -> bool:
        """Autosave cadence: call once per training step. Saves when the
        steps/seconds cadence fires (or a preemption signal arrived before
        the hook could save synchronously). Returns True when it saved."""
        self._current_step = int(step)
        due = self.save_due(int(step))
        if due:
            self.save(step, metadata=metadata, block=self.preempted)
        return due

    def wait(self) -> None:
        """Block until any in-flight async write has committed."""
        with self._lock:
            self._join_pending()
        self._reraise_write_error()

    def _join_pending(self):
        t = self._pending
        if t is not None and t.is_alive():
            t.join()
        self._pending = None

    def _reraise_write_error(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise MXNetError(
                f"checkpoint background write failed: {err!r}") from err

    def _through_step(self, params):
        """The bound ShardedTrainStep when ``params`` is its block (its
        parameters are read and written through the step)."""
        tr = self._trainer
        if params is not None and tr is not None and \
                hasattr(tr, 'full_parameters') and \
                getattr(tr, 'block', None) is params:
            return tr
        return None

    def _snapshot(self, step, params, states, metadata,
                  extra_blobs=None) -> dict:
        host = _HostCopies(self._host_pool)
        target = params if params is not None else self._params
        via = self._through_step(target)
        arrays = _snapshot_params(via.full_parameters if via is not None
                                  else target, host)
        blobs = dict(extra_blobs or {})
        if states is not None:
            blobs['trainer_states'] = states
        elif self._trainer is not None:
            doc = getattr(self._trainer, 'states_doc', None)
            if doc is not None:
                doc = doc(host)
                blobs['trainer_states'] = _Deferred(
                    lambda doc=doc: pickle.dumps(doc))
            else:
                blobs['trainer_states'] = self._trainer.get_states_bytes()
        host.record()
        rng = None
        if self.save_rng:
            from .. import random as _random
            rng = _random.get_state(self._rng_module())
        meta = dict(metadata or {})
        # the world this step was committed under (bookkeeping: the
        # payloads are gathered to whole tensors, so any world restores)
        try:
            from ..parallel import dist as _dist
            meta.setdefault('world', {'processes': int(_dist.num_workers()),
                                      'rank': int(_dist.rank())})
        except Exception:
            pass
        if self._data_state is not None:
            try:
                ds = self._data_state()
                if ds is not None:
                    meta.setdefault('data', dict(ds))
            except Exception:
                pass
        if 'trainer_states' in blobs and self._trainer is not None:
            # the states payload is always gathered to whole host tensors,
            # so a checkpoint restores at any dp and under any ZeRO stage;
            # record the layout it was written under
            tr = self._trainer
            stage = int(getattr(tr, 'zero_stage', 0) or
                        (1 if getattr(tr, '_zero_active', False) else 0))
            meta.setdefault('optimizer_state_layout', {
                'format': 'gathered-host', 'zero1': stage >= 1,
                'stage': stage,
                'dp': int(getattr(tr, '_dp', 0)
                          or getattr(tr, '_zero_dp', 1))})
        return {'step': int(step), 'arrays': arrays, 'blobs': blobs,
                'rng': rng, 'metadata': meta, 'host': host}

    def _rng_module(self):
        """The block whose modules' generators ride the RNG state."""
        import torch
        p = self._params
        return p if isinstance(p, torch.nn.Module) else \
            getattr(self._trainer, 'block', None)

    def _write_and_commit(self, snap: dict, t_start: float) -> None:
        try:
            snap['host'].wait()
            # transient FS errors (and injected checkpoint.write raise
            # faults) get a bounded retry: _write_step rebuilds its tmp
            # dir from scratch every attempt, so a retry is idempotent
            from .. import config as _config
            with _trace.span('checkpoint.write', step=snap['step']):
                total_bytes = retry_call(
                    self._write_step, snap,
                    retries=_config.get('MXTPU_CHECKPOINT_WRITE_RETRIES'),
                    retry_on=(OSError, InjectedFault),
                    site='checkpoint.write')
        except BaseException as e:  # surfaced on the training thread
            self._error = e
            # a failed same-step re-save may have retired the committed
            # copy aside (.old-) — roll it back now so the LIVE manager
            # still sees the step (single writer: nothing else in flight)
            try:
                self._recover_and_sweep(sweep_own=True)
            except OSError:
                pass
            return
        self.last_save_seconds = _time.perf_counter() - t_start
        if _telem['on']:
            _metrics.observe('mxnet_tpu_checkpoint_save_seconds',
                             self.last_save_seconds)
            _metrics.inc('mxnet_tpu_checkpoint_saves_total')
            _metrics.set_gauge('mxnet_tpu_checkpoint_bytes', total_bytes)
            _metrics.set_gauge('mxnet_tpu_checkpoint_last_step',
                               snap['step'])

    def _write_step(self, snap: dict) -> int:
        from ..serialization import save_ndarray_file
        # fault site: 'raise' is retried by _write_and_commit as a
        # transient FS error; 'corrupt' mangles the first payload's bytes
        # AFTER hashing, producing a committed-but-invalid step that
        # restore_latest() must fall back past
        fault = _faults.fire('checkpoint.write')
        step = snap['step']
        blobs = snap['blobs']
        for name, data in list(blobs.items()):
            if isinstance(data, _Deferred):
                blobs[name] = data.fn()
        final = self.step_dir(step)
        tmp = f'{final}.tmp-{os.getpid()}'
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, 'arrays'))
        os.makedirs(os.path.join(tmp, 'blobs'))
        total = 0
        arr_entries = []
        for i, (name, arr) in enumerate(snap['arrays'].items()):
            rel = f'arrays/a{i:05d}.nd'
            payload = save_ndarray_file({name: arr})
            _run_hook('during_write', os.path.join(tmp, rel))
            written = payload
            if fault == 'corrupt' and i == 0:
                written = _faults.corrupt_bytes(payload)
            mf.write_bytes_durable(os.path.join(tmp, rel), written)
            arr_entries.append({
                'name': name, 'file': rel, 'bytes': len(payload),
                'sha256': mf.sha256_bytes(payload),
                'shape': list(arr.shape),
                'dtype': 'bfloat16' if _is_bf16(arr) else str(arr.dtype)})
            total += len(payload)
        blob_entries = []
        for name, data in blobs.items():
            if '/' in name or os.sep in name or name.startswith('.'):
                raise MXNetError(f"checkpoint blob name {name!r} must be "
                                 f"a plain filename component")
            rel = f'blobs/{name}.bin'
            _run_hook('during_write', os.path.join(tmp, rel))
            mf.write_bytes_durable(os.path.join(tmp, rel), data)
            blob_entries.append({
                'name': name, 'file': rel, 'bytes': len(data),
                'sha256': mf.sha256_bytes(data)})
            total += len(data)
        _run_hook('after_arrays', tmp)
        mf.write_manifest(tmp, {
            'step': step, 'arrays': arr_entries, 'blobs': blob_entries,
            'rng': snap['rng'], 'metadata': snap['metadata'],
            'save_time_unix': _time.time(), 'total_bytes': total})
        mf.fsync_dir(os.path.join(tmp, 'arrays'))
        mf.fsync_dir(os.path.join(tmp, 'blobs'))
        mf.fsync_dir(tmp)
        _run_hook('before_commit', tmp)
        # the commit point: one rename makes the whole step visible.
        # Re-saving an existing step cannot swap atomically (rename(2)
        # refuses non-empty targets), so the committed copy is retired
        # aside first and deleted only after the new copy commits — a
        # crash anywhere in between is recovered from the .old dir by the
        # next manager's _recover_and_sweep.
        old = None
        if os.path.isdir(final):
            old = f'{final}.old-{os.getpid()}'
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.replace(final, old)
            _run_hook('after_retire_old', old)
        os.replace(tmp, final)
        mf.fsync_dir(self.directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        self._gc()
        return total

    # -- retention / GC ---------------------------------------------------

    def _retained(self, steps):
        keep = set(steps[-self.keep_last_n:])
        if self.keep_every_k_steps:
            keep.update(s for s in steps
                        if s % self.keep_every_k_steps == 0)
        return keep

    def _gc(self) -> int:
        """Delete committed-but-expired steps per the retention policy.
        Only ever touches committed dirs (and stale tmp dirs from dead
        writers) — never the in-flight write."""
        steps = self.all_steps()
        keep = self._retained(steps)
        expired = [s for s in steps if s not in keep]
        for s in expired:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
        removed = len(expired)
        # quarantined copies (corruption evidence) expire with their
        # step's retention
        for qpath, qstep in mf.quarantined_dirs(self.directory):
            if qstep not in keep:
                shutil.rmtree(qpath, ignore_errors=True)
        removed_tmp = self._recover_and_sweep(sweep_own=True)
        if removed and _telem['on']:
            _metrics.inc('mxnet_tpu_checkpoint_gc_total', removed)
        return removed + removed_tmp

    def _recover_and_sweep(self, sweep_own: bool = False) -> int:
        """Handle leftovers of dead writers: recover a committed step
        whose re-save swap died mid-way (``.old-`` dir present, final dir
        missing → rename the old copy back), then sweep stale ``.tmp-``
        partial writes and superseded ``.old-`` copies."""
        n = 0
        for old, final in mf.stale_old_dirs(self.directory):
            if not os.path.isdir(final):
                try:
                    os.replace(old, final)   # the swap died: roll back
                    continue
                except OSError:
                    pass
            shutil.rmtree(old, ignore_errors=True)
            n += 1
        mine = f'.tmp-{os.getpid()}'
        for path in mf.stale_tmp_dirs(self.directory):
            if not sweep_own and path.endswith(mine):
                continue   # could be this process's own in-flight write
            shutil.rmtree(path, ignore_errors=True)
            n += 1
        return n

    # -- restore ----------------------------------------------------------

    def restore_latest(self, apply: bool = True, strict: bool = True,
                       restore_rng: bool = True):
        """Restore the newest committed checkpoint that passes full hash
        validation, falling back step by step on corruption.

        Returns None when the directory holds no committed checkpoint;
        raises CorruptCheckpointError when checkpoints exist but every one
        fails validation. With ``apply=True`` (default) the restored state
        is written into the bound ``params`` / ``trainer`` and the RNG
        streams, and the step number is returned; with ``apply=False`` the
        raw ``RestoredCheckpoint`` is returned instead."""
        self.wait()
        steps = self.all_steps()
        if not steps:
            return None
        for step in reversed(steps):
            try:
                return self.restore(step, apply=apply, strict=strict,
                                    restore_rng=restore_rng)
            except CorruptCheckpointError as e:
                if _telem['on']:
                    _metrics.inc('mxnet_tpu_checkpoint_corrupt_total')
                warnings.warn(
                    f"checkpoint step {step} failed validation, falling "
                    f"back to the previous committed step: {e}",
                    RuntimeWarning)
        raise CorruptCheckpointError(
            f"no checkpoint under {self.directory} passed validation "
            f"(tried steps {list(reversed(steps))})")

    def restore(self, step: int, apply: bool = True, strict: bool = True,
                restore_rng: bool = True):
        """Restore one committed step (hash-verified). See restore_latest."""
        t0 = _time.perf_counter()
        with _trace.span('checkpoint.restore', step=int(step)):
            ck = self._load_step(step)
        # manifest metadata of the newest restore (world, optimizer layout,
        # data position, and how the RNG streams came back)
        self.last_restored_metadata = dict(ck.metadata or {})
        if apply:
            from ..telemetry import memory as _memory
            target = self._params
            with _memory.oom_guard('checkpoint.restore'):
                via = self._through_step(target)
                if via is not None:
                    via.load_full_parameters(ck.params, strict)
                elif target is not None:
                    _apply_params(target, ck.params, strict)
                elif strict and ck.params:
                    raise MXNetError(
                        "checkpoint restore: no params bound to this "
                        "manager; construct with params=... or call with "
                        "apply=False")
                if self._trainer is not None and \
                        ck.trainer_states is not None:
                    self._trainer.set_states_bytes(ck.trainer_states)
            if restore_rng and ck.rng:
                from .. import random as _random
                self.last_restored_metadata['rng_restored'] = \
                    _random.set_state(ck.rng, self._rng_module())
        self.last_restore_seconds = _time.perf_counter() - t0
        if _telem['on']:
            _metrics.observe('mxnet_tpu_checkpoint_restore_seconds',
                             self.last_restore_seconds)
        return ck.step if apply else ck

    def _load_step(self, step: int) -> RestoredCheckpoint:
        """Single-pass read + hash-verify of one committed step dir."""
        from ..serialization import load_ndarray_file
        d = self.step_dir(step)
        doc = mf.read_manifest(d)
        if doc.get('step') != int(step):
            raise CorruptCheckpointError(
                f"{d}: manifest step {doc.get('step')} != dir step {step}")

        def _read_verified(entry):
            path = os.path.join(d, entry['file'])
            # fault site: 'corrupt' mangles the bytes AFTER the disk read
            # so the hash check below rejects them; 'raise' is wrapped
            # like any other read failure, so the restore scan falls back
            kind = _faults.fire('checkpoint.read')
            try:
                with open(path, 'rb') as f:
                    data = f.read()
            except OSError as e:
                raise CorruptCheckpointError(f"{path}: {e}")
            if kind == 'corrupt':
                data = _faults.corrupt_bytes(data)
            if len(data) != entry['bytes'] or \
                    mf.sha256_bytes(data) != entry['sha256']:
                raise CorruptCheckpointError(
                    f"{path}: content hash mismatch")
            return data

        # a manifest that parsed as JSON can still be garbage: every
        # structural surprise below is a CORRUPT STEP — restore_latest
        # skips past it with a warning — never a raw KeyError/TypeError
        try:
            params = {}
            for entry in doc.get('arrays', []):
                arrays, _names = load_ndarray_file(_read_verified(entry))
                params[entry['name']] = arrays[0]
            blobs = {entry['name']: _read_verified(entry)
                     for entry in doc.get('blobs', [])}
            step_no = doc['step']
        except CorruptCheckpointError:
            raise
        except InjectedFault as e:
            raise CorruptCheckpointError(f"{d}: {e}")
        except Exception as e:
            raise CorruptCheckpointError(
                f"{d}: malformed manifest/payload structure: {e!r}")
        return RestoredCheckpoint(step_no, d, params, blobs,
                                  doc.get('metadata', {}), doc.get('rng'))

    # -- preemption -------------------------------------------------------

    def install_preemption_hook(self, signals=(_signal.SIGTERM,)) -> None:
        """On each signal: synchronously commit a checkpoint at the
        current step, set ``self.preempted`` and chain any previous python
        handler. The training loop should poll ``preempted`` and exit. Off
        the main thread (where CPython forbids signal handlers) this warns
        and becomes a no-op instead of killing the training run."""
        for sig in signals:
            try:
                old = _signal.signal(sig, self._on_signal)
            except ValueError:
                warnings.warn(
                    "checkpoint preemption hook not installed: signal "
                    "handlers can only be set from the main thread — "
                    "SIGTERM will not trigger save_now() in this run",
                    RuntimeWarning)
                return
            self._old_handlers.setdefault(sig, old)

    @property
    def hook_installed(self) -> bool:
        """Whether a preemption signal hook is currently installed."""
        return bool(self._old_handlers)

    def uninstall_preemption_hook(self) -> None:
        for sig, old in self._old_handlers.items():
            _signal.signal(sig, old if old is not None else _signal.SIG_DFL)
        self._old_handlers.clear()

    def _on_signal(self, signum, frame):
        self.preempted = True
        # _in_save: the signal interrupted the main thread INSIDE save() —
        # re-entering would destroy that save's tmp dir mid-write; the
        # interrupted save commits this step when the handler returns
        if not self._in_save and not self._in_signal_save \
                and self._current_step is not None:
            self._in_signal_save = True
            try:
                # let an in-flight async write commit first: if it was
                # already saving this step, a second full write would
                # waste the preemption grace window
                try:
                    self.wait()
                except MXNetError:
                    pass   # the pending write failed — save fresh below
                if self.latest_step() != self._current_step:
                    self.save_now(self._current_step)
            finally:
                self._in_signal_save = False
        old = self._old_handlers.get(signum)
        if callable(old):
            old(signum, frame)

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Flush the in-flight write and unhook signals."""
        self.wait()
        self.uninstall_preemption_hook()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _is_bf16(arr):
    from ..serialization import is_bfloat16
    return is_bfloat16(arr)
