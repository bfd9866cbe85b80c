"""Non-finite guard: on-device detection, skip-step, auto-rollback
(counterpart of ``mxnet_tpu/resilience/guard.py``).

A single NaN step silently poisons a long run: the update applies, every
parameter becomes NaN, and nothing downstream says so. The guard closes
that hole in three layers, as the JAX package's does:

1. **On-device detection + skip**: the captured step (``gluon.Trainer``'s
   fused update, ``parallel.ShardedTrainStep``'s step) also reduces the
   finiteness of the loss and of every gradient into one flag on the
   device, copies the weights and optimizer state aside before the update
   and writes back ``torch.where(flag, new, old)`` after it: a
   non-finite step is a no-op on the device, inside the same CUDA graph,
   before the host knows, and a finite step's arithmetic is untouched.
   Under ZeRO the reduction runs over this rank's reduced
   (reduce-scattered) gradients and the flag is all-reduced over the
   world, so every rank skips the same step.
2. **Deferred host check**: the flag is a one-element tensor on the
   device that the guard reads at the START of the next step
   (``pre_step``): the step itself never waits on it.
3. **Policy ladder**: each bad step counts
   (``mxnet_tpu_resilience_bad_steps_total``); after
   ``max_consecutive_bad`` (default ``MXTPU_GUARD_MAX_BAD_STEPS`` = 3)
   consecutive bad steps the guard restores the newest committed
   checkpoint via ``CheckpointManager.restore_latest()`` — parameters,
   optimizer state, RNG streams and LR-scheduler position, written in
   place — and training continues from known-good state
   (``mxnet_tpu_resilience_rollbacks_total`` /
   ``_last_rollback_step`` / ``_recovery_seconds``).

Usage::

    mgr = checkpoint.CheckpointManager('ckpts/', params=net,
                                       trainer=trainer, autosave_steps=50)
    guard = resilience.NonFiniteGuard(manager=mgr)
    trainer.attach_guard(guard)
    for step in range(1, total + 1):
        ... forward / backward ...
        trainer.step(batch)          # on-device skip + flag for the guard
        guard.observe_loss(loss)     # optional: fold loss finiteness in
        guard.maybe_save(step)       # cadence save, gated on a good flag
"""
from __future__ import annotations

import logging
import time as _time

from ..base import MXNetError, telem_flags as _telem

__all__ = ['NonFiniteGuard', 'DeviceGate', 'finite_flag']

_log = logging.getLogger('mxnet_tpu_torch.resilience')


def finite_flag(tensors, loss=None):
    """[1.] on the device when the loss and every tensor are finite, else
    [0.]: one inf-norm per tensor (``_foreach_norm``), through which a
    NaN or an inf propagates, and one reduction of those."""
    import torch
    vals = [] if loss is None else [loss.detach().reshape(())]
    if tensors:
        vals += list(torch._foreach_norm(tensors, float('inf')))
    if not vals:
        return torch.ones(1)
    return torch.stack(vals).isfinite().all().reshape(1).float()


class DeviceGate:
    """The guard's half on the device, inside a captured update: ``copy``
    puts the gated tensors aside before the update (one multi-tensor copy
    per dtype), ``check`` sets the flag ``ok`` (f32 [1], 1 when finite)
    and ``select`` writes each tensor back as ``where(ok, new, old)``, in
    place. A finite step's values are the update's own, bit for bit."""

    def __init__(self, tensors, device):
        import torch
        self.tensors = list(tensors)
        self.old = [torch.empty_like(t) for t in self.tensors]
        by_dtype = {}
        for t, old in zip(self.tensors, self.old):
            dst, src = by_dtype.setdefault(t.dtype, ([], []))
            dst.append(old)
            src.append(t)
        self._copies = list(by_dtype.values())
        self.ok = torch.ones(1, dtype=torch.float32, device=device)

    def copy(self):
        import torch
        with torch.no_grad():
            for dst, src in self._copies:
                torch._foreach_copy_(dst, src)

    def check(self, grads, loss=None):
        import torch
        with torch.no_grad():
            self.ok.copy_(finite_flag(grads, loss))

    def select(self):
        import torch
        with torch.no_grad():
            good = self.ok[0] > 0
            for t, old in zip(self.tensors, self.old):
                torch.where(good, t, old, out=t)


class NonFiniteGuard:
    """Supervises one training loop. ``policy``:

    - ``'rollback'`` (default): skip bad steps on device; after
      ``max_consecutive_bad`` consecutive bad steps restore the newest
      committed checkpoint (requires ``manager``).
    - ``'skip'``: only skip (count forever, never restore).
    - ``'raise'``: raise MXNetError after ``max_consecutive_bad``
      consecutive bad steps (for jobs where a supervisor owns restarts).
    """

    def __init__(self, manager=None, max_consecutive_bad=None,
                 policy='rollback'):
        if policy not in ('rollback', 'skip', 'raise'):
            raise MXNetError(
                f"NonFiniteGuard policy must be 'rollback', 'skip' or "
                f"'raise', got {policy!r}")
        if policy == 'rollback' and manager is None:
            raise MXNetError(
                "NonFiniteGuard(policy='rollback') needs a "
                "CheckpointManager to restore from; pass manager=... or "
                "use policy='skip'")
        if max_consecutive_bad is None:
            from .. import config as _config
            max_consecutive_bad = _config.get('MXTPU_GUARD_MAX_BAD_STEPS')
        if int(max_consecutive_bad) < 1:
            raise MXNetError("max_consecutive_bad must be >= 1")
        self.manager = manager
        self.max_consecutive_bad = int(max_consecutive_bad)
        self.policy = policy
        self.consecutive_bad = 0
        self.bad_steps = 0
        self.rollbacks = 0
        self.last_rollback_step = None
        self._pending = []          # device bool scalars (or host bools)
        self._post_restore_hooks = []
        self._save_deferred = False

    # -- flag plumbing (called by Trainer / ShardedTrainStep) -------------

    def push_flag(self, finite_flag):
        """Record one step's on-device finiteness flag (a one-element
        tensor, true when finite, or a plain bool). Never blocks — the
        value is read at the next ``pre_step()`` / ``maybe_save()``."""
        self._pending.append(finite_flag)

    def observe_loss(self, loss):
        """Optionally fold a loss value's finiteness into the pending
        flag set (a tiny on-device reduction, read deferred like every
        other flag)."""
        import torch
        data = getattr(loss, '_data', loss)
        self._pending.append(torch.isfinite(
            torch.as_tensor(data).detach()).all())

    def add_post_restore_hook(self, fn):
        """Run ``fn()`` after every rollback restore (e.g. re-place
        restored parameters onto a device mesh)."""
        self._post_restore_hooks.append(fn)

    def _drain(self):
        """(any_flags, all_finite) over the pending flags; the host reads
        here are of programs that finished a full step ago."""
        if not self._pending:
            return False, True
        flags, self._pending = self._pending, []
        return True, all(bool(f) for f in flags)

    def peek_ok(self):
        """All pending flags finite? (Reads without consuming: the bad
        accounting in pre_step still sees them.) Waits for the steps that
        set them — only used on the checkpoint cadence."""
        return all(bool(f) for f in self._pending)

    # -- per-step supervision ---------------------------------------------

    def pre_step(self, on_bad=None):
        """Call at the start of every training step. Reads the previous
        step's flag and walks the policy ladder. Returns True when a
        rollback just happened — the caller must treat any state computed
        BEFORE the restore (e.g. gradients from backward) as stale and
        skip applying it. ``on_bad`` (optional) runs once when the
        drained flag was bad, before any rollback — callers use it to
        undo host-side bookkeeping the skipped step already advanced
        (e.g. optimizer update counts)."""
        had, ok = self._drain()
        if not had:
            return False
        if ok:
            self.consecutive_bad = 0
            return False
        if on_bad is not None:
            on_bad()
        self.consecutive_bad += 1
        self.bad_steps += 1
        if _telem['on']:
            from ..telemetry import metrics as _metrics
            _metrics.inc('mxnet_tpu_resilience_bad_steps_total')
        # flight recorder: the flag that just drained bad belongs to the
        # PREVIOUS recorded step (deferred read) — mark it and log the
        # trip so a crash dump shows the divergence window
        from ..telemetry import flight as _flight
        _flight.annotate_last(guard_ok=False)
        _flight.note('guard.bad_step', consecutive=self.consecutive_bad)
        _log.warning(
            "non-finite training step detected (%d consecutive, "
            "update skipped on device)", self.consecutive_bad)
        if self.consecutive_bad < self.max_consecutive_bad:
            return False
        if self.policy == 'skip':
            return False
        if self.policy == 'raise':
            raise MXNetError(
                f"NonFiniteGuard: {self.consecutive_bad} consecutive "
                f"non-finite steps (policy='raise')")
        return self._rollback()

    def _rollback(self):
        t0 = _time.perf_counter()
        self.consecutive_bad = 0
        from ..telemetry import flight as _flight, trace as _trace
        with _trace.span('guard.rollback'):
            step = self.manager.restore_latest()
        if step is None:
            raise MXNetError(
                "NonFiniteGuard: rollback triggered but no committed "
                "checkpoint exists yet — save one before the first "
                "divergence (autosave_steps) or lower "
                "max_consecutive_bad")
        for fn in self._post_restore_hooks:
            fn()
        self.rollbacks += 1
        self.last_rollback_step = step
        dt = _time.perf_counter() - t0
        if _telem['on']:
            from ..telemetry import metrics as _metrics
            _metrics.inc('mxnet_tpu_resilience_rollbacks_total')
            _metrics.set_gauge('mxnet_tpu_resilience_last_rollback_step',
                               step)
            _metrics.observe('mxnet_tpu_resilience_recovery_seconds', dt)
        _log.warning(
            "non-finite guard rolled back to checkpoint step %d "
            "(%.3fs): params, optimizer state, RNG and LR schedule "
            "restored", step, dt)
        # the rollback ladder is a post-mortem moment: dump the flight
        # recorder so the NaN burst's span timeline survives the
        # recovery (failure here must never break the recovery itself)
        _flight.note('guard.rollback', step=step,
                     recovery_seconds=round(dt, 4))
        try:
            _flight.dump(reason='rollback')
        except Exception:
            _log.exception("flight-recorder dump after rollback failed")
        return True

    # -- checkpoint gating --------------------------------------------------

    def maybe_save(self, step, metadata=None):
        """Cadence-gated save through the bound manager, additionally
        gated on the current step's flag being finite — a checkpoint must
        never capture the state of a step the guard is about to reject.
        The flag read syncs, so this only happens when the manager's
        autosave cadence is actually due. Returns True when it saved."""
        mgr = self.manager
        if mgr is None:
            raise MXNetError("NonFiniteGuard.maybe_save needs a manager")
        mgr._current_step = int(step)
        if not mgr.save_due(int(step)) and not self._save_deferred:
            return False
        if not self.peek_ok() and not mgr.preempted:
            # DEFER, don't drop: with a steps cadence the next due save
            # would otherwise be a full interval away, doubling the
            # worst-case rollback re-train exactly during NaN bursts.
            # EXCEPT under preemption: every guard path skips a bad
            # update before it applies, so the parameters are clean —
            # the last-chance grace-window save must never be deferred.
            self._save_deferred = True
            _log.warning(
                "deferring checkpoint at step %d: the step's non-finite "
                "flag is set (saved at the next finite step)", step)
            return False
        self._save_deferred = False
        mgr.save(int(step), metadata=metadata, block=mgr.preempted)
        return True
