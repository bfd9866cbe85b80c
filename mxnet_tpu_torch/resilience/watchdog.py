"""Step watchdog: detect a wedged training step and say WHY (counterpart
of ``mxnet_tpu/resilience/watchdog.py``).

A hung collective or a deadlocked input pipeline doesn't crash — it
wedges. The watchdog is a heartbeat-fed background thread: the training
loop calls ``beat(step)`` once per step; when no beat arrives for
``deadline_seconds`` the watchdog dumps every thread's stack plus a
telemetry snapshot to the log (so the post-mortem names the wedged
frame, not just the wall-clock) and can trigger the checkpoint manager's
synchronous ``save_now()`` — the path the SIGTERM preemption hook uses —
so a supervisor can kill and restart the job without losing the step
window. ``serving.InferenceEngine(watchdog_seconds=...)`` arms one over
its batcher, beaten once per completed batch.

One dump per stall: the watchdog re-arms only after the next beat, so a
wedge produces one actionable report, not a log flood.

The stall verdict is ``telemetry.server.stall_verdict``: without a
membership world (ROADMAP queue 1 item 10) it is None, or COMPILING while
a compile window (a CUDA-graph capture, a kernel build) is open — what
the JAX package's verdict is for a lone process.
"""
from __future__ import annotations

import logging
import sys
import threading
import time as _time
import traceback

from ..base import telem_flags as _telem

__all__ = ['StepWatchdog', 'format_all_stacks']

_log = logging.getLogger('mxnet_tpu_torch.resilience')


def format_all_stacks():
    """One string with every live thread's name + current stack."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for ident, frame in sorted(frames.items()):
        name = names.get(ident, '?')
        stack = ''.join(traceback.format_stack(frame))
        chunks.append(f"--- thread {name} (ident {ident}) ---\n{stack}")
    return ''.join(chunks)


class StepWatchdog:
    """Heartbeat watchdog for a training loop.

    ::

        wd = resilience.StepWatchdog(deadline_seconds=120, manager=mgr,
                                     save_on_stall=True)
        with wd:
            for step in ...:
                ... train ...
                wd.beat(step)

    ``on_stall`` (optional callable ``fn(report_str)``) replaces the
    default log dump — tests and custom supervisors hook in there.
    ``save_on_stall`` attempts ``manager.save_now()`` from a separate
    daemon thread (the stalled thread may hold the manager lock — the
    attempt must never wedge the watchdog itself).
    """

    def __init__(self, deadline_seconds=None, poll_seconds=None,
                 manager=None, save_on_stall=False, on_stall=None,
                 membership=None):
        if deadline_seconds is None:
            from .. import config as _config
            deadline_seconds = _config.get('MXTPU_WATCHDOG_SECONDS')
        self.deadline_seconds = float(deadline_seconds)
        if self.deadline_seconds <= 0:
            raise ValueError("watchdog deadline must be > 0 seconds")
        self.poll_seconds = float(poll_seconds) if poll_seconds \
            else max(0.05, self.deadline_seconds / 4.0)
        self.manager = manager
        self.save_on_stall = bool(save_on_stall)
        self.on_stall = on_stall
        # elastic membership for the stall verdict: explicit, or the
        # process-global one (resolved at dump time, so construction
        # order vs dist.init() does not matter)
        self.membership = membership
        self.stalls = 0
        self.last_step = None
        self._beat_time = None
        self._dumped_since_beat = False
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._beat_time = _time.monotonic()
        self._dumped_since_beat = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='mxtpu-step-watchdog')
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.poll_seconds))
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- heartbeat ---------------------------------------------------------

    def beat(self, step=None):
        """The training loop made progress. Cheap: a timestamp + flag."""
        with self._lock:
            self._beat_time = _time.monotonic()
            self._dumped_since_beat = False
            if step is not None:
                self.last_step = step

    # -- the watchdog thread ----------------------------------------------

    def _run(self):
        while not self._stop.wait(self.poll_seconds):
            with self._lock:
                stalled = (not self._dumped_since_beat
                           and self._beat_time is not None
                           and _time.monotonic() - self._beat_time
                           > self.deadline_seconds)
                if stalled:
                    self._dumped_since_beat = True
                    age = _time.monotonic() - self._beat_time
                    step = self.last_step
            if stalled:
                self._on_stall(age, step)

    def _on_stall(self, age, step):
        self.stalls += 1
        if _telem['on']:
            from ..telemetry import metrics as _metrics
            _metrics.inc('mxnet_tpu_resilience_watchdog_stalls_total')
        # one verdict per stall, shared by the report and the flight
        # note (computing it twice could disagree mid-transition)
        verdict = self._stall_verdict()
        report = self._format_report(age, step, verdict)
        # flight recorder: note the stall and dump the black box (span
        # rings are flushed — open spans get synthetic closes — so the
        # hang leaves a loadable timeline naming the wedged scope, not
        # just thread stacks). Must never wedge the watchdog itself.
        try:
            from ..telemetry import flight as _flight
            note = dict(age_seconds=round(age, 1), step=step)
            if verdict is not None:
                # the classified verdict + per-peer heartbeat ages ride
                # in the dump, so a post-mortem never misattributes a
                # remote preemption to local code (or vice versa)
                note.update(verdict=verdict['verdict'],
                            peer_ages=verdict['peer_ages'],
                            lost_peers=verdict['lost'])
                if verdict.get('during'):
                    note['during'] = verdict['during']
                if verdict.get('straggler'):
                    note['straggler'] = verdict['straggler']
                if verdict.get('compiling'):
                    note['compiling'] = verdict['compiling']
                if verdict.get('joining'):
                    note['joining'] = verdict['joining']
            _flight.note('watchdog.stall', **note)
            path = _flight.dump(reason='watchdog_stall')
            if path:
                report += f"\nflight recorder dumped to {path}"
        except Exception:
            _log.exception("watchdog flight-recorder dump failed")
        if self.on_stall is not None:
            try:
                self.on_stall(report)
            except Exception:
                _log.exception("watchdog on_stall callback failed")
        else:
            _log.error("%s", report)
        if self.save_on_stall and self.manager is not None:
            # separate thread: save_now serializes on the manager lock,
            # which the wedged thread may hold — the watchdog must keep
            # running (and keep reporting) regardless
            threading.Thread(target=self._try_save, daemon=True,
                             name='mxtpu-watchdog-save').start()

    def _try_save(self):
        try:
            step = self.manager._current_step
            if step is None:
                # nothing has told the manager a step yet (e.g. a stall
                # in the very first batch): fall back to the heartbeat
                # step, or 0 — an initial-state checkpoint still beats
                # losing the run. last_step is beat()'s state: this
                # save thread reads it under the same lock.
                with self._lock:
                    last = self.last_step
                step = last if last is not None else 0
            self.manager.save_now(step)
            _log.warning("watchdog: emergency checkpoint committed at "
                         "step %s", step)
        except Exception:
            _log.exception("watchdog: emergency save_now() failed")

    def _stall_verdict(self):
        """The classified stall verdict (see the module docstring): None
        without a membership world and an open compile window. Never
        raises — the watchdog must keep reporting whatever else is
        broken."""
        try:
            from ..telemetry.server import stall_verdict
            return stall_verdict(self.membership)
        except Exception:
            return None

    def _format_report(self, age, step, verdict=None):
        lines = [
            f"watchdog: no training-step heartbeat for {age:.1f}s "
            f"(deadline {self.deadline_seconds:.1f}s, last step "
            f"{step if step is not None else 'unknown'}) — the step is "
            f"stalled. All-thread stacks follow.",
        ]
        if verdict is None:
            verdict = self._stall_verdict()
        if verdict is not None:
            during = ' (during replica fetch)' \
                if verdict.get('during') == 'replica_fetch' else ''
            if verdict['lost']:
                lines.insert(1, (
                    f"verdict: PEER LOSS SUSPECTED{during} — peer(s) "
                    f"{verdict['lost']} silent past the "
                    f"{verdict['deadline_seconds']:.1f}s membership "
                    f"deadline (last-heartbeat ages per peer: "
                    f"{verdict['peer_ages']}); the wedge is most likely "
                    f"a remote preemption, not local code."))
            elif during:
                lines.insert(1, (
                    f"verdict: PEER LOSS SUSPECTED{during} — a "
                    f"checkpoint replica fetch has been in flight for "
                    f"the whole stall; the serving peer is the prime "
                    f"suspect even though it still heartbeats "
                    f"(last-heartbeat ages per peer: "
                    f"{verdict['peer_ages']}). The fetch itself is "
                    f"bounded by MXTPU_REPLICA_TIMEOUT_SECONDS."))
            elif verdict.get('verdict') == 'compiling':
                c = verdict['compiling']
                rank = c.get('rank')
                rank_s = rank if rank is not None else 'this process'
                lines.insert(1, (
                    f"verdict: COMPILING: rank {rank_s}, site "
                    f"{c.get('site')}, {c.get('elapsed_seconds')}s "
                    f"elapsed — a compile (phase {c.get('phase')}: a "
                    f"CUDA-graph capture or a kernel build) has the step, "
                    f"not a wedge; expect it to clear, or keep the kernel "
                    f"cache (MXTPU_COMPILE_CACHE_DIR) so the next cold "
                    f"start skips the build."))
            elif verdict.get('verdict') == 'reform_pending':
                j = verdict.get('joining') or {}
                names = ', '.join(
                    f"rank {r} (announced {a:.1f}s ago)"
                    for r, a in sorted(j.items()))
                lines.insert(1, (
                    f"verdict: REFORM PENDING — a scale-up admission "
                    f"rendezvous is in flight: joining {names or j}; "
                    f"every survivor quiesces at its next step boundary "
                    f"and re-forms at the larger world, so the stall is "
                    f"the rendezvous, not a wedge. Bounded by "
                    f"MXTPU_JOIN_TIMEOUT_SECONDS."))
            elif verdict.get('verdict') == 'straggler_suspected':
                s = verdict['straggler']
                lines.insert(1, (
                    f"verdict: STRAGGLER SUSPECTED: rank {s['rank']} — "
                    f"every peer still heartbeats, but the fleet "
                    f"telemetry names rank {s['rank']} as the "
                    f"{'most-stale' if s['reason'] == 'stale' else 'slowest'}"
                    f" rank (last snapshot "
                    f"{s.get('snapshot_age_seconds')}s ago, step "
                    f"{s.get('step')} vs fleet max {s.get('max_step')}); "
                    f"this process is most likely wedged inside a "
                    f"collective waiting on it."))
            else:
                s = verdict.get('straggler')
                suffix = ''
                if s is not None:
                    suffix = (
                        f" Fleet telemetry's worst rank: {s['rank']} "
                        f"({s['reason']}, last snapshot "
                        f"{s.get('snapshot_age_seconds')}s ago, step "
                        f"{s.get('step')} vs fleet max "
                        f"{s.get('max_step')}) — below the detector "
                        f"thresholds.")
                lines.insert(1, (
                    f"verdict: LOCAL STALL — every peer is still "
                    f"heartbeating (last-heartbeat ages per peer: "
                    f"{verdict['peer_ages']}); the wedge is in THIS "
                    f"process.{suffix}"))
        lines.append(format_all_stacks())
        try:
            from ..telemetry import metrics as _metrics
            snap = _metrics.report()
            if snap:
                lines.append(snap)
        except Exception:
            pass
        try:
            from ..telemetry import flight as _flight, trace as _trace
            if _trace.enabled():
                lines.append(_flight.get().format_summary())
        except Exception:
            pass
        return '\n'.join(lines)
