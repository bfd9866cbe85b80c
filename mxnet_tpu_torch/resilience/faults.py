"""Deterministic fault injection (counterpart of
``mxnet_tpu/resilience/faults.py``).

A process-global registry of named fault sites threaded through the
layers that can fail. Arm a site and the real code path takes the real
failure:

    MXTPU_FAULT=step.dispatch:nan:1:0:5-7   # NaN grads on steps 5..7
    MXTPU_FAULT=checkpoint.write:corrupt:1:0:2-2

Grammar (comma/semicolon-separated specs)::

    site:kind[:prob[:seed[:first-last]]]

- ``site``  — a registered fault site (see ``sites()``); arming an
  unknown site raises, so typos fail loudly.
- ``kind``  — ``raise`` (InjectedFault), ``hang`` (sleep
  MXTPU_FAULT_HANG_SECONDS), ``corrupt`` (the site mangles its payload
  bytes), ``nan`` (the site poisons its numerics).
- ``prob``  — firing probability per occurrence (default 1).
- ``seed``  — seed of the *deterministic* per-occurrence firing stream
  (default 0): the same seed and occurrence index give the same
  decision in every process, on every run (sha256, not a process RNG),
  and the same decision as the JAX package's registry.
- ``first-last`` — 1-based inclusive occurrence window (``5-7``, or
  ``5`` for exactly one occurrence). Outside the window the site never
  fires regardless of prob.

Every site of the JAX package is registered here under its name, so
``sites()`` is the same in both packages and one ``MXTPU_FAULT`` arms
either. The sites that fire in this package:

- ``step.dispatch`` — ``gluon.Trainer.step`` (``nan`` poisons every
  gradient) and ``parallel.ShardedTrainStep`` (``nan`` enters the
  captured step as a device scalar that multiplies the loss, the JAX
  step's ``fault_scale``);
- ``checkpoint.write`` and ``checkpoint.read`` —
  ``checkpoint.CheckpointManager``;
- ``alloc.oom`` — ``telemetry.memory.oom_guard``;
- ``dist.barrier`` — ``parallel.dist.barrier`` (and a kvstore's
  ``barrier``);
- ``collective.all_reduce`` — the kvstore's reduction of a push
  (``kvstore.kvstore._reduce``);
- ``io.decode`` — ``io.ImageRecordIter``'s python decode path, keyed by
  record index (``corrupt`` mangles the image bytes; armed before the
  iterator is made, it selects that path);
- ``io.device_put`` — ``io``'s host->device staging of a prefetched
  batch (``DevicePrefetchIter``, ``PrefetchingIter(device_prefetch=
  True)``);
- ``dataloader.worker`` — ``gluon.data.DataLoader``'s batch fetch (a
  ``raise`` takes the bounded respawn path).

The others wait for the code they sit in: ``dist.file_put``,
``dist.heartbeat``, ``dist.join`` and ``elastic.admit`` (the membership
side channel, the replica transport and the elastic controller, ROADMAP
queue 1 item 10).

Disarmed sites cost one empty-dict check per call.
"""
from __future__ import annotations

import hashlib
import threading
import time as _time

from ..base import MXNetError, telem_flags as _telem

__all__ = ['InjectedFault', 'KINDS', 'sites', 'register_site', 'arm',
           'disarm', 'arm_from_env', 'active', 'is_armed', 'fire',
           'corrupt_bytes']


class InjectedFault(MXNetError):
    """Raised by an armed ``raise`` fault site (never by real failures)."""

    def __init__(self, site, occurrence):
        super().__init__(
            f"injected fault at site '{site}' (occurrence {occurrence}) — "
            f"armed via MXTPU_FAULT / resilience.faults.arm()")
        self.site = site
        self.occurrence = occurrence


KINDS = ('raise', 'hang', 'corrupt', 'nan')

# site -> (description, kinds that make sense there): the JAX package's
# table, copied as it is (the module docstring says which sites fire here)
_SITES = {
    'io.decode': ('ImageRecordIter record read + image decode (corrupt '
                  'mangles the image bytes before decode)',
                  ('raise', 'corrupt', 'hang')),
    'io.device_put': ('host->device staging of a prefetched batch',
                      ('raise', 'hang')),
    'dataloader.worker': ('gluon DataLoader worker batch fetch (a raise '
                          'here exercises the bounded respawn path)',
                          ('raise', 'hang')),
    'step.dispatch': ('train-step dispatch (gluon Trainer.step and '
                      'ShardedTrainStep.__call__; nan poisons the '
                      'gradients/loss so the non-finite guard trips)',
                      ('raise', 'hang', 'nan')),
    'checkpoint.write': ('CheckpointManager payload write (raise is '
                         'retried as a transient FS error; corrupt '
                         'mangles one payload so restore falls back)',
                         ('raise', 'hang', 'corrupt')),
    'checkpoint.read': ('CheckpointManager payload read at restore and '
                        'scrub time (corrupt mangles the bytes AFTER the '
                        'disk read so the hash check fails — restore '
                        'falls back / repairs from a replica and the '
                        'scrubber quarantines, no hand-flipped bytes '
                        'needed; raise surfaces a hard read error)',
                        ('raise', 'hang', 'corrupt')),
    'dist.file_put': ('checkpoint replica transfer send (parallel.dist.'
                      'file_put; raise fails the transfer — the push '
                      'worker retries bounded; corrupt mangles the '
                      'payload in flight so the receiver hash check '
                      'rejects it; hang stalls the transfer into its '
                      'socket timeout)', ('raise', 'hang', 'corrupt')),
    'collective.all_reduce': ('kvstore gradient reduction across device '
                              'copies', ('raise', 'hang')),
    'dist.heartbeat': ('elastic membership heartbeat send (parallel.dist.'
                       'Membership; raise drops the beat — enough '
                       'consecutive drops and the coordinator declares '
                       'this worker lost; hang delays the beat past the '
                       'peer deadline)', ('raise', 'hang')),
    'dist.barrier': ('membership barrier entry (dist.barrier / kvstore '
                     'barrier on dist stores) — the rendezvous every '
                     'mesh re-form crosses', ('raise', 'hang')),
    'dist.join': ('elastic membership JOIN announcement (parallel.dist.'
                  'Membership.join; raise fails the announcement so the '
                  'joiner retries or aborts; hang delays it so the '
                  'admission rendezvous ages — the REFORM PENDING '
                  'verdict drills against this)', ('raise', 'hang')),
    'elastic.admit': ('scale-up admission re-form entry (Elastic'
                      'Controller._admit, survivors and joiner alike) — '
                      'raise aborts the admission before teardown; hang '
                      'stalls the rendezvous into the watchdog window',
                      ('raise', 'hang')),
    'alloc.oom': ('device allocator exhaustion: a raise here surfaces '
                  'as a synthetic RESOURCE_EXHAUSTED through the '
                  'telemetry.memory.oom_guard wrapping step dispatch, '
                  'h2d batch/param placement and checkpoint-restore '
                  're-place — the OOM forensics dump drills without a '
                  'real 16GB chip (resilience.drill.run_oom_drill)',
                  ('raise',)),
}

_lock = threading.RLock()
_armed = {}          # site -> dict(kind, prob, seed, first, last, count)


def sites():
    """{site: description} of every registered fault site."""
    return {name: desc for name, (desc, _) in sorted(_SITES.items())}


def register_site(name, description, kinds=KINDS):
    """Register an additional fault site (for tests / downstream code)."""
    with _lock:
        _SITES[name] = (description, tuple(kinds))


def arm(site, kind, prob=1.0, seed=0, window=None):
    """Arm one fault site programmatically. ``window`` is a 1-based
    inclusive ``(first, last)`` occurrence range (or a single int)."""
    if site not in _SITES:
        raise MXNetError(
            f"unknown fault site {site!r}; registered sites: "
            f"{sorted(_SITES)}")
    if kind not in KINDS:
        raise MXNetError(f"unknown fault kind {kind!r}; kinds: {KINDS}")
    allowed = _SITES[site][1]
    if kind not in allowed:
        raise MXNetError(
            f"fault kind {kind!r} is not meaningful at site {site!r} "
            f"(allowed: {allowed})")
    prob = float(prob)
    if not 0.0 <= prob <= 1.0:
        raise MXNetError(f"fault prob must be in [0, 1], got {prob}")
    if window is None:
        first, last = 1, None
    elif isinstance(window, int):
        first = last = int(window)
    else:
        first, last = int(window[0]), int(window[1])
    if first < 1 or (last is not None and last < first):
        raise MXNetError(f"fault window must be 1-based and ordered, "
                         f"got {window!r}")
    with _lock:
        _armed[site] = {'kind': kind, 'prob': prob, 'seed': int(seed),
                        'first': first, 'last': last, 'count': 0,
                        'fired': 0}


def disarm(site=None):
    """Disarm one site (or every site) and reset occurrence counters."""
    with _lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)


def active():
    """{site: spec} snapshot of the armed sites (counters included)."""
    with _lock:
        return {s: dict(spec) for s, spec in _armed.items()}


def is_armed(site=None):
    """Lock-free armed check (the same fast path fire() uses): is ANY
    site armed (``site=None``), or this specific site? Safe to call on
    hot paths."""
    if site is None:
        return bool(_armed)
    return site in _armed


def arm_from_env(spec=None):
    """Parse an ``MXTPU_FAULT`` spec string and arm the named sites.
    Called at package import; call again after changing the env var.
    Returns the number of sites armed."""
    if spec is None:
        from .. import config as _config
        spec = _config.get('MXTPU_FAULT')
    disarm()
    spec = (spec or '').strip()
    if not spec:
        return 0
    n = 0
    for part in spec.replace(';', ',').split(','):
        part = part.strip()
        if not part:
            continue
        fields = part.split(':')
        if len(fields) < 2:
            raise MXNetError(
                f"MXTPU_FAULT spec {part!r}: expected "
                f"site:kind[:prob[:seed[:first-last]]]")
        site, kind = fields[0], fields[1]
        try:
            prob = float(fields[2]) if len(fields) > 2 and fields[2] \
                else 1.0
            seed = int(fields[3]) if len(fields) > 3 and fields[3] else 0
            window = None
            if len(fields) > 4 and fields[4]:
                w = fields[4]
                if '-' in w:
                    a, b = w.split('-', 1)
                    window = (int(a), int(b))
                else:
                    window = int(w)
        except ValueError as e:
            # same loud-typo contract as unknown sites/kinds: a bad
            # numeric field must name the env var and the grammar, not
            # crash import with a bare ValueError
            raise MXNetError(
                f"MXTPU_FAULT spec {part!r}: bad numeric field ({e}); "
                f"expected site:kind[:prob[:seed[:first-last]]]")
        arm(site, kind, prob=prob, seed=seed, window=window)
        n += 1
    return n


def _unit(seed, occurrence):
    """Deterministic uniform [0, 1) for (seed, occurrence) — stable
    across processes/platforms (sha256, not the process RNG)."""
    h = hashlib.sha256(f'{seed}:{occurrence}'.encode()).digest()
    return int.from_bytes(h[:8], 'big') / float(1 << 64)


def fire(site, occurrence=None):
    """Advance `site`'s occurrence counter and fire the armed fault when
    the deterministic (seed, occurrence) stream says so.

    ``occurrence`` — explicit 1-based occurrence key for sites whose
    natural ordering is data-defined rather than call-defined: io.decode
    passes the record index, so a multi-threaded decode pool corrupts
    the SAME records on every run no matter how its threads interleave.
    When omitted the site's process-global call counter is the key.

    Returns None (not armed / did not fire) or the fault kind. ``raise``
    raises InjectedFault here; ``hang`` sleeps MXTPU_FAULT_HANG_SECONDS
    here (that IS the fault — a stalled call the watchdog should catch);
    ``corrupt`` / ``nan`` are returned for the site to apply to its own
    payload (see corrupt_bytes)."""
    if not _armed:      # the disarmed fast path: no lock, one dict check
        return None
    with _lock:
        spec = _armed.get(site)
        if spec is None:
            return None
        spec['count'] += 1
        n = spec['count'] if occurrence is None else int(occurrence)
        if n < spec['first'] or \
                (spec['last'] is not None and n > spec['last']):
            return None
        if spec['prob'] < 1.0 and _unit(spec['seed'], n) >= spec['prob']:
            return None
        spec['fired'] += 1
        kind = spec['kind']
    if _telem['on']:
        from ..telemetry import metrics as _metrics
        _metrics.inc('mxnet_tpu_resilience_faults_injected_total',
                     site=site, kind=kind)
    # flight recorder: a fired fault is exactly the kind of event a
    # post-mortem needs in its timeline (no-op unless tracing is armed)
    from ..telemetry import flight as _flight
    _flight.note('fault', site=site, fault_kind=kind, occurrence=n)
    if kind == 'raise':
        raise InjectedFault(site, n)
    if kind == 'hang':
        from .. import config as _config
        _time.sleep(_config.get('MXTPU_FAULT_HANG_SECONDS'))
    return kind


def corrupt_bytes(data, occurrence=0):
    """Deterministically mangle a bytes payload: the first 16 bytes are
    overwritten with a seeded pattern (destroying any format magic so
    decoders fail loudly instead of producing silently-wrong pixels) and
    one mid-payload byte is flipped (so content hashes mismatch even for
    formats without magic)."""
    buf = bytearray(data)
    if not buf:
        return bytes(buf)
    pat = hashlib.sha256(b'mxtpu-fault-%d' % occurrence).digest()
    head = min(16, len(buf))
    buf[:head] = pat[:head]
    mid = len(buf) // 2
    buf[mid] ^= 0xA5
    return bytes(buf)
