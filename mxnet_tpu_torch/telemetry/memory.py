"""Memory observability: device/host watermarks, residency pools, OOM
forensics (counterpart of ``mxnet_tpu/telemetry/memory.py``).

- **Watermarks** — per-step live/peak device-memory sampling into a
  bounded ring. On the card the numbers are PyTorch's caching
  allocator's own (``torch.cuda.memory_stats``: allocated bytes now and
  at peak, reserved bytes, the device's total as the limit); on the CPU,
  where there is no allocator to ask, the deterministic **fallback**
  sums the bytes of every *tracked* live tensor, registered as named
  **pools** by their owners (a hybridized block's CUDA graphs and their
  static buffers, for one). Host RSS rides along. Samples export as
  ``mxnet_tpu_memory_*`` gauges and land in the flight-recorder step
  records.
- **Leak detection** — ``MXTPU_MEMORY_LEAK_STEPS`` consecutive samples
  of monotonic live-bytes growth past ``MXTPU_MEMORY_LEAK_BYTES`` latch a
  ``memory.leak_suspected`` flight note (cleared when growth stops).
- **OOM forensics** — ``oom_guard(site)`` wraps the dispatch sites that
  allocate (a serving dispatch, a training step). An allocator failure
  caught there (``torch.cuda.OutOfMemoryError``, or the allocator's
  "CUDA out of memory" text) dumps ONE atomic JSON post-mortem — the
  watermark ring, the top tracked tensors by bytes and, on the card, the
  allocator's largest segments (``torch.cuda.memory_snapshot()``) — then
  re-raises. The guard fires the deterministic ``alloc.oom`` fault site
  (``resilience.faults``) on entry: an injected raise there is an OOM
  too, so a drill leaves exactly the post-mortem a real one would.

Armed with ``MXTPU_MEMORY=1`` (or ``memory.enable()``); sampling
cadence is ``MXTPU_MEMORY_EVERY`` steps. Disarmed, every step-path hook
costs one dict check and allocates nothing; the OOM guard is always
armed — catching a fatal allocator error costs nothing until it fires.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time as _time
import weakref

from ..base import telem_flags as _telem

__all__ = [
    'enable', 'disable', 'enabled', 'clear',
    'register_pool', 'register_provider', 'pool_nbytes',
    'entry_nbytes', 'pools', 'tracked_bytes', 'live_bytes',
    'device_memory_stats', 'host_rss_bytes',
    'on_step', 'sample', 'step_fields', 'snapshot_fields',
    'health_fields', 'watermarks', 'peak_bytes', 'leak_state',
    'is_oom_error', 'oom_guard', 'dump_oom', 'default_oom_path',
    'validate_oom_dump', 'top_arrays',
]

_state = {'on': False}

# sampling/ring/leak configuration, resolved lazily from config (tests
# override via clear(ring=...) or the module attrs)
_cfg = {'ring': None, 'every': None, 'leak_steps': None,
        'leak_bytes': None}

# pool registry: key -> (pool name, provider, weakref-to-owner|None).
# A provider is either a zero-arg callable returning {array_name: entry}
# (entry = tensor, array or plain byte count) or an OWNER object exposing
# .memory_pools() -> {pool: {array_name: entry}}. Owner-keyed entries
# auto-retire when the owner is garbage collected, so a rebuilt owner
# never double-counts its predecessor's tensors.
# RLock: sampling runs on the step thread and the registry is readable
# from crash-time dump paths (same signal-safety rationale as
# flight._recorder_lock).
_pools_lock = threading.RLock()
_pools = {}

_ring_lock = threading.RLock()
_ring = None                  # collections.deque of sample records
_last = {'fields': None}      # newest sample's compact per-step fields
_peak = {'device': 0, 'stats_peak': None}
_every_count = [0]
_leak = {'prev': None, 'streak': 0, 'growth': 0, 'latched': False,
         'latched_step': None}

OOM_SCHEMA = 'mxtpu_oom_v1'


def enable():
    _state['on'] = True


def disable():
    _state['on'] = False


def enabled() -> bool:
    return _state['on']


def _ring_capacity():
    if _cfg['ring'] is None:
        from .. import config as _config
        _cfg['ring'] = max(4, int(_config.get('MXTPU_MEMORY_RING')))
    return _cfg['ring']


def _every():
    if _cfg['every'] is None:
        from .. import config as _config
        _cfg['every'] = max(1, int(_config.get('MXTPU_MEMORY_EVERY')))
    return _cfg['every']


def _leak_cfg():
    if _cfg['leak_steps'] is None:
        from .. import config as _config
        _cfg['leak_steps'] = max(2, int(
            _config.get('MXTPU_MEMORY_LEAK_STEPS')))
        _cfg['leak_bytes'] = max(1, int(
            _config.get('MXTPU_MEMORY_LEAK_BYTES')))
    return _cfg['leak_steps'], _cfg['leak_bytes']


def clear(ring=None, every=None, leak_steps=None, leak_bytes=None,
          pools=False):
    """Drop every sample and latched state. Optional overrides pin the
    ring capacity / cadence / leak thresholds for rings created after
    this call (None restores the config defaults).

    Pool registrations SURVIVE by default: owners register exactly
    once, so a mid-run reset must not zero the rest of the run's
    residency telemetry. They are weakref'd and self-cleaning;
    ``pools=True`` (test fixtures) wipes them too."""
    global _ring
    with _ring_lock:
        _ring = None
        _cfg['ring'] = ring
        _cfg['every'] = every
        _cfg['leak_steps'] = leak_steps
        _cfg['leak_bytes'] = leak_bytes
        _last['fields'] = None
        _peak['device'] = 0
        _peak['stats_peak'] = None
        _every_count[0] = 0
        _leak.update(prev=None, streak=0, growth=0, latched=False,
                     latched_step=None)
    if pools:
        with _pools_lock:
            _pools.clear()


# ---------------------------------------------------------------------------
# residency pools (the deterministic fallback's array registry)
# ---------------------------------------------------------------------------

def entry_nbytes(x):
    """Bytes a tracked entry holds: a tensor's or array's ``nbytes``,
    the value itself for a plain byte count. An entry whose size cannot
    be read (a freed buffer that raises on access) counts 0: the OOM dump
    must survive it, not die inside its own accounting."""
    if isinstance(x, (int, float)):
        return int(x)
    try:
        nb = getattr(x, 'nbytes', None)
        if nb is not None:
            return int(nb)
    except Exception:
        return 0
    return 0


def pool_nbytes(pool):
    """Per-device bytes of one ``{array_name: entry}`` pool dict."""
    return sum(entry_nbytes(v) for v in (pool or {}).values())


def register_pool(name, provider, owner=None):
    """Register a named pool of live arrays for the fallback watermark.
    ``provider()`` returns ``{array_name: array-or-bytes}``. With an
    ``owner``, the registration auto-retires when the owner is garbage
    collected (a rebuilt step must not double-count its predecessor)."""
    key = name if owner is None else (name, id(owner))
    ref = weakref.ref(owner) if owner is not None else None
    with _pools_lock:
        _pools[key] = (name, provider, ref)
    return key


def register_provider(owner):
    """Register an object exposing ``memory_pools() ->
    {pool: {array_name: entry}}`` (a hybridized block's CachedOp).
    Weakly referenced; re-registration of the same object is
    idempotent."""
    key = ('provider', id(owner))
    ref = weakref.ref(owner)
    with _pools_lock:
        _pools[key] = (None, None, ref)
    return key


def pools():
    """Merged live pools: ``{pool: {array_name: entry}}`` across every
    registered provider (dead owners pruned)."""
    with _pools_lock:
        items = list(_pools.items())
    merged = {}
    dead = []
    for key, (name, provider, ref) in items:
        owner = None
        if ref is not None:
            owner = ref()
            if owner is None:
                dead.append(key)
                continue
        try:
            if name is None:                    # .memory_pools() provider
                groups = owner.memory_pools() or {}
            else:
                groups = {name: provider() or {}}
        except Exception:
            continue                            # never break sampling
        for pool, entries in groups.items():
            dst = merged.setdefault(pool, {})
            for aname, entry in (entries or {}).items():
                dst[aname] = entry
    if dead:
        with _pools_lock:
            for key in dead:
                _pools.pop(key, None)
    return merged


def tracked_bytes():
    """(total bytes, {pool: bytes}) over every live tracked entry — the
    deterministic fallback watermark."""
    by_pool = {pool: pool_nbytes(entries)
               for pool, entries in pools().items()}
    return sum(by_pool.values()), by_pool


def live_bytes():
    """(live device bytes, {pool: bytes}): the allocator's allocated
    bytes (``torch.cuda.memory_allocated``) where it has been used, else
    the tracked pools' total (the CPU fallback, as the JAX package falls
    back where its backend exposes no stats)."""
    total, by_pool = tracked_bytes()
    stats = device_memory_stats()
    if stats is not None:
        total = int(stats['bytes_in_use'])
    return total, by_pool


def top_arrays(limit=16):
    """The largest tracked live entries, descending:
    ``[{'pool', 'name', 'nbytes', 'shape', 'dtype', 'device'}]`` — what
    the OOM post-mortem names as prime suspects."""
    rows = []
    for pool, entries in pools().items():
        for aname, entry in entries.items():
            nb = entry_nbytes(entry)
            if nb <= 0:
                continue
            row = {'pool': pool, 'name': aname, 'nbytes': nb}
            try:
                shape = getattr(entry, 'shape', None)
                if shape is not None:
                    row['shape'] = [int(s) for s in shape]
                dt = getattr(entry, 'dtype', None)
                if dt is not None:
                    row['dtype'] = str(dt)
                dev = getattr(entry, 'device', None)
                if dev is not None:
                    row['device'] = str(dev)
            except Exception:
                pass                   # metadata of a deleted buffer
            rows.append(row)
    rows.sort(key=lambda r: (-r['nbytes'], r['pool'], r['name']))
    return rows[:int(limit)]


# ---------------------------------------------------------------------------
# device / host sources
# ---------------------------------------------------------------------------

def device_memory_stats(device=None):
    """{'bytes_in_use', 'peak_bytes_in_use', 'bytes_reserved',
    'peak_bytes_reserved', 'num_alloc_retries', 'num_ooms',
    'bytes_limit'} from PyTorch's CUDA caching allocator (the current
    device by default), or None without a card or before CUDA was first
    used in this process (asking would create a context) — the fallback
    pools then carry the watermark."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        if device is None:
            device = torch.cuda.current_device()
        s = torch.cuda.memory_stats(device)
        if not s or 'allocated_bytes.all.current' not in s:
            return None
        return {'bytes_in_use': int(s['allocated_bytes.all.current']),
                'peak_bytes_in_use': int(s['allocated_bytes.all.peak']),
                'bytes_reserved': int(s['reserved_bytes.all.current']),
                'peak_bytes_reserved': int(s['reserved_bytes.all.peak']),
                'num_alloc_retries': int(s.get('num_alloc_retries', 0)),
                'num_ooms': int(s.get('num_ooms', 0)),
                'bytes_limit': int(torch.cuda.get_device_properties(
                    device).total_memory)}
    except Exception:
        return None


def host_rss_bytes():
    """Current resident set size of this process (bytes); peak RSS as
    the fallback where /proc is unavailable."""
    try:
        with open('/proc/self/statm') as f:
            return int(f.read().split()[1]) * os.sysconf('SC_PAGE_SIZE')
    except Exception:
        try:
            import resource
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss \
                * 1024
        except Exception:
            return 0


# ---------------------------------------------------------------------------
# sampling (the step-path hook)
# ---------------------------------------------------------------------------

def on_step(step=None):
    """Per-step hook on the dispatch paths. Disarmed: one dict check,
    no allocation. Armed: every ``MXTPU_MEMORY_EVERY``-th call records
    one watermark sample (gauges + ring + leak detector) and refreshes
    the compact fields the flight recorder attaches to its step
    record."""
    if not _state['on']:
        return None
    _every_count[0] += 1
    if _every_count[0] % _every():
        return None
    return sample(step=step)


def sample(step=None):
    """Record one watermark sample now; returns the ring record."""
    stats = device_memory_stats()
    fb_total, by_pool = tracked_bytes()
    if stats is not None:
        live = int(stats['bytes_in_use'])
        source = 'memory_stats'
    else:
        live = fb_total
        source = 'fallback'
    rec = {'time': round(_time.time(), 3), 'source': source,
           'device_bytes': live, 'fallback_bytes': fb_total,
           'host_rss_bytes': host_rss_bytes()}
    if step is not None:
        rec['step'] = int(step)
    if by_pool:
        rec['pools'] = by_pool
    with _ring_lock:
        global _ring
        if _ring is None:
            _ring = collections.deque(maxlen=_ring_capacity())
        if stats is not None and stats.get('peak_bytes_in_use'):
            _peak['stats_peak'] = max(_peak['stats_peak'] or 0,
                                      int(stats['peak_bytes_in_use']))
        _peak['device'] = max(_peak['device'], live)
        rec['peak_bytes'] = peak_bytes()
        _ring.append(rec)
        # the compact per-step fields flight.record_step attaches: a
        # fresh small dict per SAMPLE (never per step — the read path
        # hands out the same object until the next sample)
        _last['fields'] = {'device_bytes': live,
                           'peak_bytes': rec['peak_bytes'],
                           'host_rss_bytes': rec['host_rss_bytes'],
                           'source': source}
    _leak_observe(step, live)
    if _telem['on']:
        from . import metrics as _metrics
        _metrics.set_gauge('mxnet_tpu_memory_device_bytes', live,
                           source=source)
        _metrics.set_gauge('mxnet_tpu_memory_device_peak_bytes',
                           rec['peak_bytes'], source=source)
        _metrics.set_gauge('mxnet_tpu_memory_host_rss_bytes',
                           rec['host_rss_bytes'])
        for pool, nb in by_pool.items():
            _metrics.set_gauge('mxnet_tpu_memory_pool_bytes', nb,
                               pool=pool)
        _metrics.inc('mxnet_tpu_memory_samples_total')
    return rec


def step_fields():
    """The newest sample's compact fields for the flight-recorder step
    record, or None while disarmed / before the first sample. One dict
    check disarmed; the armed path returns the prebuilt dict (no
    per-step allocation on the recording path)."""
    if not _state['on']:
        return None
    return _last['fields']


def snapshot_fields():
    """The fleet-snapshot payload: ``{'live', 'peak', 'rss'}`` bytes, or
    None while disarmed / before the first sample."""
    f = step_fields()
    if f is None:
        return None
    return {'live': f['device_bytes'], 'peak': f['peak_bytes'],
            'rss': f['host_rss_bytes']}


def health_fields():
    """The memory document of a health report — computed on demand
    (cold path), so pressure shows even on a run that never armed
    MXTPU_MEMORY."""
    stats = device_memory_stats()
    fb_total, by_pool = tracked_bytes()
    out = {'live_bytes': int(stats['bytes_in_use']) if stats is not None
           else fb_total,
           'source': 'memory_stats' if stats is not None else 'fallback',
           'tracked_bytes': fb_total,
           'host_rss_bytes': host_rss_bytes()}
    pk = peak_bytes()
    out['peak_bytes'] = max(pk, out['live_bytes'])
    if stats is not None and stats.get('bytes_limit'):
        out['limit_bytes'] = int(stats['bytes_limit'])
    if by_pool:
        out['pools'] = by_pool
    if _leak['latched']:
        out['leak_suspected'] = True
    return out


def watermarks():
    """Snapshot of the bounded watermark ring (oldest first)."""
    with _ring_lock:
        return [dict(r) for r in (_ring or ())]


def peak_bytes():
    """The high-water mark so far: the allocator's own peak where
    exposed, else the max fallback sample (0 before any sample)."""
    with _ring_lock:
        if _peak['stats_peak'] is not None:
            return max(_peak['stats_peak'], _peak['device'])
        return _peak['device']


# ---------------------------------------------------------------------------
# leak detector
# ---------------------------------------------------------------------------

def _leak_observe(step, live):
    """Step-over-step growth detector: ``leak_steps`` consecutive
    samples of monotonic growth totalling >= ``leak_bytes`` latch ONE
    ``memory.leak_suspected`` flight note; a non-growing sample clears
    the latch (so a later, separate leak fires again)."""
    leak_steps, leak_bytes = _leak_cfg()
    prev = _leak['prev']
    _leak['prev'] = live
    if prev is None:
        return
    if live > prev:
        _leak['streak'] += 1
        _leak['growth'] += live - prev
    else:
        _leak['streak'] = 0
        _leak['growth'] = 0
        if _leak['latched']:
            _leak['latched'] = False
            _leak['latched_step'] = None
        return
    if _leak['streak'] >= leak_steps and _leak['growth'] >= leak_bytes \
            and not _leak['latched']:
        _leak['latched'] = True
        _leak['latched_step'] = step
        from . import flight as _flight
        _flight.note('memory.leak_suspected',
                     step=step, growth_bytes=int(_leak['growth']),
                     steps=int(_leak['streak']), live_bytes=int(live))
        if _telem['on']:
            from . import metrics as _metrics
            _metrics.inc('mxnet_tpu_memory_leaks_suspected_total')


def leak_state():
    """{'latched', 'streak', 'growth_bytes', 'latched_step'} — the
    detector's current view (tests + the OOM dump)."""
    return {'latched': _leak['latched'], 'streak': _leak['streak'],
            'growth_bytes': _leak['growth'],
            'latched_step': _leak['latched_step']}


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

def is_oom_error(e):
    """Is this exception a device-allocator exhaustion? Matches
    ``torch.cuda.OutOfMemoryError``, the allocator's text ("CUDA out of
    memory", and the JAX package's RESOURCE_EXHAUSTED wording) and the
    injected ``alloc.oom`` fault, never ordinary errors."""
    try:
        from ..resilience import faults as _faults
        if isinstance(e, _faults.InjectedFault) \
                and getattr(e, 'site', None) == 'alloc.oom':
            return True
    except Exception:
        pass
    try:
        import torch
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    msg = str(e)
    return ('out of memory' in msg or 'Out of memory' in msg
            or 'RESOURCE_EXHAUSTED' in msg or 'Resource exhausted' in msg)


class _OomGuard:
    """Reusable per-site context manager (no allocation per step): fires
    the deterministic ``alloc.oom`` fault on entry and, when the guarded
    block dies of an allocator failure (real or injected), writes the
    forensics dump before the error propagates."""

    __slots__ = ('site',)

    def __init__(self, site):
        self.site = site

    def __enter__(self):
        from ..resilience import faults as _faults
        try:
            _faults.fire('alloc.oom')
        except _faults.InjectedFault as e:
            # an injected raise surfaces HERE (before the body runs),
            # where __exit__ never sees it — dump and re-raise so the
            # drill leaves exactly the post-mortem a real OOM would
            if is_oom_error(e):
                try:
                    dump_oom(self.site, e)
                except Exception:
                    pass
            raise
        return self

    def __exit__(self, etype, e, tb):
        if e is not None and is_oom_error(e):
            try:
                dump_oom(self.site, e)
            except Exception:
                pass                    # forensics must never mask the OOM
        return False


_guards = {}


def oom_guard(site):
    """The shared guard for one dispatch site — always armed (the cost
    until an OOM fires is one dict check from the fault registry's
    disarmed fast path)."""
    g = _guards.get(site)
    if g is None:
        g = _guards[site] = _OomGuard(site)
    return g


def default_oom_path():
    """Where the forensics dump lands: ``MXTPU_FLIGHT_DIR`` (default: the
    system temp directory, never the CWD), ``mxtpu_oom-<pid>.json``."""
    from .. import config as _config
    d = _config.get('MXTPU_FLIGHT_DIR')
    if not d:
        import tempfile
        d = tempfile.gettempdir()
    return os.path.join(d, f'mxtpu_oom-{os.getpid()}.json')


def _allocator_segments(limit=16):
    """The caching allocator's largest segments on the card
    (``torch.cuda.memory_snapshot()``): ``[{'address', 'total_size',
    'allocated_size', 'stream', 'pool_id'}]``, descending; [] without a
    card. This stands in for the JAX package's list of live arrays: the
    allocator knows its segments, not which tensor holds them."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        segs = torch.cuda.memory_snapshot()
    except Exception:
        return []
    rows = [{'address': s.get('address'),
             'total_size': int(s.get('total_size', 0)),
             'allocated_size': int(s.get('allocated_size', 0)),
             'stream': s.get('stream'),
             'pool_id': str(s.get('segment_pool_id'))} for s in segs]
    rows.sort(key=lambda r: -r['total_size'])
    return rows[:int(limit)]


def dump_oom(site, error, path=None):
    """Write the OOM post-mortem JSON atomically; returns the path.
    Reads only host-side state and the allocator's bookkeeping — never a
    device sync (the device just refused an allocation)."""
    stats = device_memory_stats()
    fb_total, by_pool = tracked_bytes()
    doc = {
        'schema': OOM_SCHEMA,
        'pid': os.getpid(),
        'time': round(_time.time(), 3),
        'site': site,
        'error_type': type(error).__name__,
        'error': str(error)[:2000],
        'device_bytes': int(stats['bytes_in_use']) if stats is not None
        else fb_total,
        'source': 'memory_stats' if stats is not None else 'fallback',
        'peak_bytes': max(peak_bytes(), fb_total),
        'host_rss_bytes': host_rss_bytes(),
        'pools_bytes': by_pool,
        'top_arrays': top_arrays(),
        'allocator_segments': _allocator_segments(),
        'watermarks': watermarks(),
        'memory_analysis': None,
        'leak': leak_state(),
        'config': {'MXTPU_MEMORY': bool(_state['on'])},
        'hints': [],
    }
    if stats is not None:
        doc['limit_bytes'] = stats['bytes_limit']
        doc['reserved_bytes'] = stats['bytes_reserved']
    if path is None:
        path = default_oom_path()
    d = os.path.dirname(path)
    if d:
        # a fresh MXTPU_FLIGHT_DIR must not silently lose the one
        # artifact that explains the crash
        os.makedirs(d, exist_ok=True)
    from ..serialization import atomic_write_file
    atomic_write_file(path, json.dumps(doc, default=str).encode())
    from . import flight as _flight
    _flight.note('memory.oom', site=site, path=path,
                 device_bytes=doc['device_bytes'],
                 top=doc['top_arrays'][0]['name']
                 if doc['top_arrays'] else None)
    if _telem['on']:
        from . import metrics as _metrics
        _metrics.inc('mxnet_tpu_memory_oom_dumps_total', site=site)
    return path


_REQUIRED_OOM_KEYS = (
    'schema', 'pid', 'time', 'site', 'error', 'error_type',
    'device_bytes', 'source', 'peak_bytes', 'host_rss_bytes',
    'pools_bytes', 'top_arrays', 'watermarks', 'config', 'hints',
)


def validate_oom_dump(doc):
    """Schema check of an OOM post-mortem document; returns a list of
    problems (empty = valid). The drill and tests gate on this, so the
    dump format cannot drift silently."""
    problems = []
    if not isinstance(doc, dict):
        return ['not a JSON object']
    for k in _REQUIRED_OOM_KEYS:
        if k not in doc:
            problems.append(f'missing key {k!r}')
    if doc.get('schema') != OOM_SCHEMA:
        problems.append(f"schema {doc.get('schema')!r} != {OOM_SCHEMA!r}")
    if not isinstance(doc.get('watermarks'), list):
        problems.append('watermarks is not a list')
    tops = doc.get('top_arrays')
    if not isinstance(tops, list):
        problems.append('top_arrays is not a list')
    else:
        prev = None
        for i, row in enumerate(tops):
            for k in ('pool', 'name', 'nbytes'):
                if k not in row:
                    problems.append(f'top_arrays[{i}] missing {k!r}')
            nb = row.get('nbytes')
            if prev is not None and nb is not None and nb > prev:
                problems.append('top_arrays not sorted by nbytes desc')
            prev = nb if nb is not None else prev
    for h in doc.get('hints') or []:
        if 'action' not in h or 'projected_savings_bytes' not in h:
            problems.append(f'malformed hint {h!r}')
    if not isinstance(doc.get('pools_bytes'), dict):
        problems.append('pools_bytes is not a dict')
    return problems


# config gate (read at import; declared in config.py)
from .. import config as _config_mod  # noqa: E402

if _config_mod.get('MXTPU_MEMORY'):
    enable()
