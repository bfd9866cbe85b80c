"""Compilation observability: the compile ledger, recompile forensics and
the kernel build directory's hit/miss counts (counterpart of
``mxnet_tpu/telemetry/compile.py``).

On the card the port compiles at three points:

- a **CUDA-graph capture** (``_capture.capture``: a hybridized block's
  bucket, the compiled training step, the Trainer's fused update);
- a **kernel build** (``ops/_build.py``: ``nvcc`` of a CUDA source, or a
  Triton kernel's first launch for a specialization);
- an **NVRTC compile** (``rtc.CudaModule``).

Each point reports its seconds with :func:`report`. A site that owns a
compile (``cachedop:<block>``, ``step:train_step``,
``trainer:fused_update``, ``serving:warmup_b{B}_s{S}``) wraps it in a
:func:`begin`/:func:`end` pair or in :func:`watching`; a report made
while such a window is open on the thread is one *phase* of that
window's entry, and a window that closes inside another hands its phase
seconds on to the outer one (a warmup bucket's entry carries the
capture of the block it served). A report made with no window open is
an entry of its own, under the point's own site (``kernel:<source>``,
``rtc:<kernel names>``, ``capture``).

The JAX ledger splits a compile into the phases ``jax.monitoring``
reports (``trace``, ``lower``, ``backend``); the port has no such hooks,
and its phases are ``build`` (nvcc, Triton, NVRTC) and ``capture``. An
entry's ``seconds`` is ``{'build', 'capture', 'total'}``; everything else
of the entry is the JAX ledger's: a structured per-argument signature
(shape, dtype, device as ``sharding``, donation) and flags, its
fingerprint, the device kind, ``nth`` per site, and, on a recompile, the
churning axes, which also go into the ``RecompileWarning``, the
``compile.recompiled`` flight note and ``mxnet_tpu_compile_churn_axes``.

Entries go to a bounded in-memory ring and, when ``MXTPU_COMPILE_LEDGER``
names a path, to an on-disk JSONL ledger written atomically (read,
append, bound, ``os.replace``).

The kernel build directory (``MXTPU_COMPILE_CACHE_DIR``, default
``build/mxnet_tpu_torch`` at the root of the checkout) plays the part of
the JAX package's persistent compilation cache: a library already built
there is a hit, an ``nvcc`` run a miss (:func:`persistent_cache_stats`).

Disarmed (the default), every entry point is a single flag/dict check
and allocates nothing.
"""
import collections
import hashlib
import json
import os
import tempfile
import threading
import time as _time

from . import metrics as _metrics
from . import trace as _trace
from .. import config as _config_mod

__all__ = [
    'enable', 'disable', 'enabled', 'clear',
    'begin', 'set_signature', 'end', 'abort', 'watching', 'report',
    'cache_event', 'cache_dir',
    'signature', 'arg_sig', 'array_sig', 'fingerprint', 'diff_signatures',
    'ledger', 'ledger_path', 'default_ledger_path',
    'in_flight', 'step_fields', 'snapshot_fields', 'health_fields',
    'persistent_cache_stats',
    'validate_ledger_entry', 'validate_ledger',
    'LEDGER_SCHEMA', 'PHASES',
]

LEDGER_SCHEMA = 'mxtpu_compile_ledger_v1'
PHASES = ('build', 'capture')

# required keys of one ledger entry (validate_ledger_entry enforces)
LEDGER_REQUIRED = ('schema', 'time', 'pid', 'site', 'nth', 'fingerprint',
                   'device_kind', 'signature', 'seconds')

_DEFAULT_RING = 256
_LEDGER_MAX_LINES = 512     # on-disk bound: keep the newest entries

_UNSET = object()

_state = {'on': False}
_lock = threading.RLock()
_cfg = {'ring': None, 'ledger': _UNSET, 'cache_dir': _UNSET}

_ring = collections.deque()              # ledger entries, oldest first
_sites = {}          # site -> {'n', 'signature', 'fingerprint'}
_inflight = {}       # tid -> {'site', 'phase', 'since', 'phase_since'}
_tls = threading.local()                 # .ctx: the open build context
_totals = {'n': 0, 'seconds': 0.0}
_last = {'fields': None, 'fresh': False}
_pcache = {'hits': 0, 'misses': 0}
_device = {'kind': None}
_ledger_err = {'warned': False}


# ---------------------------------------------------------------------------
# enable / configuration
# ---------------------------------------------------------------------------

def enable():
    _state['on'] = True


def disable():
    _state['on'] = False


def enabled() -> bool:
    return _state['on']


def clear(ring=None, ledger=_UNSET, cache_dir=_UNSET):
    """Drop every entry/site/counter and (optionally) override the ring
    depth, the ledger path ('' disables disk, None restores the
    MXTPU_COMPILE_LEDGER default) and the kernel build directory (None
    or '' restores MXTPU_COMPILE_CACHE_DIR / the default)."""
    with _lock:
        _ring.clear()
        _sites.clear()
        _inflight.clear()
        _pcache.update(hits=0, misses=0)
        _totals.update(n=0, seconds=0.0)
        _last['fields'] = None
        _last['fresh'] = False
        _cfg['ring'] = ring
        if ledger is not _UNSET:
            _cfg['ledger'] = ledger
        if cache_dir is not _UNSET:
            _cfg['cache_dir'] = cache_dir or _UNSET


def _ring_cap() -> int:
    n = _cfg['ring']
    return _DEFAULT_RING if n is None else max(1, int(n))


def default_ledger_path() -> str:
    d = _config_mod.get('MXTPU_FLIGHT_DIR') or tempfile.gettempdir()
    return os.path.join(d, f'mxtpu_compile_ledger-{os.getpid()}.jsonl')


def ledger_path():
    """The on-disk JSONL ledger path, or None when disk logging is off."""
    if _cfg['ledger'] is not _UNSET:
        return _cfg['ledger'] or None
    raw = _config_mod.get('MXTPU_COMPILE_LEDGER')
    if not raw:
        return None
    if raw.strip().lower() in ('1', 'on', 'true', 'yes'):
        return default_ledger_path()
    return raw


def ledger():
    """Snapshot of the in-memory ledger ring (oldest first)."""
    with _lock:
        return [dict(e) for e in _ring]


# ---------------------------------------------------------------------------
# the kernel build directory (the persistent cache's counterpart)
# ---------------------------------------------------------------------------

def cache_dir() -> str:
    """Where ``ops/_build.py`` puts and looks for built libraries."""
    if _cfg['cache_dir'] is not _UNSET:
        return _cfg['cache_dir']
    d = _config_mod.get('MXTPU_COMPILE_CACHE_DIR')
    if d:
        return d
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), 'build', 'mxnet_tpu_torch')


def cache_event(hit):
    """One library looked up in the build directory: found (a hit) or
    built by nvcc (a miss). Counted whether or not the ledger is armed
    (the counts are two integers); the metrics only when telemetry is."""
    key = 'hits' if hit else 'misses'
    with _lock:
        _pcache[key] += 1
    ctx = getattr(_tls, 'ctx', None)
    if ctx is not None:
        ctx['cache'][key] = ctx['cache'].get(key, 0) + 1
    if _metrics.enabled():
        _metrics.inc(f'mxnet_tpu_compile_persistent_cache_{key}_total')


def persistent_cache_stats():
    """Hit/miss counters plus the on-disk byte footprint of the kernel
    build directory (0 when absent)."""
    d = cache_dir()
    nbytes = 0
    entries = 0
    if d and os.path.isdir(d):
        for root, _dirs, files in os.walk(d):
            for f in files:
                try:
                    nbytes += os.path.getsize(os.path.join(root, f))
                    entries += 1
                except OSError:
                    pass
    with _lock:
        out = {'dir': d or None, 'hits': _pcache['hits'],
               'misses': _pcache['misses'], 'bytes': nbytes,
               'files': entries}
    if _metrics.enabled():
        _metrics.set_gauge('mxnet_tpu_compile_persistent_cache_bytes',
                           nbytes)
    return out


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def arg_sig(name, shape=None, dtype=None, sharding=None, donated=False):
    """One argument's signature row."""
    return {'name': str(name),
            'shape': None if shape is None else [int(s) for s in shape],
            'dtype': None if dtype is None else
            str(dtype).replace('torch.', ''),
            'sharding': None if sharding is None else str(sharding),
            'donated': bool(donated)}


def array_sig(name, x, donated=False):
    """Signature row read off a tensor or numpy array: its shape, its
    dtype (``bfloat16``, not ``torch.bfloat16``) and, for a tensor, its
    device in the ``sharding`` column (a non-tensor argument gets its
    repr as the dtype)."""
    shape = getattr(x, 'shape', None)
    if shape is None:
        return arg_sig(name, None, repr(x), None, donated)
    dev = getattr(x, 'device', None)
    return arg_sig(name, shape, getattr(x, 'dtype', None),
                   None if dev is None else str(dev), donated)


def signature(args=(), flags=None):
    """A build site's structured signature: per-arg rows + flag knobs
    (the kernel routes, the optimizer, ...)."""
    return {'args': list(args), 'flags': dict(flags or {})}


def fingerprint(sig) -> str:
    """16-hex-digit stable fingerprint of a structured signature."""
    blob = json.dumps(sig, sort_keys=True, separators=(',', ':'),
                      default=str)
    return hashlib.sha256(blob.encode('utf-8')).hexdigest()[:16]


def diff_signatures(old, new):
    """Name every churning axis between two signatures: a list of
    ``{'axis': shape|dtype|sharding|donation|flag|arity, 'detail': ...}``
    rows whose `detail` strings are human-grade ("arg 3 `data`: shape
    (32, 128)→(32, 131)")."""
    out = []
    oa = old.get('args', []) or []
    na = new.get('args', []) or []
    if len(oa) != len(na):
        out.append({'axis': 'arity',
                    'detail': f'arg count {len(oa)}→{len(na)}'})
    for i, (o, n) in enumerate(zip(oa, na)):
        name = n.get('name') or o.get('name') or str(i)
        for key, label in (('shape', 'shape'), ('dtype', 'dtype'),
                           ('sharding', 'sharding'),
                           ('donated', 'donation')):
            ov, nv = o.get(key), n.get(key)
            if ov == nv:
                continue
            if key == 'shape':
                ov = tuple(ov) if ov is not None else None
                nv = tuple(nv) if nv is not None else None
                detail = f'arg {i} `{name}`: shape {ov}→{nv}'
            elif key == 'donated':
                detail = (f'arg {i} `{name}`: donation '
                          f'{bool(ov)}→{bool(nv)}')
            else:
                detail = f'arg {i} `{name}`: {label} {ov}→{nv}'
            out.append({'axis': label, 'arg': i, 'name': name,
                        'detail': detail})
    of = old.get('flags', {}) or {}
    nf = new.get('flags', {}) or {}
    for k in sorted(set(of) | set(nf)):
        if of.get(k) != nf.get(k):
            out.append({'axis': 'flag', 'name': k,
                        'detail': f'flag `{k}`: {of.get(k)!r}→'
                                  f'{nf.get(k)!r}'})
    return out


def _sig_str(sig) -> str:
    try:
        return json.dumps(sig, sort_keys=True, default=str)
    except Exception:
        return repr(sig)


# ---------------------------------------------------------------------------
# build contexts
# ---------------------------------------------------------------------------

def begin(site, _span=True):
    """Open a compile window for `site`. Returns an opaque ctx to hand
    to :func:`set_signature` / :func:`end` / :func:`abort`, or None when
    the plane is disarmed."""
    if not _state['on']:
        return None
    now = _time.time()
    tid = threading.get_ident()
    ctx = {'site': site, 't0': now, 'mono0': _time.perf_counter(),
           'tid': tid, 'phases': {}, 'cache': {}, 'signature': None,
           'prev': getattr(_tls, 'ctx', None), 'span': None}
    if _span:
        ctx['span'] = _trace.span('compile.build', site=site)
        ctx['span'].__enter__()
    _tls.ctx = ctx
    with _lock:
        _inflight[tid] = {'site': site, 'phase': 'build', 'since': now,
                          'phase_since': now}
    return ctx


def set_signature(ctx, sig):
    if ctx is not None:
        ctx['signature'] = sig


def _close(ctx):
    if ctx.get('closed'):
        return
    ctx['closed'] = True
    if ctx.get('span') is not None:
        ctx['span'].__exit__(None, None, None)
        ctx['span'] = None
    prev = ctx.get('prev')
    _tls.ctx = prev
    if prev is not None:
        # an inner window's compile is part of the outer one's too
        for ph, s in ctx['phases'].items():
            prev['phases'][ph] = prev['phases'].get(ph, 0.0) + s
        for k, n in ctx['cache'].items():
            prev['cache'][k] = prev['cache'].get(k, 0) + n
    with _lock:
        if prev is not None:
            _inflight[ctx['tid']] = {'site': prev['site'], 'phase': 'build',
                                     'since': prev['t0'],
                                     'phase_since': _time.time()}
        else:
            _inflight.pop(ctx['tid'], None)


def abort(ctx):
    """Close a compile window without a ledger entry (nothing compiled,
    or an exception unwound the build)."""
    if ctx is None:
        return
    _close(ctx)


def report(phase, seconds, site, sig_fn=None):
    """One compile at a point of the port (``phase`` one of
    :data:`PHASES`) that took ``seconds``. With a window open on this
    thread it is a phase of that window; otherwise it is an entry of its
    own under ``site``, its signature from ``sig_fn()``. Disarmed: one
    dict check."""
    if not _state['on']:
        return None
    now = _time.time()
    _trace.complete('compile.' + phase, (now - seconds) * 1e6,
                    seconds * 1e6, site=site)
    ctx = getattr(_tls, 'ctx', None)
    if ctx is not None:
        ctx['phases'][phase] = ctx['phases'].get(phase, 0.0) + seconds
        fl = _inflight.get(ctx['tid'])
        if fl is not None:
            fl['phase'] = phase
            fl['phase_since'] = now
        return None
    ctx = begin(site, _span=False)
    ctx['mono0'] -= seconds
    ctx['phases'][phase] = seconds
    if sig_fn is not None:
        try:
            ctx['signature'] = sig_fn()
        except Exception:
            pass
    return end(ctx)


def end(ctx):
    """Close the compile window: ledger entry (ring + disk), recompile
    forensics against the site's previous signature and the phase
    metrics. Returns the ledger entry."""
    if ctx is None or ctx.get('closed'):
        return None
    total = _time.perf_counter() - ctx['mono0']
    _close(ctx)
    now = _time.time()
    site = ctx['site']
    sig = ctx['signature'] or signature()
    fp = fingerprint(sig)

    with _lock:
        st = _sites.get(site)
        prev_sig = st['signature'] if st else None
        nth = (st['n'] if st else 0) + 1
        _sites[site] = {'n': nth, 'signature': sig, 'fingerprint': fp}

    axes = diff_signatures(prev_sig, sig) if prev_sig is not None else []
    detail = '; '.join(a['detail'] for a in axes)

    phases = ctx['phases']
    seconds = {ph: round(phases.get(ph, 0.0), 6) for ph in PHASES}
    seconds['total'] = round(total, 6)
    entry = {'schema': LEDGER_SCHEMA, 'time': round(now, 6),
             'pid': os.getpid(), 'site': site, 'nth': nth,
             'fingerprint': fp, 'device_kind': _device_kind(),
             'backend': _backend_name(), 'signature': sig,
             'seconds': seconds}
    if ctx['cache']:
        entry['cache'] = dict(ctx['cache'])
    if axes:
        entry['churn_axes'] = [a['detail'] for a in axes]

    with _lock:
        _ring.append(entry)
        cap = _ring_cap()
        while len(_ring) > cap:
            _ring.popleft()
        _totals['n'] += 1
        _totals['seconds'] += total
        _last['fields'] = {'site': site, 'nth': nth, 'fingerprint': fp,
                           'seconds': seconds['total'],
                           'capture_seconds': seconds['capture']}
        _last['fresh'] = True

    if _metrics.enabled():
        for ph in PHASES:
            if seconds[ph]:
                _metrics.counter(
                    'mxnet_tpu_compile_phase_seconds_total').inc(
                        seconds[ph], site=site, phase=ph)
        _metrics.set_gauge('mxnet_tpu_compile_ledger_entries', len(_ring))

    if nth > 1:
        if _metrics.enabled():
            for a in axes:
                _metrics.inc('mxnet_tpu_compile_churn_axes', site=site,
                             axis=a['axis'])
        from . import flight as _flight
        _flight.note('compile.recompiled', site=site, nth=nth,
                     fingerprint=fp, seconds=seconds['total'],
                     axes=[a['detail'] for a in axes] or
                     ['identical signature (new program instance)'])

    # the per-site compile counters + the episode-latched
    # RecompileWarning, naming the exact churning axis
    if _metrics.enabled():
        _metrics.record_compile(site, _sig_str(sig), total, detail=detail)

    path = ledger_path()
    if path:
        _append_ledger(path, entry)
    return entry


class _Watch:
    """Armed `watching` context: a compile window that only records a
    ledger entry when something compiled inside the block."""
    __slots__ = ('site', 'sig_fn', 'ctx')

    def __init__(self, site, sig_fn):
        self.site = site
        self.sig_fn = sig_fn

    def __enter__(self):
        self.ctx = begin(self.site, _span=False)
        return self

    def __exit__(self, etype, evalue, tb):
        ctx, self.ctx = self.ctx, None
        if ctx is None:
            return False
        if etype is not None or not ctx['phases']:
            abort(ctx)
            return False
        if self.sig_fn is not None:
            try:
                ctx['signature'] = self.sig_fn()
            except Exception:
                pass
        end(ctx)
        return False


class _NullWatch:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_WATCH = _NullWatch()


def watching(site, sig_fn=None):
    """Hot-path compile window (a serving dispatch that may capture):
    disarmed it is a shared no-op context; armed it opens a window that
    records only if a compile occurred. `sig_fn` is evaluated lazily,
    only when an entry is written."""
    if not _state['on']:
        return _NULL_WATCH
    return _Watch(site, sig_fn)


# ---------------------------------------------------------------------------
# ledger disk
# ---------------------------------------------------------------------------

def _append_ledger(path, entry):
    try:
        from ..serialization import atomic_write_file
        old = b''
        try:
            with open(path, 'rb') as f:
                old = f.read()
        except FileNotFoundError:
            pass
        lines = old.splitlines() if old else []
        lines.append(json.dumps(entry, sort_keys=True,
                                default=str).encode('utf-8'))
        if len(lines) > _LEDGER_MAX_LINES:
            lines = lines[-_LEDGER_MAX_LINES:]
        atomic_write_file(path, b'\n'.join(lines) + b'\n')
    except Exception as e:
        if _metrics.enabled():
            _metrics.inc('mxnet_tpu_compile_ledger_errors_total')
        if not _ledger_err['warned']:
            _ledger_err['warned'] = True
            import warnings
            warnings.warn(f'telemetry.compile: ledger append to {path!r} '
                          f'failed ({e!r}); further failures are counted '
                          f'silently', RuntimeWarning, stacklevel=2)


# ---------------------------------------------------------------------------
# plane integration (flight / healthz)
# ---------------------------------------------------------------------------

def in_flight():
    """The oldest open compile window as ``{'site', 'phase',
    'elapsed_seconds'}``, or None. One dict check when nothing is
    compiling."""
    if not _inflight:
        return None
    with _lock:
        if not _inflight:
            return None
        fl = min(_inflight.values(), key=lambda f: f['since'])
        return {'site': fl['site'], 'phase': fl['phase'],
                'elapsed_seconds': round(_time.time() - fl['since'], 3)}


def step_fields():
    """Compact fields for the flight-recorder step record — only on the
    first step after a compile (consume-on-read), so steady-state steps
    carry no compile noise. Disarmed: one dict check, no allocation."""
    if not _state['on']:
        return None
    if not _last['fresh']:
        return None
    _last['fresh'] = False
    return _last['fields']


def snapshot_fields():
    """The fleet-snapshot payload: cumulative compile count and seconds
    and the open compile window, or None while disarmed."""
    if not _state['on']:
        return None
    out = {'n': _totals['n'], 'seconds': round(_totals['seconds'], 3)}
    fl = in_flight()
    if fl is not None:
        out['in_flight'] = fl
    return out


def health_fields():
    """The compile document of a health report — cold path."""
    out = {'enabled': _state['on'], 'compiles': _totals['n'],
           'seconds': round(_totals['seconds'], 3)}
    with _lock:
        if _ring:
            e = _ring[-1]
            out['last'] = {'site': e['site'], 'nth': e['nth'],
                           'fingerprint': e['fingerprint'],
                           'seconds': e['seconds']['total'],
                           'time': e['time']}
    fl = in_flight()
    if fl is not None:
        out['in_flight'] = fl
    p = ledger_path()
    if p:
        out['ledger_path'] = p
    out['persistent_cache'] = persistent_cache_stats()
    return out


def _device_kind():
    if _device['kind'] is None:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return 'cpu'
        _device['kind'] = torch.cuda.get_device_name(
            torch.cuda.current_device())
    return _device['kind']


def _backend_name():
    return 'cpu' if _device_kind() == 'cpu' else 'cuda'


# ---------------------------------------------------------------------------
# ledger validation
# ---------------------------------------------------------------------------

def validate_ledger_entry(e):
    """Problems with one ledger entry (empty list = valid)."""
    problems = []
    if not isinstance(e, dict):
        return [f'entry is {type(e).__name__}, not an object']
    if e.get('schema') != LEDGER_SCHEMA:
        problems.append(f"schema {e.get('schema')!r} != {LEDGER_SCHEMA!r}")
    for k in LEDGER_REQUIRED:
        if k not in e:
            problems.append(f'missing key {k!r}')
    if problems:
        return problems
    if not isinstance(e['site'], str) or not e['site']:
        problems.append('site must be a non-empty string')
    if not isinstance(e['nth'], int) or e['nth'] < 1:
        problems.append(f"nth {e['nth']!r} must be an int >= 1")
    sec = e['seconds']
    if not isinstance(sec, dict):
        problems.append('seconds must be an object')
    else:
        for k in PHASES + ('total',):
            v = sec.get(k)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(f'seconds.{k} {v!r} must be a number >= 0')
    sig = e['signature']
    if not isinstance(sig, dict) or 'args' not in sig:
        problems.append('signature must be an object with an args list')
    else:
        fp = fingerprint(sig)
        if fp != e['fingerprint']:
            problems.append(f"fingerprint {e['fingerprint']!r} does not "
                            f'match its signature (recomputed {fp!r})')
    return problems


def validate_ledger(entries):
    """Problems with a whole ledger: per-entry shape, monotone
    timestamps and nth per (pid, site), and the same-fingerprint ⇒
    same-signature invariant."""
    problems = []
    last_time = {}
    last_nth = {}
    fp_sig = {}
    for i, e in enumerate(entries):
        for p in validate_ledger_entry(e):
            problems.append(f'entry {i}: {p}')
        if not isinstance(e, dict) or 'time' not in e:
            continue
        pid = e.get('pid')
        t = e.get('time')
        if isinstance(t, (int, float)):
            lt = last_time.get(pid)
            if lt is not None and t < lt:
                problems.append(f'entry {i}: time {t} went backwards '
                                f'(previous {lt}) for pid {pid}')
            last_time[pid] = t
        key = (pid, e.get('site'))
        nth = e.get('nth')
        if isinstance(nth, int):
            ln = last_nth.get(key)
            if ln is not None and nth <= ln:
                problems.append(f'entry {i}: nth {nth} not increasing '
                                f'(previous {ln}) for site {key[1]!r}')
            last_nth[key] = nth
        fp = e.get('fingerprint')
        sig = e.get('signature')
        if fp is not None and sig is not None:
            seen = fp_sig.get(fp)
            if seen is None:
                fp_sig[fp] = sig
            elif seen != sig:
                problems.append(f'entry {i}: fingerprint {fp!r} maps to '
                                f'two different signatures')
    return problems


# config gate: MXTPU_COMPILE_LEDGER arms the plane at import
if _config_mod.get('MXTPU_COMPILE_LEDGER'):
    enable()
