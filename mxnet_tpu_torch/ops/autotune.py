"""Searched, not hardcoded: the flash-attention tile autotuner
(counterpart of ``mxnet_tpu/ops/autotune.py``).

The port's tensor-core flash kernels (``csrc/flash_fwd_tc.cuh``,
``csrc/flash_bwd_tc.cuh``) take their tile, BQ q rows and BK keys, as
template parameters, and a fixed set of tiles is built
(``flash_attention.TILES``). This module picks one per shape, as the JAX
module picks the Pallas kernels' (G, bq, bk) blocks, with the same API,
the same tuning DB and the same precedence; the legality rules are
Hopper's in place of Mosaic's:

1. **Legality** (:func:`check_candidate`, :func:`legal_candidates`):
   G = 1 only (the grid already gives each batch*head slice its own
   blocks); the tile is a multiple of the 16-row ``mma.sync`` fragment
   (:func:`sublane_min`), whole head-dim rows (:func:`tile_legal`), at most
   1024 threads a block (one warp per 16 rows: 2 * BQ threads for the
   forward and dq kernels, 2 * BK for dk/dv), shared memory within the
   232,448 bytes a block may opt into (:func:`smem_bytes`, the launchers'
   own formula), and built. ``kind='bwd'`` sizes the dq and the dk/dv
   kernel with one (bq, bk), as one JAX triple sizes both backward
   kernels. The f32 (and D = 8) SIMT kernels have one tile, (64, 64).
   On the card the sweep also prunes, before timing, every built tile
   that uses more than 255 registers or spills to local memory
   (``cudaFuncGetAttributes``); on the CPU that rule is unchecked and the
   report says so.

2. **Sweep** (:func:`sweep_flash_attention`): on the card each surviving
   tile is built and warmed outside the timed window (the build under
   the compile-ledger site ``autotune:flash_attention``), checked against
   the plain version, and timed with CUDA events around replays of a CUDA
   graph of 10 calls (device time, not the host's launches), the median
   of ``MXTPU_AUTOTUNE_REPS``; on the CPU the candidates are ranked by
   :func:`analytic_cost`. Winners go to the JSON tuning DB under
   ``MXTPU_AUTOTUNE_DIR``, the JAX package's file, version and layout,
   keyed by (device kind, kernel, shape signature). The device kind is
   ``torch.cuda.get_device_name()`` with spaces as ``_`` (``cpu`` without a
   card), so an entry the JAX package wrote for a TPU is never applied on
   the H100.

3. **Resolution** (:func:`resolve`, called from
   ``flash_attention._block_sizes``): sweep-forced > env override
   (``MXTPU_FA_*``) > DB winner > the default (1, 64, 64); then the
   clamps: a G other than 1 to 1, a tile that is not legal or not built
   for the shape to the default. Each decision, its clamps included, is
   recorded (:func:`decisions`, :func:`decision_flags`), and
   ``ShardedTrainStep`` folds the flags into its compile signature.

Telemetry: the JAX counters ``mxnet_tpu_autotune_*`` (candidates pruned
and timed, sweep seconds, DB hits and misses) and the ``autotune.sweep``
span.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings

import torch

from ..base import MXNetError, telem_flags as _telem

__all__ = [
    'sublane_min', 'tile_legal', 'fa_block_layouts', 'smem_bytes',
    'check_candidate', 'legal_candidates', 'analytic_cost', 'shape_sig',
    'db_path', 'load_db', 'db_lookup', 'record_winner', 'resolve',
    'decisions', 'decision_flags', 'clear', 'forced',
    'sweep_flash_attention',
]

KERNEL_FA = 'flash_attention'
DB_BASENAME = 'mxtpu_autotune.json'
DB_VERSION = 1

SMEM_BUDGET = 232448         # dynamic shared memory a block may opt into
MAX_THREADS = 1024
MAX_REGISTERS = 255
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
SMS = 132

# the forward and backward tolerances of a tile against the plain
# version (PERF.md section 2: the kernel bounds of bf16, f16 and f32)
TOLERANCE = {torch.bfloat16: (1e-2, 1.6e-2), torch.float16: (2e-3, 2e-3),
             torch.float32: (1e-4, 1e-4)}


def _metrics_mod():
    from ..telemetry import metrics as _metrics
    return _metrics


def _fa():
    from . import flash_attention
    return flash_attention


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace('torch.', '')
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise MXNetError(f"autotune: unknown dtype {dtype!r}")
    return out


def _dtype_name(dtype):
    return str(_dtype(dtype)).replace('torch.', '')


# ---------------------------------------------------------------------------
# Hopper legality rules
# ---------------------------------------------------------------------------

def sublane_min(dtype) -> int:
    """The least tile edge: 16 rows (one ``mma.sync`` m16 fragment, one
    warp's rows) for the 16-bit tensor-core kernels; the f32 SIMT
    kernels have the one tile 64."""
    return 16 if _dtype(dtype).itemsize == 2 else 64


def tile_legal(array_shape, block_shape, dtype):
    """The rule for ONE operand block: its sequence dim a multiple of
    :func:`sublane_min` (the kernels mask a ragged edge, so it need not
    divide the array's) and its last dim the whole array dim (a block
    keeps whole head-dim rows, or whole key-mask rows). Returns (ok,
    reason-or-None)."""
    if len(array_shape) != len(block_shape):
        return False, (f"rank mismatch: block {block_shape} vs array "
                       f"{array_shape}")
    sub = sublane_min(dtype)
    seq = block_shape[-2] if len(block_shape) >= 2 else None
    if seq is not None and seq != 1 and seq % sub:
        return False, (f"sequence dim {seq} is not a multiple of the "
                       f"{sub}-row tile")
    if block_shape[-1] != array_shape[-1] and len(block_shape) >= 2 \
            and block_shape[-2] != 1:
        return False, (f"last dim {block_shape[-1]} is not the whole "
                       f"array dim {array_shape[-1]}")
    return True, None


def fa_block_layouts(BH, Tq, Tk, D, kind, G, bq, bk):
    """(name, array_shape, block_shape) of every operand block the flash
    kernels of ``kind`` take at (G, bq, bk): the JAX list, with the
    sequence dims unpadded (the port's kernels mask the ragged edge)."""
    layouts = [
        ('q', (BH, Tq, D), (G, bq, D)),
        ('k', (BH, Tk, D), (G, bk, D)),
        ('v', (BH, Tk, D), (G, bk, D)),
        ('kmask', (BH, 1, Tk), (G, 1, bk)),
        ('lse', (BH, Tq, 1), (G, bq, 1)),
    ]
    if kind == 'fwd':
        layouts.append(('out', (BH, Tq, D), (G, bq, D)))
    else:
        layouts += [('do', (BH, Tq, D), (G, bq, D)),
                    ('delta', (BH, Tq, 1), (G, bq, 1)),
                    ('dq', (BH, Tq, D), (G, bq, D)),
                    ('dk', (BH, Tk, D), (G, bk, D)),
                    ('dv', (BH, Tk, D), (G, bk, D))]
    return layouts


def _kernels(kind):
    return ('fwd',) if kind == 'fwd' else ('dq', 'dkv')


def smem_bytes(G, bq, bk, D, kind, itemsize=2):
    """Dynamic shared memory of one block, the launchers' formula
    (``smem_bytes``, ``dq_smem_bytes``, ``dkv_smem_bytes`` in
    ``csrc/flash_*_tc.cuh``); for ``kind='bwd'`` the larger of the dq and
    dk/dv kernels'. Rows are padded to D + 8; G is 1."""
    ld = D + 8
    if kind == 'fwd':
        return itemsize * (bq * ld + 4 * bk * ld) + 4 * 2 * bk
    dq = itemsize * (2 * bq * ld + 4 * bk * ld) + 4 * (2 * bk + 2 * bq)
    dkv = itemsize * (2 * bk * ld + 4 * bq * ld) + 4 * 4 * bq
    return max(dq, dkv)


def _threads(kernel, bq, bk):
    return 2 * (bk if kernel == 'dkv' else bq)


def check_candidate(BH, Tq, Tk, D, dtype, kind, G, bq, bk):
    """Full static legality of one (G, bq, bk) candidate. Returns (ok,
    reason-or-None); every reason names the rule."""
    dtype = _dtype(dtype)
    fa = _fa()
    if G != 1:
        return False, (f"G={G}: the port's grid gives each batch*head "
                       f"slice its own blocks (G = 1 only)")
    if bq < 1 or bk < 1:
        return False, f"non-positive tile ({bq}, {bk})"
    if fa.kernel_variant(dtype, D) != 'tc':
        if (bq, bk) != fa.DEFAULT_TILE:
            return False, (f"the SIMT kernel ({_dtype_name(dtype)}, D={D}) "
                           f"has the one tile {fa.DEFAULT_TILE}")
        return True, None
    sub = sublane_min(dtype)
    if bq % sub or bk % sub:
        return False, (f"tile ({bq}, {bk}) is not a multiple of the "
                       f"{sub}-row mma fragment")
    for name, ashape, bshape in fa_block_layouts(BH, Tq, Tk, D, kind,
                                                 G, bq, bk):
        ok, why = tile_legal(ashape, bshape, dtype)
        if not ok:
            return False, f"{name}: {why}"
    for kernel in _kernels(kind):
        n = _threads(kernel, bq, bk)
        if n > MAX_THREADS:
            return False, (f"{kernel}: {n} threads a block exceed "
                           f"{MAX_THREADS}")
    sb = smem_bytes(G, bq, bk, D, kind, dtype.itemsize)
    if sb > SMEM_BUDGET:
        return False, (f"shared memory {sb} bytes exceeds the "
                       f"{SMEM_BUDGET}-byte budget")
    for kernel in _kernels(kind):
        if not fa.tile_built(kernel, D, (bq, bk)):
            return False, (f"{kernel}: tile ({bq}, {bk}) at D={D} is not "
                           f"built")
    return True, None


def legal_candidates(BH, Tq, Tk, D, dtype, kind='fwd'):
    """All statically legal (G, bq, bk) candidates of one kernel instance,
    and the count of enumerated-but-pruned ones. The space is the JAX
    one's shape: G over the divisors of BH up to 16, bq and bk powers of
    two from the least tile edge to 256."""
    out, pruned = [], 0
    for G, bq, bk, ok, _why in _enumerate(BH, Tq, Tk, D, dtype, kind):
        if ok:
            out.append((G, bq, bk))
        else:
            pruned += 1
    if _telem['on']:
        _metrics_mod().inc('mxnet_tpu_autotune_candidates_pruned_total',
                           pruned)
    return out, pruned


def _enumerate(BH, Tq, Tk, D, dtype, kind):
    sides = []
    b = 16
    while b <= 256:
        sides.append(b)
        b *= 2
    for G in (g for g in (1, 2, 4, 8, 16) if g <= BH and BH % g == 0):
        for bq in sides:
            for bk in sides:
                ok, why = check_candidate(BH, Tq, Tk, D, dtype, kind,
                                          G, bq, bk)
                yield G, bq, bk, ok, why


def analytic_cost(BH, Tq, Tk, D, dtype, kind, G, bq, bk):
    """Model seconds used to rank legal candidates (and, on the CPU, as
    the ranking): each block streams its own tile once and the other
    side's whole sequence from HBM at 3.35 TB/s, and the blocks run in
    waves over 132 SMs, so a last wave that is not full costs a whole
    wave. A ranking heuristic, not a simulator: on the card the sweep
    measures."""
    item = _dtype(dtype).itemsize
    nq, nk = -(-Tq // bq), -(-Tk // bk)

    def kernel_s(blocks, per_block_bytes):
        waves = -(-blocks // SMS)
        return blocks * per_block_bytes / HBM_BYTES_PER_S * \
            (waves * SMS / blocks)

    if kind == 'fwd':
        # q tile in, o tile out; all of k and v streamed
        return kernel_s(BH * nq, (2 * bq + 2 * Tk) * D * item)
    # dq: q, dO in and dq out by tile, k and v streamed; dk/dv: k, v in
    # and dk, dv out by tile, q and dO streamed
    return kernel_s(BH * nq, (3 * bq + 2 * Tk) * D * item) + \
        kernel_s(BH * nk, (4 * bk + 2 * Tq) * D * item)


# ---------------------------------------------------------------------------
# shape signatures + tuning DB (the JAX package's format)
# ---------------------------------------------------------------------------

def shape_sig(BH, Tq, Tk, D, dtype, kind):
    """Canonical shape-signature key: BH{.}Tq{.}Tk{.}D{.}dtype.kind."""
    return (f"BH{int(BH)}.Tq{int(Tq)}.Tk{int(Tk)}.D{int(D)}."
            f"{_dtype_name(dtype)}.{kind}")


def device_kind():
    """The card's name with spaces as '_' ('NVIDIA_H100_80GB_HBM3'), or
    'cpu' without a card."""
    if not torch.cuda.is_available():
        return 'cpu'
    return torch.cuda.get_device_name().replace(' ', '_')


def db_path(dir_=None):
    """Path of the tuning DB under ``dir_`` (default: the registered
    ``MXTPU_AUTOTUNE_DIR`` knob), or None when no directory is set."""
    if dir_ is None:
        from .. import config as _config
        dir_ = _config.get('MXTPU_AUTOTUNE_DIR')
    if not dir_:
        return None
    return os.path.join(dir_, DB_BASENAME)


_lock = threading.Lock()
_db_cache = {}           # path -> ((mtime, size), doc)
_corrupt_warned = set()  # paths already warned about


def load_db(path):
    """Parsed tuning DB at ``path`` ({} when absent). A corrupt or
    truncated DB falls back to {} (the defaults stay in force) with ONE
    warning per path per process."""
    try:
        st = os.stat(path)
    except OSError:
        return {}
    key = (st.st_mtime_ns, st.st_size)
    with _lock:
        cached = _db_cache.get(path)
        if cached is not None and cached[0] == key:
            return cached[1]
    try:
        with open(path, 'rb') as f:
            raw = json.loads(f.read().decode('utf-8'))
        if not isinstance(raw, dict) or 'entries' not in raw \
                or not isinstance(raw['entries'], dict):
            raise ValueError('missing "entries" table')
        doc = raw
    except Exception as e:
        with _lock:
            first = path not in _corrupt_warned
            _corrupt_warned.add(path)
        if first:
            warnings.warn(
                f"autotune DB {path!r} is corrupt or truncated ({e}); "
                f"falling back to the built-in tile defaults",
                RuntimeWarning)
        return {}
    with _lock:
        _db_cache[path] = (key, doc)
    return doc


def db_lookup(kernel, sig, dir_=None):
    """DB winner (G, bq, bk) of (device kind, kernel, sig), or None.
    Counts mxnet_tpu_autotune_db_{hits,misses}_total."""
    path = db_path(dir_)
    if path is None:
        return None
    entry = load_db(path).get('entries', {}).get(
        f"{device_kind()}/{kernel}/{sig}")
    try:
        g, bq, bk = (int(x) for x in entry['blocks'])
    except Exception:
        if _telem['on']:
            _metrics_mod().inc('mxnet_tpu_autotune_db_misses_total')
        return None
    if _telem['on']:
        _metrics_mod().inc('mxnet_tpu_autotune_db_hits_total')
    return g, bq, bk


def record_winner(kernel, sig, blocks, info=None, dir_=None):
    """Atomically merge one winner into the tuning DB (read, modify,
    ``serialization.atomic_write_file``). Returns the DB path."""
    path = db_path(dir_)
    if path is None:
        raise MXNetError(
            "autotune: no tuning-DB directory; set MXTPU_AUTOTUNE_DIR "
            "or pass dir_= to record_winner()")
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    doc = load_db(path)
    if not doc:
        doc = {'version': DB_VERSION, 'entries': {}}
    entry = {'blocks': [int(b) for b in blocks]}
    if info:
        entry.update(info)
    doc['entries'][f"{device_kind()}/{kernel}/{sig}"] = entry
    from ..serialization import atomic_write_file
    atomic_write_file(path, json.dumps(doc, indent=1,
                                       sort_keys=True).encode('utf-8'))
    with _lock:
        _db_cache.pop(path, None)
    return path


# ---------------------------------------------------------------------------
# resolution (the _block_sizes seam)
# ---------------------------------------------------------------------------

_forced = {}      # (kernel, kind) -> (G, bq, bk), sweep-internal precedence
_decisions = {}   # "kernel:sig" -> decision dict, process-global


@contextlib.contextmanager
def forced(kernel, kind, blocks):
    """Sweep-internal context: ``resolve`` returns ``blocks`` (clamped as
    any other source) for every (kernel, kind) instance inside."""
    key = (kernel, kind)
    with _lock:
        prev = _forced.get(key)
        _forced[key] = tuple(int(b) for b in blocks)
    try:
        yield
    finally:
        with _lock:
            if prev is None:
                _forced.pop(key, None)
            else:
                _forced[key] = prev


def _env_overrides(kind):
    """Registered MXTPU_FA_{G,BQ,BK} / MXTPU_FA_BWD_* values (None when
    unset; 0 and negatives mean unset too)."""
    from .. import config as _config
    pre = 'MXTPU_FA_BWD_' if kind == 'bwd' else 'MXTPU_FA_'
    out = {}
    for field in ('G', 'BQ', 'BK'):
        val = _config.get(pre + field)
        out[field.lower()] = int(val) if val and val > 0 else None
    return out


def resolve(kernel, BH, Tq, Tk, D, dtype, kind, default):
    """The (G, bq, bk) a launch should use, with precedence (sweep-forced)
    > env override > DB winner > ``default``, then the clamps: G to 1,
    and a tile that is not legal or not built for this shape to
    ``default``'s. Records the decision (source and clamps)."""
    sig = shape_sig(BH, Tq, Tk, D, dtype, kind)
    with _lock:
        force = _forced.get((kernel, kind))
    env = _env_overrides(kind)
    if force is not None:
        G, bq, bk = force
        source = 'forced'
    elif any(v is not None for v in env.values()):
        base = db_lookup(kernel, sig) or default
        G = env['g'] if env['g'] is not None else base[0]
        bq = env['bq'] if env['bq'] is not None else base[1]
        bk = env['bk'] if env['bk'] is not None else base[2]
        source = 'env'
    else:
        win = db_lookup(kernel, sig)
        if win is not None:
            G, bq, bk = win
            source = 'db'
        else:
            G, bq, bk = default
            source = 'default'
    clamps = []
    if G != 1:
        clamps.append(f"G={G} -> 1")
        G = 1
    ok, why = check_candidate(BH, Tq, Tk, D, dtype, kind, G, bq, bk)
    if not ok:
        clamps.append(f"({bq}, {bk}) -> ({default[1]}, {default[2]}): "
                      f"{why}")
        bq, bk = default[1], default[2]
    decision = {'blocks': (G, bq, bk), 'source': source}
    if clamps:
        decision['clamps'] = clamps
    with _lock:
        _decisions[f"{kernel}:{sig}"] = decision
    return G, bq, bk


def decisions():
    """Snapshot of every decision made in this process:
    {"kernel:shape-sig": {'blocks': (G, bq, bk), 'source': ...,
    'clamps': [...] where a clamp applied}}."""
    with _lock:
        return {k: dict(v) for k, v in _decisions.items()}


def decision_flags():
    """The decisions as a flat {key: "source:GxBQxBK"} dict, the form
    ``ShardedTrainStep`` folds into its compile signature."""
    with _lock:
        return {k: f"{v['source']}:{'x'.join(map(str, v['blocks']))}"
                for k, v in sorted(_decisions.items())}


def clear():
    """Reset the decision registry, DB cache, corrupt-DB warnings and
    forced blocks."""
    with _lock:
        _decisions.clear()
        _db_cache.clear()
        _corrupt_warned.clear()
        _forced.clear()


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _attr_pruned(kind, dtype, D, tile):
    """The reason a built tile may not run (registers over 255 or local
    memory, i.e. spills, per ``cudaFuncGetAttributes``), or None."""
    fa = _fa()
    for kernel in _kernels(kind):
        a = fa.tile_attributes(kernel, dtype, D, tile)
        if a['registers'] > MAX_REGISTERS or a['local_bytes'] > 0 or \
                a['max_threads'] < _threads(kernel, *tile):
            return (f"{fa.tile_kernel_name(kernel, dtype, D, tile)}: "
                    f"{a['registers']} registers, {a['local_bytes']} "
                    f"bytes local, at most {a['max_threads']} threads")
    return None


def _inputs(batch, heads, seq, head_dim, dtype, device, seed, key_mask):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device=device,
                                                    dtype=dtype)

    q, k, v, do = (rnd(batch, heads, seq, head_dim) for _ in range(4))
    mask = None
    if key_mask is not None:
        mask = key_mask.to(device=device, dtype=torch.float32)
    return q, k, v, do, mask


def _max_err(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _within(got, want, dtype):
    atol, rtol = TOLERANCE[dtype]
    return all(bool(((a.float() - b.float()).abs() <=
                     atol + rtol * b.float().abs()).all())
               for a, b in zip(got, want))


def _time_ms(fn, reps, inner=10):
    """Median device ms of one call of ``fn`` over ``reps`` timings: the
    calls are captured ``inner`` at a time into one CUDA graph (after a
    warm call), so the CUDA events around a replay time the kernels and
    not the host's launches of them."""
    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(inner):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    times.sort()
    return times[len(times) // 2]


def sweep_flash_attention(batch=1, heads=12, seq=512, head_dim=64,
                          dtype=torch.float32, kinds=('fwd', 'bwd'),
                          reps=None, max_timed=8, db_dir=None, measure=None,
                          causal=False, key_mask=None, dropout_p=0.0):
    """Sweep the flash-attention tiles of one shape and persist the
    winners in the tuning DB.

    measure: None (time candidates when a card is present, else rank by
    :func:`analytic_cost`), or an explicit bool (True needs a card).
    ``key_mask`` ((batch, seq) additive f32) and ``dropout_p`` make the
    timed call the training call. Only the ``max_timed`` analytically
    best survivors are timed. Each timed candidate is first held against
    the plain version (``TOLERANCE``); one that disagrees is reported
    with ``error`` and cannot win.

    Returns {'shape', 'device_kind', 'mode', 'db', 'sweep_seconds', and per
    kind {'winner', 'source', 'candidates', 'pruned', 'pruned_reasons',
    'registers', 'signature', 'ranking'}}; each ranking row holds
    'blocks' and 'analytic_ms', and when measured 'median_ms',
    'max_abs_err' (or 'error')."""
    from .. import config as _config
    from ..telemetry import compile as _compile, trace as _trace
    from . import _build
    fa = _fa()
    dtype = _dtype(dtype)
    if measure is None:
        measure = torch.cuda.is_available()
    if measure and not torch.cuda.is_available():
        raise MXNetError("autotune: a measured sweep needs a card")
    if reps is None:
        reps = int(_config.get('MXTPU_AUTOTUNE_REPS'))
    BH = batch * heads
    report = {'shape': {'batch': batch, 'heads': heads, 'seq': seq,
                        'head_dim': head_dim, 'dtype': _dtype_name(dtype),
                        'mask': key_mask is not None,
                        'dropout_p': float(dropout_p)},
              'device_kind': device_kind(),
              'mode': 'measured' if measure else 'analytic'}
    t_sweep = time.perf_counter()
    with _trace.span('autotune.sweep', kernel=KERNEL_FA,
                     shape=f"b{batch}h{heads}s{seq}d{head_dim}"):
        if measure:
            # every library the candidates may need, outside any timing
            cctx = _compile.begin(f'autotune:{KERNEL_FA}')
            try:
                _build.build_all()
            except BaseException:
                _compile.abort(cctx)
                raise
            _compile.end(cctx)
            dev = torch.device('cuda', torch.cuda.current_device())
            q, k, v, do, mask = _inputs(batch, heads, seq, head_dim, dtype,
                                        dev, 0, key_mask)
            seed = torch.tensor([1234], dtype=torch.int64, device=dev)
            kw = dict(key_mask=mask, causal=causal, dropout_p=dropout_p,
                      dropout_seed=seed if dropout_p > 0 else None)
            with torch.no_grad():
                out, lse = fa.flash_attention_reference(
                    q, k, v, key_mask=mask, causal=causal,
                    dropout_p=dropout_p, dropout_seed=kw['dropout_seed'])
                ref = {'fwd': (out,),
                       'bwd': fa.flash_attention_backward_reference(
                           q, k, v, mask, causal, dropout_p,
                           kw['dropout_seed'], out, lse, do)}
            calls = {
                'fwd': lambda: fa.flash_attention_forward(q, k, v, **kw)[:1],
                'bwd': lambda: fa.flash_attention_backward(
                    q, k, v, mask, causal, dropout_p, kw['dropout_seed'],
                    out, lse, do)}
        for kind in kinds:
            reasons = {}
            cands = []
            pruned = 0
            for G, bq, bk, ok, why in _enumerate(BH, seq, seq, head_dim,
                                                 dtype, kind):
                if ok:
                    cands.append((G, bq, bk))
                else:
                    pruned += 1
                    if G == 1:
                        reasons[f"{bq}x{bk}"] = why
            if _telem['on']:
                _metrics_mod().inc(
                    'mxnet_tpu_autotune_candidates_pruned_total', pruned)
            if not cands:
                raise MXNetError(
                    f"autotune: no legal ({kind}) candidate for BH={BH} "
                    f"T={seq} D={head_dim} {_dtype_name(dtype)}")
            registers = {'checked': bool(measure), 'pruned': {}}
            if measure:
                keep = []
                for c in cands:
                    why = _attr_pruned(kind, dtype, head_dim, c[1:]) \
                        if fa.kernel_variant(dtype, head_dim) == 'tc' \
                        else None
                    if why is None:
                        keep.append(c)
                    else:
                        registers['pruned'][f"{c[1]}x{c[2]}"] = why
                cands = keep
                if not cands:
                    raise MXNetError(f"autotune: every ({kind}) tile "
                                     f"spills: {registers['pruned']}")
            ranked = sorted(cands, key=lambda c: analytic_cost(
                BH, seq, seq, head_dim, dtype, kind, *c))
            rows = [{'blocks': list(c), 'analytic_ms': analytic_cost(
                BH, seq, seq, head_dim, dtype, kind, *c) * 1e3}
                for c in ranked[:max_timed]]
            if measure:
                timed = 0
                for row in rows:
                    c = tuple(row['blocks'])
                    with forced(KERNEL_FA, kind, c):
                        got = calls[kind]()
                        row['max_abs_err'] = _max_err(got, ref[kind])
                        if not _within(got, ref[kind], dtype):
                            row['error'] = (
                                f"disagrees with the plain version (max "
                                f"abs {row['max_abs_err']:.3e})")
                            continue
                        row['median_ms'] = _time_ms(calls[kind], reps)
                    timed += 1
                if _telem['on']:
                    _metrics_mod().inc(
                        'mxnet_tpu_autotune_candidates_timed_total', timed)
                good = [r for r in rows if 'median_ms' in r]
                if not good:
                    raise MXNetError(f"autotune: every timed ({kind}) "
                                     f"candidate failed: {rows}")
                winner = min(good, key=lambda r: r['median_ms'])
                win_blocks = tuple(winner['blocks'])
                info = {'source': 'measured',
                        'median_ms': winner['median_ms'], 'reps': reps}
            else:
                win_blocks = ranked[0]
                info = {'source': 'analytic',
                        'analytic_ms': rows[0]['analytic_ms']}
            sig = shape_sig(BH, seq, seq, head_dim, dtype, kind)
            report['db'] = record_winner(KERNEL_FA, sig, win_blocks, info,
                                         dir_=db_dir)
            report[kind] = {'winner': list(win_blocks),
                            'source': info['source'],
                            'candidates': len(cands), 'pruned': pruned,
                            'pruned_reasons': reasons,
                            'registers': registers, 'signature': sig,
                            'ranking': rows}
    sweep_s = time.perf_counter() - t_sweep
    if _telem['on']:
        _metrics_mod().inc('mxnet_tpu_autotune_sweep_seconds_total',
                           sweep_s)
    report['sweep_seconds'] = sweep_s
    return report
