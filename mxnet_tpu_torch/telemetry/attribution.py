"""Per-step performance attribution: measured spans -> buckets -> MFU
(counterpart of ``mxnet_tpu/telemetry/attribution.py``).

Takes the flight recorder's per-step span summaries (measured wall
time, host side) and the caller's count of one step's work (FLOPs,
bytes) and decomposes honest MFU into buckets:

- ``input``      — the consumer thread waiting on the input pipeline
                   (``io.*`` spans),
- ``h2d``        — host->device staging the consumer paid for
                   (``h2d.*`` spans: ``ShardedTrainStep``'s batch put),
- ``collective`` — host-measured gradient reduction (``comm.*`` spans),
- ``host_sync``  — blocking device->host reads (``sync.*`` spans),
- ``compute``    — the residual: wall time minus everything above,
                   i.e. the step program (one CUDA-graph replay of
                   forward, backward and optimizer on the card).

Bucket arithmetic uses span SELF time (child spans subtracted by
``telemetry.trace``), so nesting never double-counts, and ``compute``
is defined as the residual, so the bucket sum reconstructs the
measured wall time exactly — the report states what fraction of wall
was *measured* vs residual rather than pretending a sum.

The JAX package's ``xla_cost`` reads an XLA executable's
``cost_analysis()``; the port has no such executable, so ``report()``
takes ``flops_per_step`` from its caller (ROADMAP queue 1 item 4a).
Nothing here counts the hand-written kernels' work: torch's
FlopCounterMode cannot see a ctypes launch.
"""
from __future__ import annotations

__all__ = ['BUCKET_PREFIXES', 'bucket_of', 'subsystems', 'report',
           'format_table', 'format_memory_table', 'MEMORY_BUCKETS']

# memory_analysis() bucket order (ShardedTrainStep.memory_analysis /
# telemetry.memory): persistent residency buckets, then the residual
# activations-temp bucket that makes the sum reconstruct the measured
# peak — the memory analog of the wall-time table above
MEMORY_BUCKETS = ('params', 'optimizer_state', 'residuals', 'io_leases',
                  'activations_temp')

# span-name prefix -> bucket; everything else is residual 'compute'
BUCKET_PREFIXES = (
    ('io.', 'input'),
    ('h2d.', 'h2d'),
    ('comm.', 'collective'),
    ('sync.', 'host_sync'),
)

# spans recorded on overlapped threads (workers, background writers):
# they never spend the consumer's step time, so they are reported in
# the span table but excluded from the wall-time buckets
OVERLAPPED_SPANS = frozenset((
    'io.worker_fetch', 'h2d.pin', 'checkpoint.write',
))


def bucket_of(name):
    """Bucket for a span name, or None for residual/overlapped work."""
    if name in OVERLAPPED_SPANS:
        return None
    for prefix, bucket in BUCKET_PREFIXES:
        if name.startswith(prefix):
            return bucket
    return None


def subsystems(names):
    """Sorted set of subsystem prefixes ('io', 'h2d', 'step', ...) a
    collection of span/event names covers."""
    out = set()
    for n in names:
        if '.' in n:
            out.add(n.split('.', 1)[0])
    return sorted(out)


def report(steps, flops_per_step=None, bytes_per_step=None,
           peak_flops=None, collective_bytes=None, gather_layers=None,
           skip_first=1):
    """Attribution over flight-recorder step records.

    ``steps`` — ``flight.get().steps()`` (each record carries
    ``interval_ms`` + ``spans_ms``). The first ``skip_first`` records
    are dropped (they carry compile time and have no interval).
    ``flops_per_step``/``bytes_per_step`` — the caller's count of one
    step's work (the JAX package reads XLA's cost_analysis; the port has
    no compiled executable to ask, so its callers count, as bench.py's
    honest FLOP accounting does); with ``peak_flops`` they turn the
    measured wall into an honest-MFU figure from the same timebase as
    the buckets.
    """
    used = [r for r in steps[skip_first:] if r.get('interval_ms')]
    if not used:
        return {'error': 'no step records with intervals '
                         '(need >= %d traced steps)' % (skip_first + 2)}
    n = len(used)
    wall_ms = sum(r['interval_ms'] for r in used) / n

    buckets_ms = {'input': 0.0, 'h2d': 0.0, 'collective': 0.0,
                  'host_sync': 0.0}
    span_table = {}
    for r in used:
        for name, st in r['spans_ms'].items():
            b = bucket_of(name)
            if b is not None:
                # bill only the consumer thread's self time against the
                # step wall when the drain recorded it (overlapped
                # producer/writer threads never spend step time);
                # name-based OVERLAPPED_SPANS covers synthetic records
                buckets_ms[b] += st.get('consumer_self_ms',
                                        st['self_ms']) / n
            row = span_table.setdefault(
                name, {'count': 0.0, 'total_ms': 0.0, 'self_ms': 0.0})
            row['count'] += st['count'] / n     # per-step, like the ms
            row['total_ms'] += st['total_ms'] / n
            row['self_ms'] += st['self_ms'] / n

    measured = sum(buckets_ms.values())
    buckets_ms['compute'] = max(0.0, wall_ms - measured)
    total = sum(buckets_ms.values())
    out = {
        'steps_used': n,
        'wall_ms_per_step': round(wall_ms, 3),
        'buckets_ms': {k: round(v, 3) for k, v in buckets_ms.items()},
        'bucket_fractions': {k: round(v / total, 4) if total else 0.0
                             for k, v in buckets_ms.items()},
        # how much of wall was measured by spans vs residual: the
        # honesty indicator (compute is defined as the residual, so the
        # bucket sum reconstructs wall whenever measured <= wall)
        'measured_fraction': round(min(measured, wall_ms)
                                   / wall_ms, 4) if wall_ms else 0.0,
        'bucket_sum_over_wall': round(total / wall_ms, 4) if wall_ms
        else 0.0,
        'spans_ms_per_step': {
            k: {kk: (round(vv, 3) if isinstance(vv, float) else vv)
                for kk, vv in v.items()}
            for k, v in sorted(span_table.items())},
    }
    if flops_per_step:
        out['flops_per_step'] = float(flops_per_step)
        if peak_flops:
            out['mfu_percent'] = round(
                100.0 * flops_per_step / (wall_ms / 1e3 * peak_flops), 2)
            out['peak_flops_assumed'] = float(peak_flops)
    if bytes_per_step:
        out['bytes_per_step'] = float(bytes_per_step)
    if collective_bytes:
        # collectives inside a compiled program: the analytic ring-wire
        # plan (mxnet_tpu_comm_* accounting) is the only host-visible
        # number for them
        out['collective_bytes_per_step'] = {
            k: int(v) for k, v in collective_bytes.items()}
    if gather_layers:
        # ZeRO-3 per-layer all-gather plan [(layer, bytes/step, count)]:
        # the unit of gather-vs-compute overlap the latency-hiding
        # scheduler works with (matches the comm.all_gather trace
        # instants' `layer` arg)
        out['gather_bytes_per_layer'] = {
            str(layer): int(nbytes) for layer, nbytes, _c in gather_layers}
    losses = [r['loss'] for r in used if r.get('loss') is not None]
    if losses:
        out['loss_last'] = losses[-1]
    return out


def _mb(nbytes):
    return nbytes / 1e6


def format_memory_table(rep):
    """Monospace table of a ``ShardedTrainStep.memory_analysis()`` dict
    — the memory sibling of ``format_table``: per-device residency
    buckets whose sum reconstructs the measured peak (activations-temp
    is the explicit residual), the per-layer breakdown, and the
    backend's own program memory analysis (``xla``) where a report
    carries one."""
    if rep is None:
        return 'memory: no analysis (run at least one step first)'
    if 'error' in rep:
        return f"memory: {rep['error']}"
    lines = [
        f"peak {_mb(rep['peak_bytes_per_device']):.3f} MB/device "
        f"({rep['source']}; measured "
        f"{100 * rep['measured_fraction']:.1f}%, residual = "
        f"activations-temp) zero={rep['zero_stage']} dp={rep['dp']}"
        + (f" compression={rep['compression']}" if rep.get('compression')
           else ''),
        f"{'bucket':<18s}{'MB/device':>12s}{'fraction':>10s}",
    ]
    for b in MEMORY_BUCKETS:
        lines.append(f"{b:<18s}{_mb(rep['buckets_bytes'][b]):>12.3f}"
                     f"{100 * rep['bucket_fractions'][b]:>9.1f}%")
    if rep.get('pad_bytes'):
        lines.append(f"(zero3 flat pad slack "
                     f"{_mb(rep['pad_bytes']):.3f} MB/device)")
    xla = rep.get('xla')
    if xla:
        lines.append(
            "xla memory_analysis: "
            + ' '.join(f"{k.replace('_size_in_bytes', '')}="
                       f"{_mb(v):.3f}MB" for k, v in sorted(xla.items())))
    per_layer = rep.get('per_layer_bytes')
    if per_layer:
        lines.append('')
        lines.append(f"{'layer':<28s}{'persistent MB':>14s}"
                     f"{'gather MB/step':>15s}")
        gathers = rep.get('gather_bytes_per_layer') or {}
        rows = sorted(per_layer.items(), key=lambda kv: -kv[1])
        for layer, nb in rows:
            g = gathers.get(layer, 0)
            lines.append(f"{str(layer)[:27]:<28s}{_mb(nb):>14.3f}"
                         f"{_mb(g):>15.3f}")
    if rep.get('host_rss_bytes'):
        lines.append(f"host RSS {_mb(rep['host_rss_bytes']):.1f} MB")
    return '\n'.join(lines)


def format_table(rep):
    """Monospace table of a report() dict."""
    if 'error' in rep:
        return f"attribution: {rep['error']}"
    lines = [
        f"step wall {rep['wall_ms_per_step']:.3f} ms over "
        f"{rep['steps_used']} steps "
        f"(measured {100 * rep['measured_fraction']:.1f}%, "
        f"residual = compute)",
        f"{'bucket':<12s}{'ms/step':>10s}{'fraction':>10s}",
    ]
    order = ('input', 'h2d', 'collective', 'host_sync', 'compute')
    for b in order:
        lines.append(f"{b:<12s}{rep['buckets_ms'][b]:>10.3f}"
                     f"{100 * rep['bucket_fractions'][b]:>9.1f}%")
    if 'mfu_percent' in rep:
        lines.append(f"honest MFU {rep['mfu_percent']:.2f}% "
                     f"({rep['flops_per_step']:.3e} flops/step @ "
                     f"{rep['peak_flops_assumed']:.0f} peak FLOP/s)")
    lines.append('')
    lines.append(f"{'span':<28s}{'calls/step':>11s}{'total ms':>10s}"
                 f"{'self ms':>10s}")
    rows = sorted(rep['spans_ms_per_step'].items(),
                  key=lambda kv: -kv[1]['self_ms'])
    for name, row in rows:
        lines.append(f"{name[:27]:<28s}{row['count']:>11.1f}"
                     f"{row['total_ms']:>10.3f}{row['self_ms']:>10.3f}")
    return '\n'.join(lines)
