"""Environment-variable knobs read by the port (counterpart of
``mxnet_tpu/config.py``).

Only the knobs this package reads are declared, under the JAX package's
names and with its defaults, so one run configuration drives both
packages. ``get`` reads the process environment at every call.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple

from .base import MXNetError

__all__ = ['EnvVar', 'get', 'list_vars']


class EnvVar(NamedTuple):
    name: str
    type: Callable
    default: Any
    help: str


_REGISTRY: Dict[str, EnvVar] = {}


def _register(name, type_, default, help_):
    _REGISTRY[name] = EnvVar(name, type_, default, help_)


def _bool(s):
    return str(s).lower() not in ('0', 'false', 'off', '', 'no', 'n',
                                  'none', 'disabled')


def get(name, default=None):
    """Typed value of a declared variable (process env > declared
    default > ``default``)."""
    var = _REGISTRY.get(name)
    if var is None:
        raise MXNetError(f"unknown config variable {name!r}; see "
                         f"mxnet_tpu_torch.config.list_vars()")
    raw = os.environ.get(name)
    if raw is None:
        return var.default if default is None else default
    try:
        return var.type(raw)
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"{name}={raw!r} is not a valid {var.type.__name__}") from e


def list_vars():
    return sorted(_REGISTRY)


_register('MXTPU_PALLAS_LN', _bool, False,
          'Route the transformer residual+LN epilogue through the fused '
          'Triton kernel (ops/fused_layernorm.py) when the tensors are on '
          'CUDA. Default: the plain PyTorch path.')
_register('MXTPU_PALLAS_FFN', _bool, False,
          'Route the BERT FFN1 dense+bias+GELU through the fused CUDA '
          'kernel (ops/fused_ffn.py) when the tensors are on CUDA. '
          'Default: the plain PyTorch path.')
_register('MXTPU_SERVE_BATCH_DEADLINE_MS', float, 5.0,
          'Continuous-batcher formation deadline: a batch dispatches when '
          'its sequence bucket fills to the largest batch bucket or when '
          'its oldest request has waited this long.')
_register('MXTPU_SERVE_BUCKETS', str, '32,64,128',
          'Sequence-length buckets (comma-separated). Every request pads '
          'up to the smallest bucket that fits; longer requests are '
          'rejected.')
_register('MXTPU_SERVE_BATCH_BUCKETS', str, '1,2,4,8',
          'Batch-size buckets (comma-separated). A formed batch pads its '
          'row count up to the smallest bucket that fits.')
_register('MXTPU_SERVE_QUEUE_LIMIT', int, 256,
          'Admission bound on total queued requests; beyond it '
          'submissions shed with RequestShed.')
_register('MXTPU_SERVE_DRAIN_SECONDS', float, 10.0,
          'Graceful-drain budget: how long drain() waits for in-flight '
          'requests before giving up.')


def _remat_policy(s):
    """MXTPU_REMAT value -> policy name (the JAX package's parser): none
    (save what autograd saves), layer (save only the products without
    batch dims), aggressive (save nothing: recompute the forward in the
    backward)."""
    raw = str(s).strip().lower()
    if raw in ('', '0', 'off', 'false', 'no', 'n', 'none', 'disabled'):
        return 'none'
    if raw in ('layer', '1', 'on', 'true', 'yes', 'y'):
        return 'layer'
    if raw in ('aggressive', 'full', '2'):
        return 'aggressive'
    raise ValueError(f"MXTPU_REMAT={s!r}: expected none (default), "
                     f"layer, or aggressive")


_register('MXTPU_REMAT', _remat_policy, 'none',
          "Activation remat policy of ShardedTrainStep's forward: 'none' "
          "(default) keeps what autograd saves (under ZeRO-3 the gathered "
          'parameters are still regathered, never kept); \'layer\' runs '
          'each layer (each child of the sequential containers: BERT\'s '
          'encoder layers) under torch.utils.checkpoint with a selective '
          'policy that saves only the outputs of the products without '
          'batch dims (aten.mm/addmm, the Dense layers) and recomputes the '
          "rest (attention, LayerNorm, GELU, dropout); 'aggressive' saves "
          'nothing of a layer but its inputs. The dropout generators\' '
          'states are replayed, so a recompute draws the masks the '
          'forward drew.')
_register('MXTPU_FA_G', int, 0,
          'Explicit flash-attention FORWARD head-group size. Highest rung '
          'of the ops/autotune precedence ladder: env override > '
          'tuning-DB winner > built-in defaults. 0 (default) = unset. The '
          "port's kernels give each batch*head slice its own blocks, so "
          'any other value clamps to 1 (the clamp is recorded).')
_register('MXTPU_FA_BQ', int, 0,
          'Explicit flash-attention forward query tile (rows per block). '
          '0 = unset (tuning DB, then the default 64). A tile that is '
          'not built or not legal for the shape clamps to the default '
          '(recorded in autotune.decisions()).')
_register('MXTPU_FA_BK', int, 0,
          'Explicit flash-attention forward key tile (keys per loop '
          'step). 0 = unset (tuning DB, then the default 64).')
_register('MXTPU_FA_BWD_G', int, 0,
          'Explicit flash-attention BACKWARD head-group size (the dq and '
          'dk/dv kernels). 0 = unset; any other value clamps to 1.')
_register('MXTPU_FA_BWD_BQ', int, 0,
          'Explicit flash-attention backward query tile: the dq '
          "kernel's rows per block and the dk/dv kernel's rows per loop "
          'step. 0 = unset (tuning DB, then the default 64).')
_register('MXTPU_FA_BWD_BK', int, 0,
          "Explicit flash-attention backward key tile: the dq kernel's "
          "keys per loop step and the dk/dv kernel's keys per block. "
          '0 = unset (tuning DB, then the default 64).')
_register('MXTPU_AUTOTUNE_DIR', str, '',
          'Directory of the kernel-autotuner tuning DB '
          '(mxtpu_autotune.json, atomic JSON keyed by device kind + '
          'kernel + shape signature, the JAX package\'s format). When '
          'set, the flash-attention tile of each shape comes from the DB '
          'winner (env overrides still win); populate it with '
          'ops.autotune.sweep_flash_attention(). Empty (default): DB '
          'lookups off, the default tile applies.')
_register('MXTPU_AUTOTUNE_REPS', int, 5,
          'Measured-sweep repetitions per candidate: each surviving tile '
          'is built and warmed outside the timed window, then timed this '
          'many times with CUDA events; the median decides the winner.')
_register('MXNET_SUBGRAPH_BACKEND', str, '',
          'Default subgraph backend that hybridize() applies when the call '
          'names none (see mxnet_tpu_torch.subgraph).')
_register('MXNET_HOME', str, os.path.join(os.path.expanduser('~'), '.mxnet'),
          'Data directory: the model zoo looks for pretrained weights in '
          'its models/ folder.')
_register('MXNET_GLUON_REPO', str, '',
          'A local directory holding gluon/models/<name>-<hash>.params, '
          'where the model zoo also looks for pretrained weights (the '
          'port downloads nothing).')
_register('MXNET_TPU_TELEMETRY', _bool, False,
          'Enable the runtime telemetry registry (telemetry.metrics): '
          'compile, serving, step and trace metrics with Prometheus, JSON '
          'and chrome-trace export. Off: instrumented paths take a single '
          'flag-check fast path.')
_register('MXTPU_TRACE', _bool, False,
          'Enable span tracing (telemetry.trace): nested chrome-trace B/E '
          'spans over the step and dispatch lifecycle in per-thread ring '
          'buffers, plus the crash-time flight recorder. Off: every span '
          'site takes a single flag-check fast path and allocates nothing.')
_register('MXTPU_TRACE_RING', int, 16384,
          'Span-trace ring capacity in events PER THREAD. A full ring '
          'overwrites its oldest events (dropped whole spans are counted '
          'in mxnet_tpu_trace_dropped_spans_total).')
_register('MXTPU_FLIGHT_STEPS', int, 64,
          'Flight recorder depth: per-step span summaries (+ loss and '
          'guard flags) retained for the crash-time dump.')
_register('MXTPU_FLIGHT_DIR', str, '',
          'Directory for flight-recorder, OOM and compile-ledger dumps. '
          'Empty (default): the system temp directory. Ignored for the '
          'flight dump when MXTPU_FLIGHT_PATH names an explicit file.')
_register('MXTPU_FLIGHT_PATH', str, '',
          'Explicit path of the flight-recorder post-mortem JSON. Empty '
          '(default): MXTPU_FLIGHT_DIR/mxtpu_flight-<pid>.json.')
_register('MXNET_TPU_RECOMPILE_WARN_THRESHOLD', int, 3,
          'Telemetry recompile detector: warn (once per churn episode) '
          'when one compile site, e.g. a hybridized block, compiles more '
          'than this many times.')
_register('MXTPU_MEMORY', _bool, False,
          'Enable memory watermark sampling (telemetry.memory): per-step '
          'live/peak device-memory samples from torch.cuda.memory_stats '
          'on the card, else the sum over the registered pools, plus '
          'host RSS, into a bounded ring and mxnet_tpu_memory_* gauges. '
          'Off: the per-step hook is one dict check and allocates '
          'nothing. The OOM forensics guard is always armed.')
_register('MXTPU_MEMORY_RING', int, 256,
          'Watermark ring depth: memory samples retained for the OOM '
          'post-mortem.')
_register('MXTPU_MEMORY_EVERY', int, 1,
          'Memory sampling cadence: one watermark sample every this many '
          'steps.')
_register('MXTPU_MEMORY_LEAK_STEPS', int, 8,
          'Leak detector: this many CONSECUTIVE samples of monotonic '
          'live-bytes growth latch one memory.leak_suspected flight note.')
_register('MXTPU_MEMORY_LEAK_BYTES', int, 1 << 20,
          'Leak detector: minimum total live-bytes growth over the '
          'MXTPU_MEMORY_LEAK_STEPS window before the latch fires.')
_register('MXTPU_COMPILE_LEDGER', str, '',
          'Arm the compile ledger (telemetry.compile): every CUDA-graph '
          'capture, kernel build (nvcc, Triton) and NVRTC compile appends '
          'a structured signature + seconds entry to a bounded in-memory '
          'ring and, when this names a path ("1"/"on": '
          'MXTPU_FLIGHT_DIR/mxtpu_compile_ledger-<pid>.jsonl), an on-disk '
          'JSONL ledger. Empty (default): disarmed.')
_register('MXTPU_COMPILE_CACHE_DIR', str, '',
          'Directory of the built kernel libraries (default: '
          'build/mxnet_tpu_torch at the root of the checkout); '
          'telemetry.compile.persistent_cache_stats counts its hits, '
          'misses and bytes.')
_register('MXTPU_SERVE_WATCHDOG_SECONDS', float, 0.0,
          'Arm a StepWatchdog over the batcher: a dispatch that '
          'produces no completed batch for this long dumps a stall '
          'report (classified COMPILING vs EXECUTING via the compile '
          'window) and notes serving.stuck. 0 = off.')
_register('MXTPU_FAULT', str, '',
          'Arm deterministic fault injection: comma-separated '
          'site:kind[:prob[:seed[:first-last]]] specs (kinds: raise, '
          'hang, corrupt, nan). See mxnet_tpu_torch.resilience.faults.'
          'sites() for the registered sites. Read once at import; re-arm '
          'with resilience.faults.arm_from_env().')
_register('MXTPU_FAULT_HANG_SECONDS', float, 300.0,
          'How long an armed "hang" fault sleeps at its site (long '
          'enough to trip the step watchdog, short enough for tests).')
_register('MXTPU_GUARD_MAX_BAD_STEPS', int, 3,
          'NonFiniteGuard policy ladder: after this many CONSECUTIVE '
          'non-finite steps (each already skipped on the device), '
          'auto-restore the newest committed checkpoint.')
_register('MXTPU_WATCHDOG_SECONDS', float, 300.0,
          'StepWatchdog default deadline: with no training-step '
          'heartbeat for this long, dump all-thread stacks + a telemetry '
          'snapshot to the log (once per stall).')
_register('MXTPU_CHECKPOINT_WRITE_RETRIES', int, 2,
          'Bounded retries (with backoff) of a checkpoint payload write '
          'after a transient filesystem error before the failure '
          'surfaces on the training thread.')
_register('MXNET_TPU_COORDINATOR', str, '',
          'host:port of rank 0 for a multi-process world '
          '(parallel.dist.init: a torch.distributed TCPStore there), or '
          'file:///path for a FileStore rendezvous. Empty: fall back to '
          'the DMLC_PS_ROOT_URI/_PORT drop-in names, then localhost:12345 '
          'with a warning.')
_register('MXNET_TPU_NUM_PROCS', int, 0,
          'Total process count of a multi-process world. 0 (default): '
          'fall back to DMLC_NUM_WORKER, then one process.')
_register('MXNET_TPU_PROC_ID', int, -1,
          "This process's rank. -1 (default): fall back to DMLC_WORKER_ID, "
          'then 0. The observability endpoint serves on MXTPU_METRICS_PORT '
          '+ rank.')
_register('MXTPU_DIST_INIT_RETRIES', int, 3,
          'Bounded retries (exponential backoff) of the connection to rank '
          "0's store in dist.init(): workers that start before rank 0 is "
          'listening see a transient connection error, not a fatal one.')
_register('MXTPU_HIERARCHICAL_DP', int, 0,
          'Hierarchical dp decomposition (dist.dp_host_split): 0 (default) '
          'detects hosts from the world, 1 forces the flat topology. A '
          'forced split (N >= 2) raises: hierarchy is ROADMAP queue 1 '
          'item 8.')


def _zero_stage(s):
    """MXTPU_ZERO value -> ZeRO stage int: 0/off/false -> 0, 1/on/true
    -> 1, 3 -> 3 (the JAX package's parser)."""
    raw = str(s).strip().lower()
    if raw in ('3',):
        return 3
    if raw in ('1', 'true', 'on', 'yes', 'y', 'enabled'):
        return 1
    if raw in ('0', 'false', 'off', '', 'no', 'n', 'none', 'disabled'):
        return 0
    raise ValueError(f"MXTPU_ZERO={s!r}: expected 0 (off), 1 (sharded "
                     f"optimizer state) or 3 (sharded params + grads + "
                     f"state / FSDP)")


_register('MXTPU_ZERO', _zero_stage, 1,
          'ZeRO stage of the data-parallel update. 1 (default whenever '
          'the dp axis spans more than one rank): gradients '
          'reduce-scatter over dp, each rank runs the optimizer on its '
          '1/dp slice of the f32 masters and moments, and the updated '
          'parameters all-gather back. 0 keeps the replicated update '
          '(one all-reduce of the gradients). 3 (ShardedTrainStep) also '
          "shards the parameters between steps: each layer group is "
          'all-gathered before its first use and regathered in the '
          "backward; the Trainer's stage 3 raises (ROADMAP queue 1 item "
          '7).')
_register('MXTPU_HEARTBEAT_SECONDS', float, 1.0,
          'Membership heartbeat period (parallel.dist, not ported: ROADMAP '
          'queue 1 item 10). The fleet monitor derives its default stale '
          'threshold from it (3x).')
_register('MXTPU_METRICS_PORT', int, 0,
          'Base TCP port of the per-process observability endpoint '
          '(telemetry.server): rank r serves GET /metrics (Prometheus '
          'exposition), /healthz (health document) and /flight '
          '(on-demand flight-recorder dump) on base + r. 0 (default): no '
          'server. Binds localhost-only unless MXTPU_METRICS_BIND says '
          'otherwise, and answers with bounded handler threads.')
_register('MXTPU_METRICS_BIND', str, '127.0.0.1',
          'Bind address of the observability endpoint and the predict '
          'server. The default stays loopback-only; set 0.0.0.0 '
          'deliberately when a scraper or router lives off-host.')
_register('MXTPU_FLEET_WINDOW', int, 32,
          'Rolling window (snapshots per rank) the fleet anomaly '
          'detectors baseline over: step-time regression and loss-spike '
          'statistics are computed against this many recent snapshots.')
_register('MXTPU_FLEET_REGRESSION_FACTOR', float, 2.0,
          "Fleet detector: a rank's step wall time above this multiple "
          'of its own rolling baseline is flagged as a step-time '
          'regression (flight note fleet.step_regression).')
_register('MXTPU_FLEET_STRAGGLER_FACTOR', float, 1.5,
          "Fleet detector: a rank's step wall time above this multiple "
          'of the fleet median is flagged as a straggler (flight note '
          'fleet.straggler).')
_register('MXTPU_FLEET_STALE_SECONDS', float, 0.0,
          'Fleet detector: a rank whose newest telemetry snapshot is '
          'older than this is flagged as stale/straggling even if its '
          'last reported step time was healthy. 0 (default): 3x the '
          'heartbeat period.')
_register('MXTPU_FLEET_LOSS_SPIKE_SIGMA', float, 6.0,
          'Fleet detector: a reported loss above the rolling mean plus '
          'this many rolling standard deviations (window '
          'MXTPU_FLEET_WINDOW, minimum 8 samples) is flagged as a loss '
          'spike (flight note fleet.loss_spike).')
_register('MXTPU_FLEET_IMBALANCE_FACTOR', float, 1.5,
          'Fleet detector: max/min ratio of per-rank comm bytes per '
          'step above this is flagged as a collective imbalance '
          '(flight note fleet.comm_imbalance).')
_register('MXTPU_FLEET_MEMORY_IMBALANCE_FACTOR', float, 1.5,
          'Fleet detector: max/min ratio of per-rank live device memory '
          'above this is flagged as a memory imbalance on the fattest '
          'rank (flight note fleet.memory_imbalance).')
_register('MXTPU_SERVE_PORT', int, 0,
          'Port of the predict server (serving.PredictServer) when its '
          'caller names none. 0 (default): a free port, read back from '
          'the server.')
_register('MXTPU_SERVE_QUANTIZE', str, '',
          "Weight quantization for the predict path, read by "
          "serving.quantize_weights when its caller names no mode: '' "
          "(default, full precision), 'bf16' (cast parameters to "
          "bfloat16: 2x residency), or 'int8' (snap float weights to the "
          "block-scaled int8 codec's value grid, stored in the "
          "parameters' own dtype).")
_register('MXTPU_SERVE_MEMORY_LIMIT_MB', float, 0.0,
          'Admission control from memory observability: when live '
          'device bytes (telemetry.memory.health_fields) exceed this, '
          'predicts shed with 503 until pressure clears. 0 = off.')
_register('MXTPU_SERVE_EJECT_FAILURES', int, 2,
          'Router ejection threshold: this many CONSECUTIVE failed '
          'predicts (connect refused, 5xx, shed) ejects a replica from '
          'rotation for MXTPU_SERVE_READMIT_SECONDS.')
_register('MXTPU_SERVE_READMIT_SECONDS', float, 5.0,
          'How long an ejected replica sits out before the router '
          'probes it back in (the next routed predict is the probe).')
_register('MXNET_TPU_IO_TRANSPORT', str, 'u8',
          "ImageRecordIter host->device transport: 'u8' moves raw uint8 "
          'NHWC from the decode pipeline\'s leased buffer and normalizes '
          "on the device (4x fewer host bytes); 'f32' normalizes to "
          'float32 on the host.')
_register('MXNET_TPU_IO_DECODE_CACHE_MB', float, 256.0,
          'Byte budget (MB) of the cross-epoch decode cache: decoded + '
          'short-side-resized images reused across epochs (crop/mirror/'
          'normalize stay per-epoch). 0 disables the cache.')
_register('MXNET_TPU_IO_CORRUPT_POLICY', str, 'error',
          "What ImageRecordIter does with a corrupt/truncated record "
          "mid-epoch: 'error' raises DataError naming the record index "
          "and file offset; 'skip' substitutes the next good record and "
          "counts mxnet_tpu_io_corrupt_records_total.")
_register('MXTPU_DATALOADER_WORKER_RETRIES', int, 2,
          'Bounded re-submissions of a gluon DataLoader batch fetch '
          'after a worker crash before a clear error is raised.')
_register('MXNET_TPU_NO_NATIVE_BUILD', _bool, False,
          'Never compile the native IO library on demand: a missing '
          'library means the pure-Python (PIL) decode path.')

# the RowSparse fast path of the compiled step (parallel/step.py) and the
# knobs it reads, with the JAX package's names and defaults
_register('MXTPU_SPARSE', _bool, True,
          'Enable the RowSparse fast path in the compiled train step: '
          "parameters declared grad_stype='row_sparse' (Embedding("
          'sparse_grad=True)) backpropagate (unique row ids, row-block '
          'values) instead of a dense table-shaped gradient, and the '
          'optimizer updates only the gathered live rows inside the one '
          'captured step. Off: such tables take the dense path '
          '(identical trajectories under exact mode, see '
          'MXTPU_SPARSE_EXACT).')
_register('MXTPU_SPARSE_ROWS', int, 0,
          'Per-table live-row budget ceiling for the sparse fast path. '
          "A table whose worst-case unique-row budget (min(batch ids, "
          'vocab), discovered when the step is built) exceeds this takes '
          'the dense path. 0 (default) = no ceiling.')
_register('MXTPU_SPARSE_EXACT', _bool, False,
          'Force exact (non-lazy) sparse semantics: the deduped row '
          'block densifies into a table-shaped gradient and the dense '
          'update runs, bit-identical to the dense path (ref '
          'lazy_update=False). Default off = lazy semantics: moments of '
          'absent rows stay frozen and weight decay applies only to '
          'live rows.')
_register('MXTPU_SPARSE_TABLE_AXIS', str, '',
          "Mesh axis to shard row_sparse embedding tables' rows over "
          "(e.g. 'tp'). Needs a model axis across cards, which the port "
          'does not have (ROADMAP queue 1 item 6a): a step with sparse '
          'tables raises when it is set. Empty (default) = tables '
          'replicate like other params.')
_register('MXNET_TPU_JAX_TRACE_DIR', str, '',
          'Directory for the device trace that profiler.start() takes '
          '(torch.profiler, CPU and CUDA activities; its chrome trace is '
          'written there at stop()). The name is the JAX package\'s, so '
          'one run configuration drives both.')
_register('MXNET_TPU_MNIST_DIR', str, '',
          'Directory holding the MNIST idx files for '
          'test_utils.get_mnist(). Empty: the JAX package\'s '
          'deterministic synthetic set.')
