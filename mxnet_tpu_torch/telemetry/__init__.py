"""Telemetry (counterpart of ``mxnet_tpu/telemetry``): the metrics
registry, span tracing, the flight recorder, memory watermarks with OOM
forensics, and the compile ledger. Pure Python over the standard library
(``memory`` and ``compile`` ask ``torch.cuda`` for the allocator's and
the card's numbers).

- ``telemetry.metrics`` — the process-global counter/gauge/histogram
  registry, Prometheus/JSON/chrome-'C' exports and the recompile
  detector; its API is re-exported here (``telemetry.inc(...)``,
  ``telemetry.report()``; ``MXNET_TPU_TELEMETRY=1`` arms it).
- ``telemetry.trace`` — nested ``span()`` scopes in per-thread rings,
  chrome-trace B/E export (``MXTPU_TRACE=1``).
- ``telemetry.flight`` — the crash-time flight recorder.
- ``telemetry.memory`` — watermarks (``MXTPU_MEMORY=1``), the leak
  detector and the always-armed OOM guard.
- ``telemetry.compile`` — the compile ledger over CUDA-graph captures,
  kernel builds and NVRTC compiles (``MXTPU_COMPILE_LEDGER``).
- ``telemetry.attribution`` — the flight recorder's step records into
  the input/h2d/collective/host-sync/compute breakdown and honest MFU.
- ``telemetry.fleet`` — per-rank snapshots merged into a fleet view with
  skew and the streaming straggler/regression/loss-spike/imbalance
  detectors (fed by ``ingest``; the membership heartbeat waits for
  ROADMAP queue 1 item 10).
- ``telemetry.server`` — the per-process /metrics + /healthz + /flight
  HTTP endpoint (``MXTPU_METRICS_PORT``, off by default).
"""
from .metrics import *  # noqa: F401,F403  (the registry API)
from .metrics import (  # noqa: F401  (non-__all__ names used by tests)
    DEFAULT_BUCKETS, Metric, _label_key, _metrics, _snapshot,
)
from .metrics import __all__ as _metrics_all
from . import trace          # noqa: F401
from . import memory         # noqa: F401
from . import compile        # noqa: F401  (shadows the builtin only here)
from . import flight         # noqa: F401
from . import attribution    # noqa: F401
from . import fleet          # noqa: F401
from . import server         # noqa: F401

__all__ = list(_metrics_all) + ['trace', 'memory', 'compile', 'flight',
                                'attribution', 'fleet', 'server']
