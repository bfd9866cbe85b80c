"""Replica predict server: ``POST /predict`` on the telemetry endpoint
(counterpart of ``mxnet_tpu/serving/server.py``).

One serving replica = one ``InferenceEngine`` fronted by the same
bounded stdlib HTTP server the telemetry endpoint uses — ``/metrics``,
``/healthz`` and ``/flight`` keep working unchanged (a router readmits
on the SAME /healthz document a fleet operator reads), and three POST
routes are added:

- ``POST /predict``  {"inputs": [...]} — one sequence or a list of
  sequences; every sequence rides the continuous batcher. Admission
  control sheds with 503 **before** touching the device: replica
  draining, engine queue full, or live device memory above
  ``MXTPU_SERVE_MEMORY_LIMIT_MB`` (the allocator's numbers, the same
  ones /healthz reports). An OOM inside the dispatch sheds that batch
  with 503 too — the replica never dies of a burst. The outputs are
  written as float64 JSON lists, as the JAX server writes them.
- ``POST /reload``   {"path": ...} or {"ns": ..., "step": ...} — load
  new weights into the served block by structured name. ``(ns, step)``
  resolves ``<replica_root>/<ns>/step_<step>/weights.params`` after the
  step directory's manifest validates (409 when it does not). The
  values are copied INTO the parameters' tensors
  (``Parameter.set_data``), so every CUDA graph the engine captured —
  which reads the parameters' storage by address — serves the new
  weights on its next replay, with no recapture.
- ``POST /drain``    — graceful exit: stop admitting, flush in-flight
  requests, then close the listener. SIGTERM does the same via
  ``install_sigterm``. While draining, ``/healthz`` says so (503).

``quantize_weights(block, 'bf16')`` casts the parameters (true 2x
residency; the cast drops the block's captured graphs, so warm the
engine again after it); ``'int8'`` snaps each floating parameter to the
codec's block-scaled int8 value grid in place (``parallel.compression``;
the values an int8-weights deployment would serve, stored in the
parameter's own dtype, so a bf16 parameter is rounded to bf16 after the
snap, as the JAX package does).

The JAX server also leaves the membership on drain and takes its
``replica_root`` from the replica transport; neither is ported (ROADMAP
queue 1 item 10): a ``membership`` raises.
"""
from __future__ import annotations

import json
import os
import threading
import time as _time

import numpy as onp
import torch

from .. import config as _config
from ..base import MXNetError, telem_flags as _telem
from ..telemetry import flight as _flight, memory as _memory, \
    metrics as _metrics, trace as _trace
from ..telemetry.server import TelemetryServer
from .batcher import ServeError

__all__ = ['PredictServer', 'quantize_weights', 'memory_admission']


def quantize_weights(block, mode=None):
    """Quantize a block's weights for serving; ``mode=None`` reads
    ``MXTPU_SERVE_QUANTIZE``. Returns the block."""
    if mode is None:
        mode = _config.get('MXTPU_SERVE_QUANTIZE')
    if not mode or mode == 'none':
        return block
    if mode in ('bf16', 'bfloat16'):
        block.cast('bfloat16')
        return block
    if mode == 'int8':
        from ..parallel import compression as _compression
        with torch.no_grad():
            for p in block.collect_params().values():
                d = p.tensor.detach()
                if d.is_floating_point():
                    p.set_data(_compression.encode_decode(d, 'int8'))
        return block
    raise MXNetError(
        f"unknown MXTPU_SERVE_QUANTIZE mode {mode!r} "
        f"(use '', 'bf16' or 'int8')")


def memory_admission(limit_mb=None):
    """Admission predicate over the memory observability: returns a shed
    reason when live device bytes exceed the limit, else None.
    ``limit_mb=None`` reads ``MXTPU_SERVE_MEMORY_LIMIT_MB``; 0 = off."""
    if limit_mb is None:
        limit_mb = float(_config.get('MXTPU_SERVE_MEMORY_LIMIT_MB'))
    if not limit_mb or limit_mb <= 0:
        return None

    def _admit():
        try:
            live = _memory.health_fields().get('live_bytes') or 0
        except Exception:
            return None
        if live > limit_mb * (1 << 20):
            return f'memory_pressure ({live >> 20}MiB > {limit_mb:g}MiB)'
        return None
    return _admit


class PredictServer(TelemetryServer):
    """One replica's front door. ``engine`` is an ``InferenceEngine``;
    ``block`` (optional) enables /reload; ``replica_root`` (optional)
    is the directory /reload resolves ``(ns, step)`` under. ``port=None``
    reads ``MXTPU_SERVE_PORT`` (0: a free port, read back as
    ``.port``)."""

    max_body_bytes = 4 << 20

    def __init__(self, engine, port=None, bind=None, membership=None,
                 block=None, replica_root=None, max_handlers=8,
                 start=True):
        self.engine = engine
        self.block = block
        self.replica_root = replica_root
        self.draining = threading.Event()
        self.reloaded_step = None
        if port is None:
            port = _config.get('MXTPU_SERVE_PORT')
        super().__init__(port=port, bind=bind, membership=membership,
                         max_handlers=max_handlers, start=start)

    # -- routes ------------------------------------------------------------

    def _route(self, path, method='GET', body=b''):
        if method == 'POST':
            if body is None:
                return ('413 Payload Too Large', 'application/json',
                        b'{"error": "body too large"}')
            if path == '/predict':
                return self._predict(body)
            if path == '/reload':
                return self._reload(body)
            if path == '/drain':
                return self._drain_async()
            return ('404 Not Found', 'text/plain',
                    b'POST endpoints: /predict /reload /drain\n')
        return super()._route(path, method, body)

    def health(self):
        doc = super().health()
        if self.draining.is_set():
            doc['status'] = 'draining'
        return doc

    @staticmethod
    def _json(status, doc):
        return (status, 'application/json',
                json.dumps(doc, default=str).encode())

    @staticmethod
    def encode_outputs(outs, single):
        """The response body's ``outputs``: float64 lists, one per
        sequence (the bare list for a single sequence)."""
        payload = [onp.asarray(o, onp.float64).tolist() for o in outs]
        return payload[0] if single else payload

    def _predict(self, body):
        t0 = _time.monotonic()
        if self.draining.is_set():
            return self._json('503 Service Unavailable',
                              {'error': 'draining'})
        try:
            doc = json.loads(body.decode('utf-8'))
            inputs = doc['inputs']
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            return self._json('400 Bad Request',
                              {'error': f'bad request body: {e!r}'})
        single = bool(inputs) and not isinstance(inputs[0], (list, tuple))
        seqs = [inputs] if single else inputs
        try:
            with _trace.span('serving.predict', n=len(seqs)):
                handles = [self.engine.submit_async(s) for s in seqs]
                outs = [self.engine.result(h) for h in handles]
        except ServeError as e:
            status = {503: '503 Service Unavailable',
                      400: '400 Bad Request'}.get(e.status,
                                                  '500 Internal Server Error')
            return self._json(status, {'error': str(e)})
        except Exception as e:                        # noqa: BLE001
            return self._json('500 Internal Server Error',
                              {'error': repr(e)})
        return self._json('200 OK', {
            'outputs': self.encode_outputs(outs, single),
            'latency_ms': round((_time.monotonic() - t0) * 1e3, 3)})

    def _reload(self, body):
        if self.block is None:
            return self._json('400 Bad Request',
                              {'error': 'no block attached'})
        try:
            doc = json.loads(body.decode('utf-8')) if body else {}
        except ValueError as e:
            return self._json('400 Bad Request', {'error': repr(e)})
        path = doc.get('path')
        step = doc.get('step')
        if path is None:
            if self.replica_root is None or step is None:
                return self._json('400 Bad Request', {
                    'error': "need 'path' or ('ns' + 'step' with a "
                             "replica_root)"})
            from ..checkpoint import manifest as mf
            d = os.path.join(self.replica_root,
                             str(doc.get('ns', 'serving')),
                             mf.step_dir_name(int(step)))
            try:
                mf.validate_step_dir(d)
            except Exception as e:
                return self._json('409 Conflict',
                                  {'error': f'checkpoint invalid: {e}'})
            path = os.path.join(d, 'weights.params')
        try:
            # set_data copies into the parameters' tensors: the captured
            # graphs read them by address and serve the new values
            self.block.load_parameters(path)
        except Exception as e:                        # noqa: BLE001
            return self._json('500 Internal Server Error',
                              {'error': repr(e)})
        self.reloaded_step = step
        _flight.note('serving.reload', step=step, path=path)
        return self._json('200 OK', {'reloaded': True, 'step': step})

    # -- drain -------------------------------------------------------------

    def _drain_async(self):
        threading.Thread(target=self.drain, daemon=True,
                         name='mxtt-serve-drain').start()
        return self._json('200 OK', {'draining': True})

    def drain(self):
        """Graceful exit: finish in-flight work, close the listener.
        Idempotent."""
        if self.draining.is_set():
            return
        self.draining.set()
        flushed = self.engine.drain()
        _flight.note('serving.drain', flushed=flushed, rank=None)
        if _telem['on']:
            _metrics.counter(
                'mxnet_tpu_serving_drained_replicas_total').inc(1)
        self.stop()

    def install_sigterm(self):
        """SIGTERM -> graceful drain (the preemption path). Main thread
        only (signal module restriction)."""
        import signal as _signal

        def _term(_sig, _frm):
            threading.Thread(target=self.drain, daemon=True,
                             name='mxtt-serve-drain').start()
        _signal.signal(_signal.SIGTERM, _term)
