"""Per-process observability endpoint: /metrics, /healthz, /flight
(counterpart of ``mxnet_tpu/telemetry/server.py``).

A fleet is only operable if every replica answers "how are you" over
plain HTTP, and a Prometheus scraper should not have to link against the
framework. This is a tiny stdlib TCP server: it never touches the card
(a wedged device must not make the *diagnosis* port unreachable too),
binds loopback-only by default, and answers with a BOUNDED pool of
handler threads — a scrape storm degrades to refused connections, never
to unbounded thread growth. Each request is read within one wall
deadline, so a client that trickles bytes cannot hold a slot.

Endpoints (GET only):

- ``/metrics``  — the metrics registry in Prometheus text exposition
  format (exactly ``telemetry.prometheus()``; empty until
  ``MXNET_TPU_TELEMETRY=1`` arms the registry).
- ``/healthz``  — JSON health document: last completed step, samples/s,
  the memory and compile documents, the last committed step and the
  stall verdict, and the process-global fleet view when one exists.
- ``/flight``   — the flight recorder's post-mortem document on
  demand (the same JSON a crash dump writes; loss reads skipped so a
  wedged device can never wedge the endpoint).

Armed by ``MXTPU_METRICS_PORT`` (0 = off; rank r serves on base + r), or
call ``start()`` directly.

/healthz reports ``last_committed_step``, the newest step any live
``checkpoint.CheckpointManager`` of this process committed (None without
one). The JAX endpoint also reports the membership view of
``parallel.dist``, which is not ported (ROADMAP queue 1 item 10), so
``verdict`` is the single-process branch of the JAX
``resilience.elastic.stall_verdict`` (an open compile window classifies a
stall as ``compiling``, else None). Passing a ``membership`` raises.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time as _time

from ..base import MXNetError

__all__ = ['TelemetryServer', 'start', 'stop', 'get', 'maybe_start',
           'stall_verdict']

_log = logging.getLogger('mxnet_tpu_torch.telemetry')

_MAX_REQUEST_BYTES = 8192


def _refuse_membership(membership):
    if membership is not None:
        raise MXNetError(
            "telemetry endpoint with a membership: the membership layer "
            "(parallel.dist) is not ported (ROADMAP queue 1 item 10)")


def stall_verdict(membership=None):
    """The JAX package's ``stall_verdict`` for a lone process (no
    membership, no replica fetch in flight): ``{'verdict': 'compiling',
    ...}`` while a compile window is open, else None."""
    _refuse_membership(membership)
    from . import compile as _compile
    fl = _compile.in_flight()
    if fl is None:
        return None
    c = dict(fl)
    c['rank'] = None
    return {'verdict': 'compiling', 'peer_ages': {}, 'lost': [],
            'deadline_seconds': 0.0, 'compiling': c}


class TelemetryServer:
    """One process's observability endpoint. ``port=0`` picks a free
    port (tests); ``max_handlers`` bounds concurrent handler threads —
    excess connections are closed immediately (a scraper retries; the
    process never grows a thread per stuck client)."""

    def __init__(self, port=0, bind=None, membership=None,
                 max_handlers=4, start=True):
        from .. import config as _config
        _refuse_membership(membership)
        self.bind = bind if bind is not None \
            else _config.get('MXTPU_METRICS_BIND')
        self.max_handlers = int(max_handlers)
        self._slots = threading.Semaphore(self.max_handlers)
        self._stop = threading.Event()
        self._server = None
        self._thread = None
        self.port = int(port)
        # up to max_handlers handler threads bump the request counter
        # concurrently — a bare += would silently lose counts
        self._lock = threading.Lock()
        self.requests = 0
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._server is not None:
            return self
        self._stop.clear()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.bind, self.port))
        self.port = srv.getsockname()[1]
        srv.listen(16)
        srv.settimeout(0.2)
        self._server = srv
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name='mxtt-telemetry-http')
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        # retire the socket under the lock: an accept loop that outlived
        # its join timeout reads the handle through the same lock
        with self._lock:
            srv, self._server = self._server, None
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- accept loop -------------------------------------------------------

    def _serve(self):
        with self._lock:
            srv = self._server
        while srv is not None and not self._stop.is_set():
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if not self._slots.acquire(blocking=False):
                # at capacity: shed load instead of queueing threads
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            try:
                t = threading.Thread(target=self._handle_conn,
                                     args=(conn,), daemon=True,
                                     name='mxtt-telemetry-req')
                t.start()
            except Exception:
                # thread exhaustion: give the slot BACK (the release
                # lives in _handle_conn, which never ran)
                self._slots.release()
                try:
                    conn.close()
                except OSError:
                    pass

    # bodies a subclass accepts on POST (0 = GET-only, the telemetry
    # default: a scraper has no business sending us bytes)
    max_body_bytes = 0

    def _handle_conn(self, conn):
        try:
            conn.settimeout(5.0)
            with conn:
                req = self._read_request(conn)
                if req is None:
                    return
                method, path, body = req
                with self._lock:
                    self.requests += 1
                status, ctype, resp = self._route(path, method, body)
                head = (f'HTTP/1.0 {status}\r\n'
                        f'Content-Type: {ctype}\r\n'
                        f'Content-Length: {len(resp)}\r\n'
                        f'Connection: close\r\n\r\n')
                conn.sendall(head.encode() + resp)
        except (OSError, ValueError):
            pass
        finally:
            self._slots.release()

    def _read_request(self, conn, deadline_seconds=5.0):
        """(method, path, body) of a GET/POST request, or None for
        anything malformed. Reads at most _MAX_REQUEST_BYTES of header
        plus ``max_body_bytes`` of declared body within ONE overall
        wall deadline — a trickling client (one byte per recv, each
        resetting the socket timeout) cannot hold a handler slot past
        the deadline. A body larger than the bound returns body=None
        (413 upstream) instead of buffering unboundedly."""
        deadline = _time.monotonic() + deadline_seconds
        data = b''
        while b'\r\n\r\n' not in data and len(data) < _MAX_REQUEST_BYTES:
            if _time.monotonic() > deadline:
                return None
            b = conn.recv(4096)
            if not b:
                break
            data += b
        head, _, rest = data.partition(b'\r\n\r\n')
        lines = head.split(b'\r\n')
        parts = lines[0].decode('latin-1', 'replace').split()
        if len(parts) < 2 or parts[0] not in ('GET', 'POST'):
            return None
        method, path = parts[0], parts[1].split('?', 1)[0]
        if method == 'GET':
            return method, path, b''
        length = 0
        for ln in lines[1:]:
            k, _, v = ln.decode('latin-1', 'replace').partition(':')
            if k.strip().lower() == 'content-length':
                try:
                    length = int(v.strip())
                except ValueError:
                    return None
        if length > self.max_body_bytes:
            return method, path, None
        body = rest[:length]
        while len(body) < length:
            if _time.monotonic() > deadline:
                return None
            b = conn.recv(min(65536, length - len(body)))
            if not b:
                break
            body += b
        return method, path, body

    # -- routing -----------------------------------------------------------

    def _route(self, path, method='GET', body=b''):
        if method != 'GET':
            return ('405 Method Not Allowed', 'text/plain',
                    b'GET only\n')
        try:
            if path == '/metrics':
                from . import fleet as _fleet
                from . import metrics as _metrics
                mon = _fleet.monitor()
                if mon is not None:
                    # snapshot-age gauges refresh at scrape time: a
                    # SILENT rank's age must keep growing
                    mon.refresh_gauges()
                return ('200 OK',
                        'text/plain; version=0.0.4; charset=utf-8',
                        _metrics.prometheus().encode())
            if path == '/healthz':
                doc = self.health()
                status = '200 OK' if doc.get('status') == 'ok' \
                    else '503 Service Unavailable'
                return (status, 'application/json',
                        json.dumps(doc, default=str).encode())
            if path == '/flight':
                from . import flight as _flight
                doc = _flight.get().snapshot(resolve_loss=False)
                return ('200 OK', 'application/json',
                        json.dumps(doc, default=str).encode())
            return ('404 Not Found', 'text/plain',
                    b'endpoints: /metrics /healthz /flight\n')
        except Exception as e:
            _log.exception("telemetry endpoint %s failed", path)
            return ('500 Internal Server Error', 'text/plain',
                    repr(e).encode())

    def health(self):
        """The /healthz document (also callable in-process). Reads only
        local state — the flight recorder, the registry, the allocator's
        counters — never a device sync."""
        from ..base import telem_flags as _telem
        from . import compile as _compile
        from . import fleet as _fleet
        from . import flight as _flight
        from . import memory as _memory
        from . import metrics as _metrics
        from . import trace as _trace
        doc = {'status': 'ok', 'pid': os.getpid(),
               'time': round(_time.time(), 3),
               'telemetry': bool(_telem['on']),
               'trace': bool(_trace.enabled())}
        rec = _flight.get().last_step_record()
        if rec is not None:
            doc['last_step'] = rec.get('step')
            doc['last_step_wall_ms'] = rec.get('interval_ms')
        sps = _metrics.recent_samples_per_second(60.0)
        if sps is not None:
            doc['samples_per_second'] = sps
        # live/peak device memory + host RSS, computed on demand: a fleet
        # operator should see the pressure BEFORE the OOM
        doc['memory'] = _memory.health_fields()
        doc['compile'] = _compile.health_fields()
        from ..checkpoint.manager import last_committed_step
        doc['last_committed_step'] = last_committed_step()
        doc['verdict'] = stall_verdict()
        mon = _fleet.monitor()
        if mon is not None:
            doc['fleet'] = mon.view()
        v = doc.get('verdict') or {}
        if v.get('lost'):
            doc['status'] = 'peer_loss'
        return doc


# ---------------------------------------------------------------------------
# process-global instance
# ---------------------------------------------------------------------------

_server = None
_server_lock = threading.RLock()


def get():
    """The process-global TelemetryServer, or None (disarmed)."""
    return _server


def start(port=None, rank=0, membership=None, **kwargs):
    """Start (or return) the process-global endpoint. ``port=None``
    reads ``MXTPU_METRICS_PORT`` + rank; an explicit port is used
    as-is."""
    global _server
    _refuse_membership(membership)
    with _server_lock:
        if _server is not None:
            return _server
        if port is None:
            from .. import config as _config
            base = int(_config.get('MXTPU_METRICS_PORT') or 0)
            if not base:
                return None
            port = base + int(rank)
        _server = TelemetryServer(port=int(port), **kwargs)
    return _server


def stop():
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None


def maybe_start(rank=None, membership=None):
    """Arm the endpoint iff MXTPU_METRICS_PORT is set. Never raises for
    a failed start — observability must not take down the process; a
    ``membership`` raises (not ported)."""
    _refuse_membership(membership)
    try:
        if rank is None:
            from .. import config as _config
            rank = max(0, _config.get('MXNET_TPU_PROC_ID'))
        return start(rank=rank)
    except Exception:
        _log.exception("telemetry endpoint failed to start")
        return None
