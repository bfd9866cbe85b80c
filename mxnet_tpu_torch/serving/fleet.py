"""Fleet front: health-steered routing over replicas (counterpart of
``mxnet_tpu/serving/fleet.py``).

N identical replica processes (``PredictServer``) behind a router:

- **routing** — round-robin with ejection over an explicit endpoint
  list: a replica that fails ``MXTPU_SERVE_EJECT_FAILURES`` consecutive
  predicts (connect refused, 5xx, shed) is ejected for
  ``MXTPU_SERVE_READMIT_SECONDS``; a failed predict FAILS OVER to the
  next live replica inside one ``predict()`` call, so a draining replica
  costs a retry, never an error. Ejected replicas stay at the back of
  the candidate list (tried only when every live one failed).
- **readmission** — once its readmit time has passed, an ejected
  replica is probed with ``GET /healthz`` (the same health document a
  fleet operator reads; a draining replica answers 503) before it
  rejoins the rotation: 200 readmits it, anything else ejects it for
  another period. The JAX router's docstring promises this probe; its
  code lets the next routed predict be the probe instead.

Replica discovery from the membership view (``discover_replicas``) and
the checkpoint weight push over the replica transport (``push_weights``)
wait for ``parallel.dist``'s membership and the replica transport
(ROADMAP queue 1 item 10): they raise, and so does a ``Router`` given a
``membership``.
"""
from __future__ import annotations

import http.client
import json
import threading
import time as _time

from .. import config as _config
from ..base import MXNetError, telem_flags as _telem
from ..telemetry import flight as _flight, metrics as _metrics

__all__ = ['Router', 'discover_replicas', 'http_json', 'push_weights',
           'NoReplicasError']


class NoReplicasError(MXNetError):
    """Every replica is ejected/unreachable — the fleet is down."""


def http_json(host, port, path, doc=None, timeout=10.0):
    """One JSON round trip: GET when ``doc`` is None, else POST.
    Returns (status_code, parsed_body_or_None)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        if doc is None:
            conn.request('GET', path)
        else:
            body = json.dumps(doc).encode()
            conn.request('POST', path, body=body,
                         headers={'Content-Type': 'application/json',
                                  'Content-Length': str(len(body))})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw.decode('utf-8')) if raw else None
        except ValueError:
            parsed = None
        return resp.status, parsed
    finally:
        conn.close()


def discover_replicas(membership, serve_port_base, host='127.0.0.1'):
    """Replicas from the membership view: needs ``parallel.dist``."""
    raise MXNetError(
        "discover_replicas: the membership view (parallel.dist) is not "
        "ported (ROADMAP queue 1 item 10); give Router an endpoint list")


def push_weights(block, step, replicas, ns='serving', timeout=10.0):
    """Checkpoint push over the replica transport, then ``/reload``:
    needs the replica transport and ``parallel.dist``."""
    raise MXNetError(
        "push_weights: the replica transport (checkpoint.replica, "
        "parallel.dist's membership) is not ported (ROADMAP queue 1 item "
        "10); "
        "save the weights where the replica reads them and POST /reload "
        "{'path': ...}")


class _Replica:
    __slots__ = ('rank', 'host', 'port', 'fails', 'ejected_until')

    def __init__(self, rank, host, port):
        self.rank = rank
        self.host = host
        self.port = port
        self.fails = 0
        self.ejected_until = 0.0


class Router:
    """Round-robin with ejection over a replica set. Thread-safe; one
    router instance fronts any number of client threads. A replica's
    rank is its index in ``endpoints``."""

    def __init__(self, endpoints=None, membership=None,
                 serve_port_base=None, eject_failures=None,
                 readmit_seconds=None, timeout=10.0):
        if membership is not None:
            raise MXNetError(
                "Router(membership=...): the membership view "
                "(parallel.dist) is not ported (ROADMAP queue 1 item 10)")
        self.timeout = float(timeout)
        self.eject_failures = int(
            _config.get('MXTPU_SERVE_EJECT_FAILURES')
            if eject_failures is None else eject_failures)
        self.readmit_seconds = float(
            _config.get('MXTPU_SERVE_READMIT_SECONDS')
            if readmit_seconds is None else readmit_seconds)
        self._lock = threading.Lock()
        self._replicas = {}
        self._rr = 0
        self.requests = 0
        self.failovers = 0
        self.readmissions = 0
        for i, (host, port) in enumerate(endpoints or ()):
            self._replicas[i] = _Replica(i, host, int(port))

    def refresh(self):
        """The replica set comes from the endpoint list: nothing to
        re-derive without a membership view."""

    # -- routing -----------------------------------------------------------

    def _probe(self, rep):
        """Readmission: an ejected replica past its readmit time rejoins
        when its /healthz answers 200, else sits out another period."""
        try:
            status, _doc = http_json(rep.host, rep.port, '/healthz',
                                     timeout=min(self.timeout, 2.0))
        except OSError:
            status = None
        with self._lock:
            if status == 200:
                rep.fails = 0
                rep.ejected_until = 0.0
                self.readmissions += 1
            else:
                rep.ejected_until = _time.monotonic() + self.readmit_seconds
        if status == 200:
            _flight.note('serving.readmit', rank=rep.rank, port=rep.port)
        return status == 200

    def _candidates(self):
        """Live-first candidate order starting at the round-robin
        cursor; an ejected replica past its readmit time is probed back
        in first, and the ejected ones stay at the back."""
        now = _time.monotonic()
        with self._lock:
            reps = list(self._replicas.values())
            self._rr += 1
            start = self._rr
            due = [r for r in reps
                   if r.fails >= self.eject_failures and
                   0.0 < r.ejected_until <= now]
            for r in due:
                # one probe per period: concurrent callers skip it
                r.ejected_until = now + self.readmit_seconds
        for rep in due:
            self._probe(rep)
        if not reps:
            return []
        now = _time.monotonic()
        reps = reps[start % len(reps):] + reps[:start % len(reps)]
        live = [r for r in reps if r.ejected_until <= now]
        stale = [r for r in reps if r.ejected_until > now]
        return live + stale

    def _mark(self, rep, ok, reason=''):
        with self._lock:
            if ok:
                rep.fails = 0
                rep.ejected_until = 0.0
                return
            rep.fails += 1
            if rep.fails < self.eject_failures:
                return
            rep.ejected_until = _time.monotonic() + self.readmit_seconds
        _flight.note('serving.eject', rank=rep.rank, port=rep.port,
                     reason=reason)
        if _telem['on']:
            _metrics.counter('mxnet_tpu_serving_ejections_total').inc(
                1, rank=rep.rank)

    def eject(self, rank, reason='external'):
        """Explicit ejection (a FleetMonitor detector naming a rank,
        an operator pulling a replica)."""
        with self._lock:
            rep = self._replicas.get(rank)
            if rep is None:
                return
            rep.fails = self.eject_failures
            rep.ejected_until = _time.monotonic() + self.readmit_seconds
        _flight.note('serving.eject', rank=rank, reason=reason)

    def ejected(self):
        now = _time.monotonic()
        with self._lock:
            return sorted(r.rank for r in self._replicas.values()
                          if r.ejected_until > now)

    def predict(self, inputs, timeout=None):
        """Route one predict, failing over across replicas: a shed
        (503), connect failure or 5xx tries the next candidate; only a
        definitive client error (4xx) or total exhaustion surfaces."""
        timeout = self.timeout if timeout is None else timeout
        errors = []
        for rep in self._candidates():
            try:
                status, doc = http_json(rep.host, rep.port, '/predict',
                                        {'inputs': inputs},
                                        timeout=timeout)
            except OSError as e:
                self._mark(rep, False, f'connect: {e!r}')
                errors.append(f'rank{rep.rank}: {e!r}')
                with self._lock:
                    self.failovers += 1
                continue
            if status == 200:
                self._mark(rep, True)
                with self._lock:
                    self.requests += 1
                return doc['outputs']
            if 400 <= status < 500:
                # our fault, not the replica's — no ejection credit
                raise MXNetError(
                    f"predict rejected ({status}): {doc}")
            self._mark(rep, False, f'status {status}')
            errors.append(f'rank{rep.rank}: status {status} {doc}')
            with self._lock:
                self.failovers += 1
        raise NoReplicasError(
            "no replica could serve the request: " + '; '.join(errors)
            if errors else "no replicas registered")
