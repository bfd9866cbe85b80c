"""RowSparse gradient kernels: id dedup and the live-row lookup capture
(counterpart of ``mxnet_tpu/ops/rowsparse.py``).

The reference treats ``row_sparse`` as a first-class gradient storage
type (ref: src/operator/tensor/indexing_op.cc EmbeddingOpBackwardEx): an
Embedding/take backward produces (unique row ids, row-block values) and
the optimizer touches only those rows. As in the JAX package, that
structure falls out of a dedup-first lookup::

    uids, inv = unique_rows(ids)         # sort -> segment boundaries
    rows = weight[uids]                  # gather unique rows once
    out  = rows[inv]                     # fan back out to every slot

whose backward segment-sums the per-occurrence cotangents into one row
block per unique id before anything touches table-shaped storage.

Every op here has a static shape and reads nothing back to the host, so
the whole path can be captured into a CUDA graph: the unique count
``n_live`` stays a device tensor, and the ``(budget,)`` id buffer is
padded with the sentinel ``vocab`` (one past the last row). Where the
JAX package relies on XLA dropping out-of-range scatters, the sentinel
is handled explicitly here: a gather clamps it to ``vocab - 1``, and a
write never targets it (``write_slots``).

Determinism. torch's backward of ``rows[inv]`` scatter-adds with
atomics on CUDA, so its float sums change order from run to run. The
fan-out here is an autograd Function whose backward is a segment sum
over a stable sort of the ids (``torch.segment_reduce``, one sequential
sum per segment): the summation order depends only on the id multiset
and the batch order, and the CPU and the card add in the same order.
The dense route (``dedup_take``) and the sparse route (the capture) go
through the same sum, so exact sparse updates and dense ones agree bit
for bit.

``trace_capture`` is the seam ``parallel/step.py`` arms around the
model forward: an ``embedding`` lookup on a captured table routes through
the dedup lookup, adds the step's per-table row tangent (the
differentiated leaf whose gradient IS the RowSparse row block), and
records the live ids for the optimizer.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError

__all__ = ['unique_rows', 'dedup_take', 'merge_row_blocks', 'write_slots',
           'densify_rows', 'trace_capture', 'lookup_capture']


class _Dedup:
    """One dedup of a flat id vector: the JAX ``unique_rows`` outputs
    (``uids``, ``inv``, ``n_live``) plus the stable sort order ``perm``
    and the ``(budget + 1,)`` segment ``offsets`` the backward sums
    over."""

    __slots__ = ('uids', 'inv', 'n_live', 'perm', 'offsets')

    def __init__(self, flat_ids, budget, vocab):
        ids = flat_ids.reshape(-1).to(torch.int64).clamp(0, vocab - 1)
        sorted_ids, perm = torch.sort(ids, stable=True)
        first = torch.ones_like(sorted_ids)
        first[1:] = (sorted_ids[1:] != sorted_ids[:-1]).to(torch.int64)
        seg = torch.cumsum(first, 0) - 1
        self.n_live = seg[-1] + 1
        # one write per sorted position, every write of a segment the
        # same value; a segment past the budget lands in the spare slot
        uids = torch.full((budget + 1,), vocab, dtype=torch.int64,
                          device=ids.device)
        uids.scatter_(0, seg.clamp(max=budget), sorted_ids)
        self.uids = uids[:budget]
        # every clamped id is in uids, which ascends with the sentinel
        # past the live prefix: the insertion point IS the unique slot
        self.inv = torch.searchsorted(self.uids, ids)
        self.perm = perm
        # segment k of the sorted ids: [offsets[k], offsets[k + 1]); a
        # sentinel slot's segment is empty, and the last one ends where
        # the run of the last kept id ends
        self.offsets = torch.cat([
            torch.searchsorted(sorted_ids, self.uids),
            torch.searchsorted(sorted_ids, self.uids[-1:], right=True)])

    def segment_sum(self, values):
        """(budget, ...) sums of ``values`` (one row per input id) over
        each unique id's occurrences, in batch order."""
        return torch.segment_reduce(values.index_select(0, self.perm), 'sum',
                                    offsets=self.offsets, axis=0,
                                    unsafe=True)


def unique_rows(flat_ids, budget, vocab):
    """Dedup a flat int vector of row ids into a fixed-size buffer.

    Returns ``(uids, inv, n_live)`` as int64 tensors (torch's index
    type; the JAX function's are int32):

    - ``uids``: ``(budget,)``, the unique ids in ascending order, padded
      with the sentinel ``vocab`` (slots past ``n_live``);
    - ``inv``: ``(flat_ids.numel(),)``, the position of each input id in
      ``uids`` (``uids[inv] == clamp(flat_ids)``);
    - ``n_live``: ``()``, how many slots are real.

    ``budget`` must be at least the unique count (``min(flat_ids.numel(),
    vocab)`` always is)."""
    d = _Dedup(flat_ids, int(budget), int(vocab))
    return d.uids, d.inv, d.n_live


class _FanOut(torch.autograd.Function):
    """``rows[inv]``, its backward the dedup's segment sum (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, rows, dedup):
        ctx.dedup = dedup
        return rows.index_select(0, dedup.inv)

    @staticmethod
    def backward(ctx, grad):
        return ctx.dedup.segment_sum(grad), None


class _RowGather(torch.autograd.Function):
    """``table[uids]`` (the sentinel clamped), its backward the row block
    written into a table-shaped zero gradient (``densify_rows``)."""

    @staticmethod
    def forward(ctx, table, uids):
        vocab = table.shape[0]
        ctx.save_for_backward(uids)
        ctx.shape = tuple(table.shape)
        return table.index_select(0, uids.clamp(max=vocab - 1))

    @staticmethod
    def backward(ctx, grad):
        uids, = ctx.saved_tensors
        return densify_rows(uids, grad, ctx.shape[0]), None


def write_slots(n_live, budget):
    """The slot each of ``budget`` row writes takes its id and value
    from: itself while it is live, the last live slot after that. A write
    through these never targets the sentinel, and the extra writes of
    the last live row carry its own value, so their order cannot
    matter."""
    slots = torch.arange(budget, device=n_live.device)
    return torch.minimum(slots, (n_live - 1).clamp(min=0))


def densify_rows(uids, rows, vocab):
    """A ``(vocab, ...)`` zero tensor with ``rows`` written at ``uids``
    (unique apart from the sentinel): the exact-mode gradient. The
    sentinel slots write their zero rows into a spare trailing row."""
    out = torch.zeros((vocab + 1,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    out.index_copy_(0, uids.clamp(max=vocab), rows)
    return out[:vocab]


def dedup_take(a, indices, vocab=None):
    """``take(a, indices, axis=0, mode='clip')`` through the dedup-first
    lookup: forward values are the plain gather's, bit for bit; the
    backward segment-sums repeated ids into one row block before the
    table-shaped write, in an order that does not depend on the
    device."""
    vocab = int(a.shape[0]) if vocab is None else int(vocab)
    idx = indices.to(torch.int64)
    n = idx.numel()
    if n == 0 or vocab == 0:
        return a.index_select(0, idx.reshape(-1).clamp(0, max(vocab - 1, 0))
                              ).reshape(tuple(idx.shape) + tuple(a.shape[1:]))
    d = _Dedup(idx, min(n, vocab), vocab)
    rows = _RowGather.apply(a, d.uids)
    out = _FanOut.apply(rows, d)
    return out.reshape(tuple(idx.shape) + tuple(a.shape[1:]))


def merge_row_blocks(uids, values, vocab, budget=None):
    """Merge possibly-overlapping ``(uids, row values)`` blocks (two
    lookups of the same table in one step) into one deduped block:
    duplicate ids segment-sum their rows; sentinel slots stay zero.
    ``budget`` defaults to ``min(uids.numel(), vocab)``. Returns
    ``(uids, rows, n_live)``."""
    uids = uids.reshape(-1)
    values = values.reshape((uids.shape[0],) + tuple(values.shape[1:]))
    if budget is None:
        budget = min(int(uids.shape[0]), int(vocab))
    # sentinel entries (uid == vocab) sort last: their group either lands
    # past the budget (dropped) or keeps the sentinel uid; its values are
    # zero either way
    d = _Dedup(uids, int(budget), int(vocab) + 1)
    muids = torch.clamp(d.uids, max=int(vocab))
    merged = d.segment_sum(values)
    n_live = (muids < vocab).sum()
    return muids, merged, n_live


# ---------------------------------------------------------------------------
# the capture: parallel/step.py arms a context keyed by the identity of
# each sparse table's tensor; the embedding op checks it and routes
# captured lookups through the dedup + tangent path. Thread-local, so
# steps built on several threads never see each other's tables.
# ---------------------------------------------------------------------------

_TLS = threading.local()


class _TableSlot:
    """Per-table capture state for one forward."""

    def __init__(self, name, table, tangent=None, budgets=None):
        self.name = name
        self.table = table
        self.vocab = int(table.shape[0])
        self.dim = int(table.shape[1])
        self.tangent = tangent          # (sum(budgets), dim) leaf or None
        self.budgets = list(budgets or [])   # per-lookup row budgets
        self.call_sizes = []            # discover mode: flat id counts
        self.uids = []                  # per-lookup (budget,) id vectors
        self.n_live = []                # per-lookup live counts
        self.frozen = False             # forward done: recomputes follow
        self._recomputes = 0

    def lookup(self, idx):
        n = idx.numel()
        if self.tangent is None:
            # discover mode: record the lookup's id count; the plain
            # gather keeps shapes flowing
            self.call_sizes.append(n)
            return self.table.index_select(
                0, idx.reshape(-1).to(torch.int64).clamp(0, self.vocab - 1)
            ).reshape(tuple(idx.shape) + (self.dim,))
        if self.frozen:
            # a remat region's recompute in the backward: the same lookup
            # again, through the same tangent slice, recording nothing
            k = self._recomputes % len(self.budgets)
            self._recomputes += 1
        else:
            k = len(self.uids)
        if k >= len(self.budgets) or self.budgets[k] != min(n, self.vocab):
            raise MXNetError(
                f"ShardedTrainStep: sparse table {self.name!r} is looked "
                f"up more often, or with another id count ({n}), in this "
                f"step than when the step was built (row budgets "
                f"{self.budgets}); the budgets are fixed at the build: "
                f"build a new step for the new lookups")
        budget = self.budgets[k]
        offset = sum(self.budgets[:k])
        d = _Dedup(idx, budget, self.vocab)
        # the table itself is not differentiated: the row tangent added
        # below is the only leaf, and its gradient is the deduped
        # RowSparse row block the optimizer consumes
        rows = self.table.detach().index_select(
            0, d.uids.clamp(max=self.vocab - 1))
        rows = (rows.to(self.tangent.dtype)
                + self.tangent[offset:offset + budget])
        if not self.frozen:
            self.uids.append(d.uids)
            self.n_live.append(d.n_live)
        out = _FanOut.apply(rows, d).to(self.table.dtype)
        return out.reshape(tuple(idx.shape) + (self.dim,))

    def check_complete(self):
        if self.tangent is not None and len(self.uids) != len(self.budgets):
            raise MXNetError(
                f"ShardedTrainStep: sparse table {self.name!r} was looked "
                f"up {len(self.uids)} times in this step, "
                f"{len(self.budgets)} times when the step was built; "
                f"build a new step for the new lookups")


class _Capture:
    def __init__(self, slots):
        self.slots = slots                       # name -> _TableSlot
        self.by_id = {id(s.table): s for s in slots.values()}

    def __enter__(self):
        stack = getattr(_TLS, 'stack', None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _TLS.stack.pop()
        if exc[0] is None:
            self.freeze()
        return False

    def freeze(self):
        """The forward is done: check every table was looked up as at the
        build; later lookups are a remat recompute's."""
        for s in self.slots.values():
            if not s.frozen:
                s.check_complete()
                s.frozen = True

    def results(self):
        """{name: {'uids': (budget,) int64, 'n_live': () int64}}, a
        table looked up several times concatenated (the update re-dedups
        it through ``merge_row_blocks``)."""
        out = {}
        for n, s in self.slots.items():
            if not s.uids:
                continue
            out[n] = {
                'uids': torch.cat(s.uids) if len(s.uids) > 1 else s.uids[0],
                'n_live': sum(s.n_live[1:], s.n_live[0]),
            }
        return out


def trace_capture(tables, tangents=None, budgets=None):
    """Arm a capture for one forward of the model.

    ``tables``: {name: table tensor (vocab, dim)}, matched by identity
    (the tensor a block hands its ``hybrid_forward``); ``tangents``:
    {name: (sum(budgets), dim) zero leaf} or None for discover mode
    (record per-lookup id counts only); ``budgets``: {name: [per-lookup
    row budget, ...]}."""
    slots = {}
    for n, t in tables.items():
        slots[n] = _TableSlot(
            n, t, tangent=None if tangents is None else tangents[n],
            budgets=None if budgets is None else budgets.get(n))
    return _Capture(slots)


def lookup_capture(weight):
    """The armed table slot for ``weight`` (matched by identity) or None:
    the hook ``ops.nn.embedding`` checks on every call."""
    stack = getattr(_TLS, 'stack', None)
    if not stack:
        return None
    return stack[-1].by_id.get(id(weight))
