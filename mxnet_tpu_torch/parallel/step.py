"""The compiled training step (counterpart of ``mxnet_tpu/parallel/step.py``
``ShardedTrainStep``), on one card or data-parallel over a world of ranks.

    step = ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                            {'learning_rate': 1e-4})
    loss = step([tokens, types, valid_length, masked_positions],
                [labels, nsp_labels])

One call is one training step: the forward of ``block`` in training mode,
the loss as the mean of ``loss_fn(*outputs, *labels)``, the gradients of
every trainable parameter in f32 (zero for one the loss does not reach,
as ``jax.grad`` gives), and the update by the JAX package's step closures
(``_OPTS``: sgd, adam, adamw, lamb, written here over ``torch._foreach_*``
so that an update is a few multi-tensor launches), in f32 against an f32
master for every bf16/f16 parameter. The optimizer's parameters are the
JAX step's (``learning_rate`` or ``lr`` popped as the rate; the others go
to the closure); ``step(..., lr=x)`` overrides the rate for one call.

On CUDA the first call for an input signature (the inputs' and labels'
shapes and dtypes, as the JAX step keys its compile) runs the step
eagerly on a side stream, which builds the kernels and initialises the
libraries outside any capture, and returns that step's loss. It then
captures the same step (forward, backward and update) into one CUDA
graph. Every later call with that signature copies the inputs into the
graph's static buffers, writes the rate into a device scalar, replays the
graph and returns a clone of its loss (a fresh tensor, as the JAX step
returns a fresh array; the graph's own buffer is overwritten by the next
replay). The dropout generators of the block's modules are registered with
the graph, so every replay draws new noise and a new attention seed. A
capture that fails raises ``MXNetError``: nothing falls back to eager.
Parameters, masters and optimizer states are updated in place (the JAX
step returns new arrays and swaps them in), so they must stay the same
tensors from one call to the next.

On the CPU the same step runs eagerly on every call.

Data parallelism. In a world of more than one rank (``dist.init``; the
mesh spans it, ``make_mesh((N,), ('dp',))``) each rank passes its own
rows of the global batch, in rank order, as the JAX step's processes do
(``_put_batch``), every rank the same number. At build the parameters,
and the generators a module marks ``generator_replicated`` (the
attention seeds' stream, ``models/bert.py``), are broadcast from rank 0
(``_put_replicated``). A step then computes what one device computes on
the concatenated global batch:

1. the forward on the rank's rows;
2. the outputs and labels all-gathered, and the loss over the global
   batch on every rank (a loss normalised by a count over the batch, as
   ``bert_pretrain_loss`` is, needs the whole batch); every rank
   computes the same loss, so the gradient of its own rows' outputs is
   its slice of the loss's gradient, times the world's size (the
   reduce-scatter that ``all_gather``'s gradient is sums that many equal
   copies), and the backward runs on the rank's rows;
3. the f32 gradients averaged over the ranks: reduce-scattered along each
   parameter's ZeRO dim, and all-reduced where a tensor stays replicated;
4. the update on the rank's shard, against the shard's f32 master and
   moments (LAMB's trust ratio all-reduces its per-shard sums of squares
   first: it is the one update that is not elementwise);
5. the parameters all-gathered from the updated shards.

ZeRO-1 is on by default at dp > 1 (``MXTPU_ZERO``, ``zero=``), with the
JAX step's layout, tensor by tensor (``compose_zero_spec``): the first
dim that splits evenly over dp is sharded; scalars and ragged tensors
stay replicated. ``zero=0`` all-reduces every gradient and updates
replicated state. On CUDA at dp = 1 the step stays one CUDA graph; at
dp > 1 the capture splits where the collectives run: a graph of the
forward, the gather of the outputs, a graph of the loss and the backward
into the f32 gradient buffers, the gradient reduction, a graph of the
shard update (two around LAMB's norm reduction), and the all-gather of the
parameters, all on the step's stream. gloo collectives cannot be
captured; folding NCCL's into the graphs is later work. The comm
accounting is the JAX step's analytic ring model (``comm_bytes_per_hop``
and the ``mxnet_tpu_comm_*`` counters), and ``opt_state_bytes_per_device``
/ ``param_bytes_per_device`` count what this rank holds. The states
payload is gathered to logical full tensors, so a save at one dp (or
under ZeRO) restores at any other. A BatchNorm's statistics stay the
rank's own (a ``SyncBatchNorm`` reduces them over the world, eagerly
only: over gloo its collectives cannot be captured, and the step refuses
it on the card), where the JAX program's span the global batch.

Telemetry, as the JAX step reports it, all of it on the host side of a
call and none inside the capture: each call runs under a
``step.dispatch`` span (the replay under ``step.compiled`` and the OOM
guard), the first call for a signature is a compile of site
``step:train_step`` (the compile ledger when armed, else the compile
counters), and each call ends with ``memory.on_step`` and
``flight.record_step``, whose loss stays the device tensor it is (the
recorder reads it only when asked), so the step stays free of host
syncs.

A Gluon block (``gluon.HybridBlock``, e.g. the model zoo's ResNets) is
taken as it is: its forward updates BatchNorm's running statistics in
place, inside the captured graph on each replay (the JAX step threads
them out of its program as ``f_params``); parameters still deferred are
placed by one forward in predict mode before the first step; after
``net.cast(dtype)`` its floating inputs are cast to that dtype (a
float32 batch would reach a bfloat16 convolution, which the JAX
package's step refuses; a block built in its dtype, as the BERT models
are, takes its inputs as they come, so a float32 ``valid_length`` stays
exact); the block's
hybridize cache stays out of the step, which captures the block itself.
A ``loss_fn`` written on ``mx.nd`` ops gets tensors (the ops take them),
and with NDArray inputs the loss comes back as an NDArray, as bench.py's
``_resnet_report`` calls it.

Not ported, each refused by name: ``param_specs`` naming an axis other
than dp (tensor parallelism, ROADMAP queue 1 item 6a) or dp itself
(a parameter sharded between steps is ZeRO-3's layout), ZeRO-3 and
``MXTPU_REMAT`` (item 7), ``compression_params`` and ``hierarchy``, and a
dp axis over several hosts, which the JAX step splits (item 8),
``guard`` (item 9), sparse gradients (item 12).
"""
from __future__ import annotations

import pickle
import time

import numpy as onp
import torch
from torch.nn.parameter import UninitializedParameter

from .. import config as _config
from .._capture import DeviceScalars, capture, graph_generators
from ..base import MXNetError, state, telem_flags as _telem, torch_dtype
from ..gluon.block import Block, plain_calls
from ..ndarray.ndarray import NDArray
from ..telemetry import compile as _compile, flight as _flight, \
    memory as _memory, metrics as _metrics, trace as _trace
from . import collectives as _coll, dist as _dist
from .mesh import make_mesh

__all__ = ['ShardedTrainStep', 'rename_states', 'STATES_FORMAT',
           'PartitionSpec', 'compose_zero_spec']

STATES_FORMAT = 'sharded_train_step_v1'


class PartitionSpec(tuple):
    """The JAX ``PartitionSpec`` as a tuple: one mesh axis name (or a
    tuple of names, or None for a replicated dim) per tensor dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f'PartitionSpec{tuple.__repr__(self)}'

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def compose_zero_spec(shape, base_spec, dp_axis, dp_size):
    """ZeRO layout for an optimizer-state/master tensor (the JAX step's
    rule, copied as it is): compose a dp shard onto the parameter's
    spec. Picks the first dim not already claimed by another mesh axis
    whose size splits EVENLY over dp. None when nothing is shardable
    (scalars, sub-dp-size and ragged tensors stay replicated).

    A base spec that itself proposes ``dp_axis`` on a non-divisible dim
    raises MXNetError up front."""
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))
    for i, s in enumerate(spec):
        # already sharded over dp (fsdp-style param_specs): the state
        # inherits the param's own 1/dp layout — composing again would
        # produce an invalid duplicate-axis spec
        if s == dp_axis or (isinstance(s, (tuple, list)) and dp_axis in s):
            if dp_size > 1 and shape[i] % dp_size != 0:
                raise MXNetError(
                    f"compose_zero_spec: spec {tuple(base_spec)!r} shards "
                    f"dim {i} (size {shape[i]}) over the {dp_size}-device "
                    f"'{dp_axis}' axis, but {shape[i]} is not divisible "
                    f"by {dp_size} — XLA refuses uneven shardings. Pad "
                    f"the dim, drop '{dp_axis}' from the spec, or let "
                    f"ZeRO-3 flatten+pad it (zero3_layout).")
            return None
    for i, s in enumerate(spec):
        if s is not None or shape[i] < dp_size \
                or shape[i] % dp_size != 0:
            continue
        spec[i] = dp_axis
        return P(*spec)
    return None


# The JAX step's update closures over lists: ps are the f32 weights (the
# masters of low-precision parameters), gs the f32 gradients, st the
# state slots (one list per state tensor), lr and t 0-d device tensors.
# Each follows its closure's arithmetic in the same order.


def _sgd_update(ps, gs, st, lr, t, momentum=0.9, wd=0.0):
    moms, = st
    if wd:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, torch._foreach_mul(gs, lr))
    torch._foreach_add_(ps, moms)


def _moments(gs, ms, vs, beta1, beta2):
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - beta1))
    torch._foreach_mul_(vs, beta2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                               1 - beta2))


def _bias_corrected(ms, vs, t, beta1, beta2):
    tf = t.to(torch.float32)
    return (torch._foreach_div(ms, 1 - beta1 ** tf),
            torch._foreach_div(vs, 1 - beta2 ** tf))


def _adam_update(ps, gs, st, lr, t, beta1=0.9, beta2=0.999, eps=1e-8,
                 wd=0.0):
    ms, vs = st
    if wd:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    _moments(gs, ms, vs, beta1, beta2)
    mhat, vhat = _bias_corrected(ms, vs, t, beta1, beta2)
    den = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
    torch._foreach_sub_(ps, torch._foreach_div(torch._foreach_mul(mhat, lr),
                                               den))


def _adamw_update(ps, gs, st, lr, t, beta1=0.9, beta2=0.999, eps=1e-8,
                  wd=0.01, eta=1.0):
    # no bias correction, decoupled wd scaled by lr: the arithmetic of
    # ops/optimizer_ops.py adamw_update, so this step and the Trainer
    # follow one trajectory (the JAX step's comment at this closure)
    ms, vs = st
    _moments(gs, ms, vs, beta1, beta2)
    den = torch._foreach_add(torch._foreach_sqrt(vs), eps)
    upd = torch._foreach_div(torch._foreach_mul(ms, lr), den)
    torch._foreach_add_(upd, torch._foreach_mul(ps, wd * lr))
    torch._foreach_sub_(ps, torch._foreach_mul(upd, eta))


def _lamb_direction(ps, gs, st, t, beta1=0.9, beta2=0.999, eps=1e-6,
                    wd=0.01):
    """LAMB's update direction before its trust ratio (moments updated)."""
    ms, vs = st
    _moments(gs, ms, vs, beta1, beta2)
    mhat, vhat = _bias_corrected(ms, vs, t, beta1, beta2)
    den = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
    upd = torch._foreach_div(mhat, den)
    torch._foreach_add_(upd, torch._foreach_mul(ps, wd))
    return upd


def _lamb_apply(ps, upd, r1, r2, lr):
    """The trust ratio r1/r2 (weight and update norms, one per tensor)
    and the step."""
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    torch._foreach_mul_(upd, list((lr * ratio).unbind(0)))
    torch._foreach_sub_(ps, upd)


def _lamb_update(ps, gs, st, lr, t, **kw):
    upd = _lamb_direction(ps, gs, st, t, **kw)
    _lamb_apply(ps, upd, torch.stack(torch._foreach_norm(ps)),
                torch.stack(torch._foreach_norm(upd)), lr)


# name -> (state tensors per parameter besides t, whether the state holds
# an update count t, the update)
_OPTS = {
    'sgd': (1, False, _sgd_update),
    'adam': (2, True, _adam_update),
    'adamw': (2, True, _adamw_update),
    'lamb': (2, True, _lamb_update),
}


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_tensor(x):
    if isinstance(x, NDArray):
        return x._data
    return torch.from_numpy(onp.asarray(x)) if isinstance(
        x, (onp.ndarray, onp.generic)) else x


def _spec_axes(spec):
    """The mesh axis names a param_specs entry names."""
    out = set()
    for s in (spec if isinstance(spec, (tuple, list)) else (spec,)):
        if isinstance(s, (tuple, list)):
            out |= {a for a in s if a is not None}
        elif s is not None:
            out.add(s)
    return out


def rename_states(blob, names):
    """A ``get_states_bytes`` payload with its parameter names mapped by
    ``names`` ({old: new}; every name must be there): the JAX step keys
    its payload by ``collect_params()`` names, the port by the structured
    names of ``named_parameters()``, so a payload crosses between the
    packages through this."""
    doc = pickle.loads(blob)
    if doc.get('format') != STATES_FORMAT:
        raise MXNetError(f"rename_states: not a ShardedTrainStep payload "
                         f"(format={doc.get('format')!r})")
    for key in ('opt_state', 'master', 'residual'):
        if key in doc:
            missing = sorted(set(doc[key]) - set(names))
            if missing:
                raise MXNetError(f"rename_states: no new name for "
                                 f"{missing[:5]}")
            doc[key] = {names[n]: v for n, v in doc[key].items()}
    return pickle.dumps(doc)


def _device_key(d):
    """A device with a CUDA index filled in: 'cuda' is the current card."""
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return d


def _ring(k):
    return (k - 1) / k if k > 1 else 0.0


class ShardedTrainStep:
    """One training step per call (see the module docstring). ``mesh``
    defaults to a mesh over the world's ranks (one device each), or
    over the device of the block's parameters outside a world."""

    def __init__(self, block, loss_fn, optimizer='sgd', optimizer_params=None,
                 mesh=None, dp_axis='dp', param_specs=None, donate=True,
                 grad_dtype=None, zero=None, compression_params=None,
                 guard=None, hierarchy=None):
        self.block = block
        self.loss_fn = loss_fn
        self.dp_axis = dp_axis
        self.optimizer_params = dict(optimizer_params or {})
        self.lr = self.optimizer_params.pop(
            'learning_rate', self.optimizer_params.pop('lr', 0.01))
        self.optimizer_params.pop('lazy_update', None)
        if optimizer not in _OPTS:
            raise ValueError(f"ShardedTrainStep supports {sorted(_OPTS)}")
        self._n_state, self._has_t, self._opt_update = _OPTS[optimizer]
        if compression_params is not None:
            raise MXNetError("ShardedTrainStep: gradient compression is not "
                             "ported (ROADMAP queue 1 item 8)")
        if hierarchy is not None:
            raise MXNetError("ShardedTrainStep: hierarchical dp is not "
                             "ported (ROADMAP queue 1 item 8)")
        if guard is not None:
            raise MXNetError("ShardedTrainStep: the non-finite guard is not "
                             "ported (ROADMAP queue 1 item 9)")
        for pat, spec in (param_specs or {}).items():
            axes = _spec_axes(spec)
            if axes - {dp_axis}:
                raise MXNetError(
                    f"ShardedTrainStep: param_specs {pat!r} -> {spec!r} "
                    f"names {sorted(axes - {dp_axis})}: tensor "
                    f"parallelism is not ported (ROADMAP queue 1 item 6a)")
            if axes:
                raise MXNetError(
                    f"ShardedTrainStep: param_specs {pat!r} -> {spec!r} "
                    f"shards a parameter over {dp_axis!r} between steps, "
                    f"ZeRO-3's layout (ROADMAP queue 1 item 7)")
        if zero is None:
            zero = _config.get('MXTPU_ZERO')
        stage = int(zero) if not isinstance(zero, bool) else int(bool(zero))
        if stage == 3:
            raise MXNetError("ShardedTrainStep: ZeRO-3 is not ported "
                             "(ROADMAP queue 1 item 7)")
        if stage not in (0, 1):
            raise MXNetError(f"zero={zero!r}: supported ZeRO stages are 0, "
                             f"1 and 3")
        remat = str(_config.get('MXTPU_REMAT')).strip().lower()
        if remat not in ('', '0', 'off', 'false', 'no', 'n', 'none',
                         'disabled'):
            raise MXNetError(f"MXTPU_REMAT={remat!r}: activation remat is "
                             f"not ported (ROADMAP queue 1 item 7)")
        if any(getattr(m, 'sparse', False) for m in block.modules()
               if isinstance(m, torch.nn.Embedding)):
            raise MXNetError("ShardedTrainStep: sparse gradients are not "
                             "ported (ROADMAP queue 1 item 12)")
        params = [p for p in block.parameters()
                  if not isinstance(p, UninitializedParameter)]
        if not params:
            raise MXNetError("ShardedTrainStep: the block has no "
                             "initialized parameters")
        self.device = params[0].device
        # a cast Gluon block's floating inputs take the dtype it was cast to
        cast = getattr(block, '_cast_dtype', None) \
            if isinstance(block, Block) else None
        self._input_dtype = None if cast is None else torch_dtype(cast)
        self.mesh = mesh if mesh is not None else \
            make_mesh(devices=[self.device])
        if _device_key(self.mesh.device) != _device_key(self.device):
            raise MXNetError(f"ShardedTrainStep: mesh {self.mesh} places "
                             f"this rank on {self.mesh.device}, not on the "
                             f"block's device {self.device}")
        self._dp = int(self.mesh.shape.get(dp_axis, 1))
        if self._dp > 1:
            hosts, _ = _dist.dp_host_split()
            if hosts > 1:
                raise MXNetError(
                    f"ShardedTrainStep: the dp axis spans {hosts} hosts, "
                    f"which the JAX step splits into a hierarchy; "
                    f"hierarchical dp is not ported (ROADMAP queue 1 item "
                    f"8): set MXTPU_HIERARCHICAL_DP=1 for the flat "
                    f"topology")
        self.donate = donate
        self.zero_stage = stage if self._dp > 1 else 0
        self.zero = self.zero_stage > 0
        self._zero_label = 'zero1' if self.zero else 'off'
        self._trainable = None       # [(name, parameter)], sorted by name
        self._master = None          # name -> f32 master (a shard under ZeRO)
        self._state = None           # name -> tuple of f32 state tensors
        self._t = None               # update counts, one int32 per parameter
        self._lr = None              # DeviceScalars: this step's rate
        self._graphs = {}            # signature -> the captured step
        self._step_count = 0
        self._pending_states = None  # a restored payload awaiting the build
        self._hop_plan = {}          # (kind, axis) -> (bytes, count) a step
        self.zero_specs = {}

    # ------------------------------------------------------------------
    def _build(self):
        named = sorted(self.block.named_parameters())
        self._trainable = [(n, p) for n, p in named if p.requires_grad]
        dp = self._dp
        if dp > 1:
            self._sync_world()
        shapes = {n: tuple(p.shape) for n, p in self._trainable}
        self.zero_specs = {
            n: compose_zero_spec(shapes[n], P(), self.dp_axis, dp)
            if self.zero else None for n in shapes}
        # name -> the dim its master and moments shard along (ZeRO)
        self._zdim = {n: list(sp).index(self.dp_axis)
                      for n, sp in self.zero_specs.items() if sp is not None}
        low = {n for n, p in self._trainable
               if p.is_floating_point() and p.element_size() < 4}
        self._master = {n: self._local(n, p).to(torch.float32).clone()
                        for n, p in self._trainable if n in low}
        self._state = {n: tuple(torch.zeros(self._local(n, p).shape,
                                            dtype=torch.float32,
                                            device=self.device)
                                for _ in range(self._n_state))
                       for n, p in self._trainable}
        self._t = torch.zeros(len(self._trainable), dtype=torch.int32,
                              device=self.device) if self._has_t else None
        self._lr = DeviceScalars(1, self.device)
        self._p32 = [self._master[n] if n in self._master
                     else self._local(n, p) for n, p in self._trainable]
        self._slots = [[self._state[n][k] for n, _ in self._trainable]
                       for k in range(self._n_state)]
        self._low = [(self._local(n, p), self._master[n])
                     for n, p in self._trainable if n in self._master]
        if dp > 1:
            self._build_dp(shapes)
        self._plan_comm()
        _memory.register_provider(self)
        if _telem['on']:
            _metrics.set_gauge('mxnet_tpu_comm_opt_state_bytes_per_device',
                               self.opt_state_bytes_per_device())
            _metrics.set_gauge('mxnet_tpu_comm_param_bytes_per_device',
                               self.param_bytes_per_device())
        if self._pending_states is not None:
            doc, self._pending_states = self._pending_states, None
            self._apply_states(doc)

    def _local(self, n, p):
        """Parameter ``n``'s part this rank updates: the whole tensor, or
        under ZeRO a view of its shard, the ZeRO dim moved first."""
        d = self._zdim.get(n) if hasattr(self, '_zdim') else None
        if d is None:
            return p.detach()
        s = p.shape[d] // self._dp
        return p.detach().movedim(d, 0).narrow(0, self.mesh.rank * s, s)

    def _sync_world(self):
        """Rank 0's parameters and replicated generators on every rank
        (the JAX step's ``_put_replicated``), and the refusals that need
        the world."""
        from ..gluon.nn import SyncBatchNorm
        if self.device.type == 'cuda' and _dist.backend() == 'gloo' and any(
                isinstance(m, SyncBatchNorm) for m in self.block.modules()):
            raise MXNetError(
                "ShardedTrainStep: a SyncBatchNorm inside the step reduces "
                "its statistics in the middle of the forward; over gloo "
                "that collective cannot be captured into the step's CUDA "
                "graph. Run it over NCCL, or train it with the Trainer")
        with torch.no_grad():
            for _, t in list(self.block.named_parameters()) + \
                    list(self.block.named_buffers()):
                _coll.broadcast_(t.data)
        for g in self._replicated_generators():
            st = g.get_state()
            if _dist.backend() == 'nccl':
                g.set_state(_coll.broadcast_(st.to(self.device)).cpu())
            else:
                g.set_state(_coll.broadcast_(st))

    def _replicated_generators(self):
        """The generators modules mark ``generator_replicated`` (the
        device's default one where such a module has none), once each;
        raises where one of them also feeds a module's per-rank dropout."""
        shared, per_rank = {}, {}
        default = torch.cuda.default_generators[self.device.index or 0] \
            if self.device.type == 'cuda' else torch.default_generator
        for m in self.block.modules():
            if not hasattr(m, 'generator'):
                continue
            g = default if m.generator is None else m.generator
            if getattr(m, 'generator_replicated', False):
                shared[id(g)] = g
            elif getattr(m, '_rate', 0):
                per_rank[id(g)] = m
        both = set(shared) & set(per_rank)
        if both:
            raise MXNetError(
                f"ShardedTrainStep: one generator feeds the attention "
                f"seeds, which every rank draws alike, and the per-rank "
                f"dropout of {type(per_rank[both.pop()]).__name__}; under "
                f"dp they need separate streams (models.bert."
                f"dp_generators)")
        return list(shared.values())

    def _build_dp(self, shapes):
        """The buffers of the dp step: f32 gradients (the ZeRO dim first),
        the reduce-scattered shards, the gather staging, and LAMB's
        per-shard sums of squares."""
        dp, dev = self._dp, self.device
        self._gbuf, self._gshard, self._gather_stage = {}, {}, {}
        for n, p in self._trainable:
            d = self._zdim.get(n)
            moved = shapes[n] if d is None else \
                (shapes[n][d],) + shapes[n][:d] + shapes[n][d + 1:]
            self._gbuf[n] = torch.zeros(moved, dtype=torch.float32,
                                        device=dev)
            if d is not None:
                self._gshard[n] = torch.zeros(
                    (moved[0] // dp,) + moved[1:], dtype=torch.float32,
                    device=dev)
                self._gather_stage[n] = torch.empty(
                    (dp, moved[0] // dp) + moved[1:], dtype=p.dtype,
                    device=dev)
        self._gs = [self._gshard.get(n, self._gbuf[n])
                    for n, _ in self._trainable]
        self._sharded_idx = [i for i, (n, _) in enumerate(self._trainable)
                             if n in self._zdim]
        self._sharded_at = torch.tensor(self._sharded_idx, dtype=torch.int64,
                                        device=dev)
        self._sq = torch.zeros(2, max(1, len(self._sharded_idx)),
                               dtype=torch.float32, device=dev)

    # ------------------------------------------------------------------
    def _train_flags(self):
        prev = (self.block.training, state.is_training)
        # layers read the module flag, nd ops autograd's (as the JAX step
        # sets it around the forward and the loss)
        self.block.train()
        state.is_training = True
        return prev

    def _restore_flags(self, prev):
        self.block.train(prev[0])
        state.is_training = prev[1]

    def _step(self, inputs, labels):
        """Forward, loss, gradients and update on the given tensors (one
        device); returns the loss. Allocates nothing that outlives it and
        reads the rate from the device scalar, so it can be captured."""
        params = [p for _, p in self._trainable]
        prev = self._train_flags()
        try:
            with torch.enable_grad(), plain_calls():
                out = self.block(*inputs)
                outs = out if isinstance(out, (list, tuple)) else (out,)
                loss = self.loss_fn(*outs, *labels).mean()
                grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            self._restore_flags(prev)
        with torch.no_grad():
            gs = [g.to(torch.float32) if g is not None else
                  torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for g, p in zip(grads, params)]
            if self._t is not None:
                self._t.add_(1)
            self._opt_update(self._p32, gs, self._slots, self._lr.values[0],
                             self._t_now(), **self.optimizer_params)
            if self._low:
                torch._foreach_copy_([p for p, _ in self._low],
                                     [m for _, m in self._low])
        return loss.detach()

    def _t_now(self):
        # every parameter's count moves together: the first one is t
        return None if self._t is None else self._t[0]

    # -- the dp step, in the segments its capture splits into ----------
    def _dp_forward(self, inputs):
        """Segment 1: the forward on this rank's rows; its outputs."""
        prev = self._train_flags()
        try:
            with torch.enable_grad(), plain_calls(), \
                    _coll.data_axis(self.dp_axis):
                out = self.block(*inputs)
        finally:
            self._restore_flags(prev)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    def _dp_gather(self, outs, labels, gouts, glabs):
        """Segment 2: every rank's outputs and labels, in rank order, into
        ``gouts`` / ``glabs`` (each (dp, local...))."""
        with torch.no_grad():
            for buf, o in zip(gouts + glabs, list(outs) + list(labels)):
                _coll.all_gather_into(buf, o.detach())

    def _dp_backward(self, outs, gouts, glabs):
        """Segment 3: the loss over the global batch, its gradient's slice
        for this rank's outputs, the backward into the f32 gradient
        buffers; returns the loss."""
        dp, r = self._dp, self.mesh.rank
        params = [p for _, p in self._trainable]
        leaves = [g.reshape((-1,) + tuple(g.shape[2:])).detach()
                  .requires_grad_(g.is_floating_point()) for g in gouts]
        labs = [g.reshape((-1,) + tuple(g.shape[2:])) for g in glabs]
        prev = self._train_flags()
        try:
            with torch.enable_grad(), plain_calls():
                loss = self.loss_fn(*leaves, *labs).mean()
                diff = [i for i, o in enumerate(outs) if o.requires_grad]
                cots = torch.autograd.grad(
                    loss, [leaves[i] for i in diff], allow_unused=True)
                mine = []
                for i, c in zip(diff, cots):
                    b = outs[i].shape[0]
                    mine.append(torch.zeros_like(outs[i]) if c is None
                                else c.narrow(0, r * b, b) * dp)
                grads = torch.autograd.grad(
                    [outs[i] for i in diff], params, grad_outputs=mine,
                    allow_unused=True)
        finally:
            self._restore_flags(prev)
        with torch.no_grad():
            for (n, _), g in zip(self._trainable, grads):
                buf = self._gbuf[n]
                if g is None:
                    buf.zero_()
                else:
                    d = self._zdim.get(n)
                    buf.copy_(g if d is None else g.movedim(d, 0))
        return loss.detach()

    def _dp_reduce(self):
        """Segment 4: gradients summed over the world, reduce-scattered
        into this rank's shard or all-reduced where replicated."""
        with torch.no_grad():
            for n, _ in self._trainable:
                if n in self._gshard:
                    _coll.reduce_scatter_into(self._gshard[n], self._gbuf[n])
                else:
                    _coll.all_reduce_(self._gbuf[n])

    def _dp_update_phases(self):
        """Segment 5 as functions between which a collective runs: the
        update, or LAMB's direction, its sums-of-squares all-reduce, and
        its step."""
        kw = self.optimizer_params
        lr = self._lr.values[0]

        def grads():
            gs = torch._foreach_mul(self._gs, 1.0 / self._dp)
            if self._t is not None:
                self._t.add_(1)
            return gs

        def writeback():
            if self._low:
                torch._foreach_copy_([p for p, _ in self._low],
                                     [m for _, m in self._low])

        if self._opt_update is not _lamb_update:
            def update():
                with torch.no_grad():
                    self._opt_update(self._p32, grads(), self._slots, lr,
                                     self._t_now(), **kw)
                    writeback()
            return [update], []

        held = {}

        def direction():
            with torch.no_grad():
                upd = _lamb_direction(self._p32, grads(), self._slots,
                                      self._t_now(), **kw)
                held['upd'] = upd
                idx = self._sharded_idx
                if idx:
                    self._sq[0].copy_(torch.stack(torch._foreach_norm(
                        [self._p32[i] for i in idx])).square())
                    self._sq[1].copy_(torch.stack(torch._foreach_norm(
                        [upd[i] for i in idx])).square())

        def reduce_norms():
            with torch.no_grad():
                if self._sharded_idx:
                    _coll.all_reduce_(self._sq)

        def step():
            with torch.no_grad():
                upd = held['upd']
                r1 = torch.stack(torch._foreach_norm(self._p32))
                r2 = torch.stack(torch._foreach_norm(upd))
                idx = self._sharded_idx
                if idx:
                    at, n = self._sharded_at, len(idx)
                    r1 = r1.index_copy(0, at, self._sq[0, :n].sqrt())
                    r2 = r2.index_copy(0, at, self._sq[1, :n].sqrt())
                _lamb_apply(self._p32, upd, r1, r2, lr)
                writeback()
        return [direction, step], [reduce_norms]

    def _dp_gather_params(self):
        """Segment 6: every parameter whole again from its shards."""
        with torch.no_grad():
            for n, p in self._trainable:
                d = self._zdim.get(n)
                if d is None:
                    continue
                stage = self._gather_stage[n]
                _coll.all_gather_into(stage, self._local(n, p))
                p.detach().movedim(d, 0).copy_(
                    stage.reshape((-1,) + tuple(stage.shape[2:])))

    def _gather_buffers(self, outs, labels):
        return ([o.new_empty((self._dp,) + tuple(o.shape)) for o in outs],
                [x.new_empty((self._dp,) + tuple(x.shape)) for x in labels])

    def _step_dp(self, inputs, labels):
        """The whole dp step, eagerly; returns the loss."""
        outs = self._dp_forward(inputs)
        gouts, glabs = self._gather_buffers(outs, labels)
        self._dp_gather(outs, labels, gouts, glabs)
        loss = self._dp_backward(outs, gouts, glabs)
        self._dp_reduce()
        phases, between = self._dp_update_phases()
        for i, ph in enumerate(phases):
            ph()
            if i < len(between):
                between[i]()
        self._dp_gather_params()
        return loss

    # ------------------------------------------------------------------
    def __call__(self, inputs, labels, lr=None):
        nd_in = any(isinstance(x, NDArray) for x in _as_list(inputs))
        with _trace.span('step.dispatch', step=self._step_count):
            inputs = [self._cast(_as_tensor(x)) for x in _as_list(inputs)]
            labels = [_as_tensor(x) for x in _as_list(labels)]
            if self._trainable is None:
                with _trace.span('optimizer.state_init'):
                    self._place_deferred(inputs)
                    self._build()
            self._lr.write([self.lr if lr is None else lr])
            if self.device.type != 'cuda':
                with _trace.span('step.compiled'), \
                        _memory.oom_guard('step.dispatch'):
                    ins = [x.to(self.device) for x in inputs]
                    labs = [x.to(self.device) for x in labels]
                    loss = self._step_dp(ins, labs) if self._dp > 1 else \
                        self._step(ins, labs)
            else:
                loss = self._replay(inputs, labels)
        self._step_count += 1
        self._record_comm()
        _memory.on_step(self._step_count)
        _flight.record_step(self._step_count, loss=loss)
        return NDArray(loss) if nd_in else loss

    def _cast(self, x):
        if self._input_dtype is not None and x.is_floating_point() and \
                x.dtype != self._input_dtype:
            return x.to(self._input_dtype)
        return x

    def _place_deferred(self, inputs):
        """One forward in predict mode, without gradients, places the
        parameters whose shapes wait for an input (Gluon's deferred
        initialisation)."""
        if not any(isinstance(p, UninitializedParameter)
                   for p in self.block.parameters()):
            return
        prev = self.block.training
        try:
            with torch.no_grad(), plain_calls():
                self.block.eval()(*[x.to(self.device) for x in inputs])
        finally:
            self.block.train(prev)

    def _replay(self, inputs, labels):
        sig = tuple((tuple(x.shape), x.dtype) for x in inputs) + \
            (len(inputs),) + tuple((tuple(x.shape), x.dtype) for x in labels)
        entry = self._graphs.get(sig)
        if entry is None:
            site = 'step:train_step'
            cctx = _compile.begin(site)
            t0 = time.perf_counter()
            try:
                with _trace.span('h2d.batch_put'):
                    ins = [x.to(self.device).clone() for x in inputs]
                    labs = [x.to(self.device).clone() for x in labels]
                with _trace.span('step.compiled'), \
                        _memory.oom_guard('step.dispatch'):
                    entry, first = self._capture_dp(ins, labs) \
                        if self._dp > 1 else self._capture_one(ins, labs)
            except BaseException:
                _compile.abort(cctx)
                raise
            if cctx is not None:
                _compile.set_signature(cctx, _compile.signature(
                    [_compile.array_sig(f'input{i}', x)
                     for i, x in enumerate(ins)] +
                    [_compile.array_sig(f'label{i}', x)
                     for i, x in enumerate(labs)],
                    {'optimizer': self._opt_update.__name__,
                     'params': len(self._trainable)}))
                _compile.end(cctx)
            elif _telem['on']:
                _metrics.record_compile(site, repr(sig),
                                        time.perf_counter() - t0)
            self._graphs[sig] = entry
            return first
        with _trace.span('h2d.batch_put'):
            for buf, x in zip(entry['ins'] + entry['labs'], inputs + labels):
                buf.copy_(x, non_blocking=True)
        with _trace.span('step.compiled'), \
                _memory.oom_guard('step.dispatch'):
            entry['run']()
        return entry['loss'].clone()

    def _capture_one(self, ins, labs):
        """dp = 1: the whole step, one graph."""
        graph, loss, first = capture(
            lambda: self._step(ins, labs), self.device,
            graph_generators(self.block, self.device), warm_up=True)
        return dict(ins=ins, labs=labs, loss=loss, run=graph.replay), first

    def _capture_dp(self, ins, labs):
        """dp > 1: the eager step on the side stream (this call's step),
        then a graph per segment between the collectives, all captured
        on that stream so the backward's graph continues the forward's
        autograd graph (see the module docstring)."""
        stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            first = self._step_dp(ins, labs)
        gens = graph_generators(self.block, self.device)
        fwd, outs, _ = capture(lambda: self._dp_forward(ins), self.device,
                               gens, stream=stream)
        gouts, glabs = self._gather_buffers(outs, labs)
        bwd, loss, _ = capture(
            lambda: self._dp_backward(outs, gouts, glabs), self.device,
            stream=stream)
        phases, between = self._dp_update_phases()
        upd = [capture(ph, self.device, stream=stream)[0] for ph in phases]

        def run():
            fwd.replay()
            self._dp_gather(outs, labs, gouts, glabs)
            bwd.replay()
            self._dp_reduce()
            for i, g in enumerate(upd):
                g.replay()
                if i < len(between):
                    between[i]()
            self._dp_gather_params()
        return dict(ins=ins, labs=labs, loss=loss, run=run), first

    # -- comm accounting (the JAX step's analytic ring model) ----------
    def _plan_comm(self):
        """``_hop_plan``: {(kind, axis): (ring wire bytes, count)} one
        step moves, by the JAX step's formulas: a ZeRO tensor's
        reduce-scatter and all-gather move (dp-1)/dp of its bytes each,
        a replicated one's all-reduce twice that, counted at the
        parameter's own dtype."""
        dp, ring = self._dp, _ring(self._dp)
        plan = {}

        def add(kind, nbytes):
            b, c = plan.get((kind, self.dp_axis), (0.0, 0))
            plan[(kind, self.dp_axis)] = (b + nbytes, c + 1)

        for n, p in self._trainable:
            nbytes = p.numel() * p.element_size()
            if self.zero_specs.get(n) is not None:
                add('all_gather', ring * nbytes)
                add('reduce_scatter', ring * nbytes)
            elif dp > 1:
                add('all_reduce', 2 * ring * nbytes)
        self._hop_plan = plan

    def _record_comm(self):
        if not self._hop_plan:
            return
        if _trace.enabled():
            for (kind, axis), (nbytes, count) in self._hop_plan.items():
                _trace.instant(f'comm.{kind}', bytes=int(nbytes),
                               count=count, axis=axis,
                               stage=self._zero_label)
        if _telem['on']:
            for (kind, axis), (nbytes, count) in self._hop_plan.items():
                _metrics.counter('mxnet_tpu_comm_collective_bytes_total').inc(
                    nbytes, kind=kind, axis=axis, stage=self._zero_label)
                _metrics.counter('mxnet_tpu_comm_collectives_total').inc(
                    count, kind=kind, axis=axis, stage=self._zero_label)

    def comm_bytes_per_hop(self):
        """Analytic ring-wire bytes one step moves, by mesh hop:
        ``{axis: bytes}`` (one ``dp`` hop: the port's topology is flat)."""
        hops = {}
        for (_kind, axis), (nbytes, _c) in self._hop_plan.items():
            hops[axis] = hops.get(axis, 0) + int(nbytes)
        return hops

    # ------------------------------------------------------------------
    def opt_state_bytes_per_device(self):
        """Bytes of optimizer state (moments, masters, one update count
        per parameter) this rank holds: under ZeRO ~1/dp of the
        replicated footprint, plus the tensors too small to shard."""
        total = sum(s.numel() * s.element_size()
                    for st in (self._state or {}).values() for s in st)
        total += sum(m.numel() * m.element_size()
                     for m in (self._master or {}).values())
        if self._t is not None:
            total += self._t.numel() * self._t.element_size()
        return total

    def param_bytes_per_device(self):
        """Bytes of the block's parameters in their own dtypes (each rank
        holds them whole)."""
        return sum(p.numel() * p.element_size()
                   for p in self.block.parameters())

    def memory_pools(self):
        """This step's live tensors as named residency pools
        (``telemetry.memory``): params, optimizer_state."""
        pools = {'params': {}, 'optimizer_state': {}}
        for n, p in self.block.named_parameters():
            pools['params'][n] = p
        for n, m in (self._master or {}).items():
            pools['optimizer_state'][f'master/{n}'] = m
        for n, st in (self._state or {}).items():
            for i, s in enumerate(st):
                pools['optimizer_state'][f'moment{i}/{n}'] = s
        if self._t is not None:
            pools['optimizer_state']['t'] = self._t
        return pools

    def memory_analysis(self, peak_bytes=None):
        """Per-device memory attribution, the JAX step's bucket table:
        params / optimizer_state / residuals / io_leases /
        activations_temp, where activations_temp is the peak (the
        allocator's, else the fallback watermark's) minus the tracked
        pools. None before the first step."""
        if self._trainable is None:
            return None
        pools = self.memory_pools()
        buckets = {
            'params': _memory.pool_nbytes(pools['params']),
            'optimizer_state': _memory.pool_nbytes(pools['optimizer_state']),
            'residuals': 0,
            'io_leases': 0,
        }
        persistent = sum(buckets.values())
        source = 'fallback'
        if peak_bytes is None:
            stats = _memory.device_memory_stats(self.device) \
                if self.device.type == 'cuda' else None
            if stats is not None and stats.get('peak_bytes_in_use'):
                peak_bytes = int(stats['peak_bytes_in_use'])
                source = 'memory_stats'
            else:
                peak_bytes = max(_memory.peak_bytes(), persistent)
        peak_bytes = max(int(peak_bytes), persistent)
        buckets['activations_temp'] = peak_bytes - persistent
        return {
            'peak_bytes_per_device': peak_bytes,
            'source': source,
            'buckets_bytes': buckets,
            'bucket_fractions': {
                k: round(v / peak_bytes, 4) if peak_bytes else 0.0
                for k, v in buckets.items()},
            'bucket_sum_over_peak':
                round(sum(buckets.values()) / peak_bytes, 4)
                if peak_bytes else 0.0,
            'measured_fraction':
                round(min(persistent, peak_bytes) / peak_bytes, 4)
                if peak_bytes else 0.0,
            'zero_stage': self.zero_stage,
            'dp': self._dp,
            'compression': None,
            'pad_bytes': 0,
            'host_rss_bytes': _memory.host_rss_bytes(),
        }

    # -- the states payload, gathered to logical tensors ----------------
    def _logical(self, n, x):
        """A master or moment of ``n`` as the whole logical tensor on the
        host (gathered from every rank's shard under ZeRO)."""
        d = self._zdim.get(n)
        if d is None:
            return x.detach().to('cpu', copy=True).numpy()
        buf = x.new_empty((self._dp,) + tuple(x.shape))
        _coll.all_gather_into(buf, x.detach())
        return buf.reshape((-1,) + tuple(x.shape[1:])).movedim(0, d) \
            .cpu().numpy()

    def _shard_of(self, n, a):
        """This rank's part of the logical host array ``a`` of ``n``, in
        the layout of its master and moments."""
        t = torch.from_numpy(onp.asarray(a, onp.float32))
        d = self._zdim.get(n)
        if d is None:
            return t
        s = t.shape[d] // self._dp
        return t.movedim(d, 0).narrow(0, self.mesh.rank * s, s)

    def get_states_bytes(self):
        """The optimizer state as the JAX step's ``sharded_train_step_v1``
        payload: {name: (moments..., t as an int32 array)} and the f32
        masters, all numpy in their logical shapes (gathered from the
        shards under ZeRO: a collective, called on every rank), keyed by
        structured parameter name (see ``rename_states`` for the JAX
        package's names)."""
        if self._trainable is None:
            if self._pending_states is not None:
                return pickle.dumps(self._pending_states)
            raise MXNetError("get_states_bytes: no optimizer state yet — "
                             "run at least one step first")
        counts = None if self._t is None else self._t.cpu().numpy()
        doc = {
            'format': STATES_FORMAT,
            'opt_state': {
                n: tuple(self._logical(n, s) for s in self._state[n]) +
                (() if counts is None else (onp.asarray(counts[i],
                                                        onp.int32),))
                for i, (n, _) in enumerate(self._trainable)},
            'master': {n: self._logical(n, m)
                       for n, m in self._master.items()},
            'step_count': self._step_count,
            'zero': self.zero, 'stage': self.zero_stage, 'dp': self._dp}
        return pickle.dumps(doc)

    def set_states_bytes(self, blob):
        """Restore a ``get_states_bytes`` payload (this package's at any
        dp, or, after ``rename_states``, the JAX step's) into the existing
        state tensors, each rank taking its shard, in place, so a
        captured graph stays valid."""
        doc = pickle.loads(blob)
        if doc.get('format') != STATES_FORMAT:
            raise MXNetError(f"set_states_bytes: not a ShardedTrainStep "
                             f"payload (format={doc.get('format')!r})")
        if self._trainable is None:
            self._pending_states = doc
            return
        self._apply_states(doc)

    def _apply_states(self, doc):
        counts = set()
        for n, st in doc['opt_state'].items():
            if n not in self._state:
                raise MXNetError(f"set_states_bytes: unknown parameter "
                                 f"{n!r} in restored optimizer state")
            st = list(st)
            if self._has_t:
                counts.add(int(onp.asarray(st.pop())))
            if len(st) != self._n_state:
                raise MXNetError(f"set_states_bytes: {n!r} holds "
                                 f"{len(st)} moments, this optimizer "
                                 f"{self._n_state}")
            for dst, src in zip(self._state[n], st):
                dst.copy_(self._shard_of(n, src))
        if len(counts) > 1:
            raise MXNetError(f"set_states_bytes: the parameters' update "
                             f"counts differ ({sorted(counts)}); this step "
                             f"moves them together")
        if counts:
            self._t.fill_(counts.pop())
        for n, m in doc.get('master', {}).items():
            if n in self._master:
                self._master[n].copy_(self._shard_of(n, m))
        self._step_count = int(doc.get('step_count', self._step_count))
