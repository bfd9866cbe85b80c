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

ZeRO-3 (``zero=3`` or ``MXTPU_ZERO=3``, at dp > 1): the parameters
themselves live sharded between steps, by the JAX step's
``zero3_layout`` (``zero3_layouts``): 'dim' (a dim that splits evenly,
or the one a ``param_specs`` entry shards over dp: the fsdp-style
layout) keeps only this rank's shard of the parameter, its master and
moments; 'flat' (nothing splits evenly) keeps the parameter whole and
its f32 store and moments as a padded 1-D shard; 'repl' (smaller than
dp) stays replicated. Each module's 'dim' parameters are one layer group
(``_Zero3``), all-gathered before its first use in the forward, each
gather chained behind the previous one, and freed after; a saved-tensor
hook keeps a gathered parameter out of autograd's residuals, so the
backward regathers it. The gradients are reduce-scattered into the
shards and the update is ZeRO-1's, on the shards; only the flat
parameters are gathered back. ``full_parameters()`` gathers every
parameter whole. On the card the stage-3 step runs eagerly, uncaptured
(``captured`` is False, ``stats()``): gloo cannot be captured, and a
gather sits before every layer group in the forward and the backward.
``param_specs`` naming dp is accepted at dp = 1 (where nothing shards)
and under ZeRO-3; at stage 0 or 1 with dp > 1 it raises.

Activation remat (``MXTPU_REMAT``, read at construction): 'layer' and
'aggressive' run each layer of the forward (``_remat_regions``: the
children of its sequential containers, BERT's encoder layers) under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
one layer at a time; 'layer' keeps the outputs of the products without
batch dims (``aten.mm``/``addmm``) and recomputes the rest, 'aggressive'
keeps only each layer's inputs. (The JAX step checkpoints the whole
forward; one region over the whole forward recomputes all of it when the
backward starts, so the peak does not drop, PERF.md.) The dropout
generators and the block's buffers are replayed across each recompute
(``_Recompute``), so the backward sees the masks, the attention seeds
and the running statistics the forward saw; under a CUDA graph through
generator twins registered with the graph. The policy, the ZeRO stage
and the flash-attention tile decisions are flags of the step's compile
signature (``signature``).

The non-finite guard (``guard=resilience.NonFiniteGuard(...)``), as the
JAX step fuses it into its program: each call first lets the guard read
the previous step's flag (``pre_step``, which may roll back to the last
checkpoint: the parameters, masters, moments and RNG are restored in
place, and this call's batch trains against them). Inside the step (one
CUDA graph at dp = 1) the parameters, masters, moments, the update count
and the block's buffers are copied aside before the forward, the flag is
the finiteness of the loss and of every f32 gradient (one
``_foreach_norm`` at inf, NaN and inf propagating) and, after the update,
each of those tensors becomes ``where(flag, new, old)``: a non-finite
step is a no-op on the device, its arithmetic otherwise untouched, so a
guarded run and an unguarded replay of its good steps agree bit for bit.
The flag is a one-element tensor on the device that the guard reads at
the next call (``bool`` of it waits for that step alone). At dp > 1 the
flag is taken over this rank's reduced (reduce-scattered) gradients in a
captured segment of its own and all-reduced (min) between the segments,
so every rank skips the same step. The ``step.dispatch`` fault site fires
on every call; armed (or under a guard) the loss is multiplied by a
device scalar, 1 or NaN (``step.dispatch:nan``), the JAX step's
``fault_scale``, and the multiply is part of the step's signature, so a
step with no guard and no fault armed runs exactly the kernels it ran
before.

Not ported, each refused by name: ``param_specs`` naming an axis other
than dp (tensor parallelism, ROADMAP queue 1 item 6a),
``compression_params`` and ``hierarchy``, and a dp axis over several
hosts, which the JAX step splits (item 8), sparse gradients (item 12).
"""
from __future__ import annotations

import contextlib
import pickle
import re
import time
import warnings

import numpy as onp
import torch
from torch.nn.parameter import UninitializedParameter

from .. import config as _config
from .. import random as _random
from ..resilience import faults as _faults
from .._capture import DeviceScalars, capture, graph_generators
from ..base import MXNetError, state, telem_flags as _telem, torch_dtype
from ..gluon.block import Block, plain_calls
from ..ndarray.ndarray import NDArray
from ..telemetry import compile as _compile, flight as _flight, \
    memory as _memory, metrics as _metrics, trace as _trace
from . import collectives as _coll, dist as _dist
from .mesh import make_mesh

__all__ = ['ShardedTrainStep', 'rename_states', 'STATES_FORMAT',
           'PartitionSpec', 'compose_zero_spec', 'zero3_layout']

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


def zero3_layout(shape, base_spec, dp_axis, dp_size):
    """Persistent ZeRO-3 layout of one parameter (the JAX step's rule,
    copied as it is). Returns a dict:

    - ``{'mode': 'dim', 'spec': P(...), 'gather_spec': P(...)}``: an
      exactly divisible free dim (or the dim the parameter's own spec
      shards over dp) shards over dp; the parameter, its master and its
      moments live as that 1/dp shard, and the gather restores
      ``gather_spec``;
    - ``{'mode': 'flat', 'size': s, 'padded': p, 'pad': p - s}``: no dim
      divides evenly; the f32 master and moments live as a 1-D buffer
      padded to a dp multiple and sharded, the compute-dtype parameter
      stays whole (never chosen for a parameter another axis shards);
    - ``{'mode': 'repl'}``: too small to shard; replicated.
    """
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))

    def _trim(entries):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    for s in spec:
        if s == dp_axis or (isinstance(s, (tuple, list)) and dp_axis in s):
            # proposed by the caller (fsdp-style): validate and keep
            compose_zero_spec(shape, base_spec, dp_axis, dp_size)
            gspec = [None if ss == dp_axis else
                     (tuple(a for a in ss if a != dp_axis) or None
                      if isinstance(ss, (tuple, list)) else ss)
                     for ss in spec]
            return {'mode': 'dim', 'spec': P(*spec),
                    'gather_spec': _trim(gspec)}
    composed = compose_zero_spec(shape, base_spec, dp_axis, dp_size)
    if composed is not None:
        return {'mode': 'dim', 'spec': composed,
                'gather_spec': _trim(spec)}
    size = int(onp.prod(shape)) if shape else 1
    if size >= dp_size and all(s is None for s in spec):
        padded = -(-size // dp_size) * dp_size
        return {'mode': 'flat', 'size': size, 'padded': padded,
                'pad': padded - size}
    return {'mode': 'repl'}


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


def _host_copy(t):
    """A tensor copied to a host numpy array now."""
    return t.detach().to('cpu', copy=True).numpy()


def _device_key(d):
    """A device with a CUDA index filled in: 'cuda' is the current card."""
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return d


def _ring(k):
    return (k - 1) / k if k > 1 else 0.0


# -- MXTPU_REMAT --------------------------------------------------------

# the products without batch dims (what a Dense layer's matmul reaches):
# 'layer' keeps their outputs, the counterpart of JAX's
# dots_with_no_batch_dims_saveable
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _layer_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat_regions(block):
    """The modules the forward is checkpointed by, one region each: the
    children of the block's sequential containers (``nn.Sequential``,
    ``ModuleList``, Gluon's ``(Hybrid)Sequential``: BERT's encoder layers,
    a ResNet stage's blocks), outermost first; the whole block where it
    has none. A region recomputes when the backward reaches it, so only
    one region's activations are live again at a time."""
    from ..gluon.nn.basic_layers import _Stack
    stacks = (torch.nn.Sequential, torch.nn.ModuleList, _Stack)
    regions, inside = [], set()
    for name, m in block.named_modules():
        if name in inside or any(name.startswith(p + '.') for p in inside):
            continue
        if isinstance(m, stacks):
            kids = list(m.children())
            regions += kids
            inside |= {f'{name}.{k}' if name else k
                       for k, _ in m.named_children()}
    return regions or [block]


class _Recompute:
    """What a recomputed region must find as its forward found it.

    The generators the block draws from (its modules' ``generator``s:
    hidden dropout, the attention seeds; the port's generator of the
    device and torch's default one): ``torch.utils.checkpoint`` restores
    only the default generators, so a recompute would draw new masks
    and a new attention seed, and the flash backward would differentiate
    attention under masks the loss never saw. Eagerly each region's
    forward saves their states (``get_state``) and its recompute sets
    them, then puts back what it found. Inside a CUDA-graph capture
    neither may be called; there each (region, generator) has a twin,
    made after the eager first step (which records, per region, how far
    each generator's Philox offset had moved since the forward began) and
    registered with the graph that runs the recompute. Before every
    replay ``sync`` gives each twin its generator's host state with that
    offset added, and the recompute points the generator at its twin's
    state (``graphsafe_set_state``) and back: the forward draws first in
    its graph, so the twin starts where the region's forward started.

    And the block's buffers and gradient-free parameters: a recompute of
    BatchNorm would update its running statistics a second time, so they
    are put back after it."""

    def __init__(self, block, device):
        gens = {}
        for m in block.modules():
            g = getattr(m, 'generator', None)
            if isinstance(g, torch.Generator):
                gens[id(g)] = g
        for g in (_random.generator(device),
                  torch.cuda.default_generators[device.index or 0]
                  if device.type == 'cuda' else torch.default_generator):
            gens.setdefault(id(g), g)
        # the device's: a draw elsewhere does not reach the kernels here
        self.gens = [g for g in gens.values()
                     if g.device.type == device.type]
        self._cuda = device.type == 'cuda'
        # running statistics: buffers, or parameters without gradient
        # (the port's BatchNorm keeps them as grad_req='null' Parameters)
        self.buffers = list(block.buffers()) + [
            p for p in block.parameters() if not p.requires_grad]
        self.twins = []          # per region: a twin of each generator
        self._twin_states = []
        self._offsets = []       # per region: each generator's offset moved
        self._saved = []         # per region: the generators' states
        self._base = None
        self._region = 0

    def make_twins(self):
        """The twins of the regions the eager step recorded, to register
        with the graph that captures the recompute (flattened)."""
        if not self.twins:
            self.twins = [[torch.Generator(g.device) for g in self.gens]
                          for _ in self._offsets]
            self._twin_states = [[t.graphsafe_get_state() for t in ts]
                                 for ts in self.twins]
        return [t for ts in self.twins for t in ts]

    def offsets(self):
        """What the last eager forward recorded: a graph captured after it
        keeps these (the offsets depend on the shapes drawn)."""
        return [list(o) for o in self._offsets]

    def sync(self, offsets):
        """Before a replay of a graph captured with ``offsets``: each twin
        takes its generator's host state, advanced to where its region's
        forward starts."""
        for ts, offs in zip(self.twins, offsets):
            for g, t, off in zip(self.gens, ts, offs):
                t.set_state(g.get_state())
                t.set_offset(g.get_offset() + off)

    @staticmethod
    def _capturing():
        return torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()

    def begin(self):
        """At the start of a forward: regions count from 0."""
        self._region = 0
        if self._cuda and not self._capturing():
            self._base = [g.get_offset() for g in self.gens]

    def next_region(self):
        r, self._region = self._region, self._region + 1
        return r

    @contextlib.contextmanager
    def forward(self, r):
        if not self._capturing():
            states = [g.get_state() for g in self.gens]
            offs = [g.get_offset() - b for g, b in
                    zip(self.gens, self._base)] if self._cuda else None
            if r < len(self._saved):
                self._saved[r], self._offsets[r] = states, offs
            else:
                self._saved.append(states)
                self._offsets.append(offs)
        yield

    @contextlib.contextmanager
    def recompute(self, r):
        kept = [b.detach().clone() for b in self.buffers]
        graph = self._capturing()
        if graph:
            found = [g.graphsafe_get_state() for g in self.gens]
            for g, t in zip(self.gens, self._twin_states[r]):
                g.graphsafe_set_state(t)
        else:
            found = [g.get_state() for g in self.gens]
            for g, st in zip(self.gens, self._saved[r]):
                g.set_state(st)
        try:
            yield
        finally:
            for g, st in zip(self.gens, found):
                if graph:
                    g.graphsafe_set_state(st)
                else:
                    g.set_state(st)
            with torch.no_grad():
                for b, k in zip(self.buffers, kept):
                    b.copy_(k)


@contextlib.contextmanager
def _both(a, b):
    """Two context managers entered as one (``checkpoint``'s context_fn
    returns one for the forward and one for the recompute)."""
    with a, b:
        yield


# -- ZeRO-3 --------------------------------------------------------------

class _Gathered:
    """What the saved-tensor hook keeps of a gathered parameter: its
    name and the view autograd saved, never its storage."""

    __slots__ = ('name', 'size', 'stride', 'offset')

    def __init__(self, name, t):
        self.name, self.size = name, tuple(t.size())
        self.stride, self.offset = tuple(t.stride()), t.storage_offset()


class _Zero3:
    """ZeRO-3's parameter shards and per-layer gathers for one step.

    Each parameter of layout 'dim' keeps, between steps, only this rank's
    shard (``shard``: compute dtype, the shard dim first); its own tensor
    keeps its shape but no storage (``untyped_storage().resize_(0)``), so
    the module and autograd still see the same leaf. The parameters are
    grouped by the module that owns them (``groups``, in module order). A
    forward pre-hook on each owner's parent (which may read a child's
    weights without calling the child, as ``BertLayer`` reads
    ``ffn1.weight``) and on the owner itself gathers its groups, one
    all-gather of the group's concatenated shards each, every gather
    chained behind the previous one (``collectives.ordered_barrier``), and
    the parent's post-hook frees them again. A saved-tensor hook (``pack``
    / ``unpack``, active around the forward) keeps a gathered parameter
    that autograd saves as its name and view, never its storage, and the
    backward regathers it on unpack; under remat the recompute's
    pre-hooks regather. Nothing is freed during the backward (a
    recompute keeps references to what it gathered); the step frees
    every group after it."""

    def __init__(self, step, named, dims):
        self.dp, self.rank = step._dp, step.mesh.rank
        self.params = {n: p for n, p in named if n in dims}
        self.dims = dims
        self.shard = {}
        for n, p in self.params.items():
            st = p.untyped_storage()
            if p.storage_offset() or st.nbytes() != p.numel() * \
                    p.element_size() or not p.is_contiguous():
                raise MXNetError(
                    f"ShardedTrainStep: ZeRO-3 frees the storage of {n!r} "
                    f"between steps, but it shares its storage with "
                    f"another tensor")
            d = dims[n]
            rows = p.shape[d] // self.dp
            # a copy: the parameter's own storage is freed below
            self.shard[n] = p.detach().movedim(d, 0).narrow(
                0, self.rank * rows, rows).clone(
                    memory_format=torch.contiguous_format)
        owner = {}
        for mname, m in step.block.named_modules():
            for pname, _ in m.named_parameters(recurse=False):
                full = f'{mname}.{pname}' if mname else pname
                if full in self.params:
                    owner[full] = mname
        order = [m for m, _ in step.block.named_modules()]
        self.groups = [(m, sorted(n for n in self.params if owner[n] == m))
                       for m in order if m in set(owner.values())]
        self.group_of = {n: i for i, (_, ns) in enumerate(self.groups)
                         for n in ns}
        self.resident = set()
        self.ptr = {}            # storage address -> parameter name
        self.in_backward = False
        self._token = None
        self.gathers, self.gather_s = 0, 0.0
        mods = dict(step.block.named_modules())
        triggers = {}
        for i, (m, _) in enumerate(self.groups):
            parent = m.rsplit('.', 1)[0] if '.' in m else ''
            for t in {parent, m}:
                triggers.setdefault(t, []).append(i)
        # id(module) -> the groups its pre-hook gathers
        self._triggers = {id(mods[t]): idx for t, idx in triggers.items()}
        self._hooks = []
        for t, idx in triggers.items():
            mod = mods[t]
            self._hooks.append(mod.register_forward_pre_hook(
                lambda *_a, idx=idx: self.gather_groups(idx)))
            own = [i for i in idx if self.groups[i][0] != t]
            if own:
                self._hooks.append(mod.register_forward_hook(
                    lambda *_a, own=own: self.release(own)))
        for i in range(len(self.groups)):
            self.free(i)

    def gather_groups(self, idx):
        for i in idx:
            self.gather(i)

    def triggered_by(self, module):
        return self._triggers.get(id(module), ())

    def release(self, idx):
        if not self.in_backward:
            for i in idx:
                self.free(i)

    def gather(self, i):
        if i in self.resident:
            return
        # outside any dispatch mode: the selective checkpoint ('layer'
        # remat) counts the ops of its region, and a recompute finds its
        # groups resident where the forward gathered them
        from torch.utils._python_dispatch import _disable_current_modes
        t0 = time.perf_counter()
        names = self.groups[i][1]
        with torch.no_grad(), _disable_current_modes():
            for dtype in sorted({self.params[n].dtype for n in names},
                                key=str):
                ns = [n for n in names if self.params[n].dtype == dtype]
                flat = [self.shard[n].reshape(-1) for n in ns]
                if self._token is not None:
                    flat = list(_coll.ordered_barrier(
                        *flat, self._token))[:-1]
                flat = torch.cat(flat)
                stage = flat.new_empty((self.dp, flat.numel()))
                _coll.all_gather_into(stage, flat)
                self.gathers += 1
                off = 0
                for n in ns:
                    p, sh = self.params[n], self.shard[n]
                    k = sh.numel()
                    full = stage[:, off:off + k].reshape(
                        (self.dp * sh.shape[0],) + tuple(sh.shape[1:]))
                    st = p.data.untyped_storage()
                    st.resize_(p.numel() * p.element_size())
                    p.data.movedim(self.dims[n], 0).copy_(full)
                    self.ptr[st.data_ptr()] = n
                    off += k
                self._token = self.params[ns[0]].data
        self.resident.add(i)
        self.gather_s += time.perf_counter() - t0

    def free(self, i):
        for n in self.groups[i][1]:
            st = self.params[n].data.untyped_storage()
            self.ptr.pop(st.data_ptr(), None)
            st.resize_(0)
        self.resident.discard(i)

    def free_all(self):
        for i in list(self.resident):
            self.free(i)
        self._token = None

    def pack(self, t):
        ptr = t.untyped_storage().data_ptr()
        n = self.ptr.get(ptr) if ptr else None
        return t if n is None else _Gathered(n, t)

    def unpack(self, x):
        if not isinstance(x, _Gathered):
            return x
        self.gather(self.group_of[x.name])
        return self.params[x.name].data.as_strided(x.size, x.stride,
                                                   x.offset)

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)

    def reset_stats(self):
        self.gathers, self.gather_s = 0, 0.0

    def full(self, n):
        """Parameter ``n`` whole (a collective, on every rank)."""
        sh = self.shard[n]
        stage = sh.new_empty((self.dp,) + tuple(sh.shape))
        _coll.all_gather_into(stage, sh)
        return stage.reshape((-1,) + tuple(sh.shape[1:])).movedim(
            0, self.dims[n])


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
        # resilience.NonFiniteGuard: the flag and the where-gating go
        # inside the step; a rollback's restore writes in place
        self._guard = guard
        if guard is not None:
            guard.add_post_restore_hook(self._after_restore)
        for pat, spec in (param_specs or {}).items():
            axes = _spec_axes(spec)
            if axes - {dp_axis}:
                raise MXNetError(
                    f"ShardedTrainStep: param_specs {pat!r} -> {spec!r} "
                    f"names {sorted(axes - {dp_axis})}: tensor "
                    f"parallelism is not ported (ROADMAP queue 1 item 6a)")
        self.param_specs = dict(param_specs or {})
        if zero is None:
            zero = _config.get('MXTPU_ZERO')
        stage = int(zero) if not isinstance(zero, bool) else int(bool(zero))
        if stage not in (0, 1, 3):
            raise MXNetError(f"zero={zero!r}: supported ZeRO stages are 0, "
                             f"1 and 3 (stage 2 has no meaning of its own: "
                             f"gradients already reduce-scatter under 1)")
        # read once, so the signature and the forward agree for the
        # step's lifetime (as the JAX step reads it)
        self._remat_policy = _config.get('MXTPU_REMAT')
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
        self._zero_label = {0: 'off', 1: 'zero1', 3: 'zero3'}[
            self.zero_stage]
        # gloo cannot be captured, and ZeRO-3 gathers before every layer
        # group in the forward and the backward: it runs eagerly
        self.captured = self.zero_stage != 3
        self._z3 = None              # _Zero3, at stage 3
        self._recompute = None       # _Recompute, under MXTPU_REMAT
        self._regions = []           # the modules it checkpoints
        self.zero3_layouts = {}
        self.opt_state_pad_bytes = 0
        self._trainable = None       # [(name, parameter)], sorted by name
        self._master = None          # name -> f32 master (a shard under ZeRO)
        self._state = None           # name -> tuple of f32 state tensors
        self._t = None               # update counts, one int32 per parameter
        self._lr = None              # DeviceScalars: this step's rate and
        #                              the loss's fault factor (1 or NaN)
        self._scaled = False         # this call multiplies the loss by it
        self._gate = None            # guard: resilience.guard.DeviceGate
        self._ptrs = {}              # guard: each parameter's storage
        self._graphs = {}            # signature -> the captured step
        self._step_count = 0
        self._pending_states = None  # a restored payload awaiting the build
        self._hop_plan = {}          # (kind, axis) -> (bytes, count) a step
        self._gather_plan = []       # ZeRO-3: (layer group, bytes, gathers)
        self.zero_specs = {}

    # ------------------------------------------------------------------
    def _build(self):
        named = sorted(self.block.named_parameters())
        self._trainable = [(n, p) for n, p in named if p.requires_grad]
        dp = self._dp
        if dp > 1:
            self._sync_world()
        shapes = {n: tuple(p.shape) for n, p in self._trainable}
        specs = self._resolve_param_specs([n for n, _ in named])
        if self.zero_stage == 3:
            self.zero3_layouts = {
                n: zero3_layout(shapes[n], specs[n], self.dp_axis, dp)
                for n in shapes}
            self.zero_specs = {n: lay['spec'] if lay['mode'] == 'dim'
                               else None
                               for n, lay in self.zero3_layouts.items()}
        else:
            sharded = [n for n in shapes if self.dp_axis in
                       _spec_axes(specs[n])]
            if dp > 1 and sharded:
                raise MXNetError(
                    f"ShardedTrainStep: param_specs shard {sharded[:3]} "
                    f"over {self.dp_axis!r} between steps, ZeRO-3's "
                    f"layout: pass zero=3")
            self.zero_specs = {
                n: compose_zero_spec(shapes[n], specs[n], self.dp_axis, dp)
                if self.zero else None for n in shapes}
        # name -> the dim its master and moments shard along (ZeRO), and
        # the ZeRO-3 parameters kept as a padded flat f32 shard
        self._zdim = {n: list(sp).index(self.dp_axis)
                      for n, sp in self.zero_specs.items() if sp is not None}
        self._flat = {n: lay for n, lay in self.zero3_layouts.items()
                      if lay['mode'] == 'flat'}
        if self.zero_stage == 3:
            if len(dict(self.block.named_parameters(
                    remove_duplicate=False))) != len(named):
                raise MXNetError("ShardedTrainStep: ZeRO-3 shards each "
                                 "parameter under its owning module; the "
                                 "block registers one parameter twice")
            self._z3 = _Zero3(self, self._trainable, self._zdim)
        if self._remat_policy != 'none':
            self._recompute = _Recompute(self.block, self.device)
            self._regions = _remat_regions(self.block)
        low = {n for n, p in self._trainable
               if p.is_floating_point() and p.element_size() < 4}
        # a flat ZeRO-3 parameter's f32 store is its master, whatever its
        # dtype (the JAX step's master_names)
        self._master = {n: self._local(n, p).to(torch.float32).clone()
                        for n, p in self._trainable
                        if n in low or n in self._flat}
        self._state = {n: tuple(torch.zeros(self._local(n, p).shape,
                                            dtype=torch.float32,
                                            device=self.device)
                                for _ in range(self._n_state))
                       for n, p in self._trainable}
        self._t = torch.zeros(len(self._trainable), dtype=torch.int32,
                              device=self.device) if self._has_t else None
        self._lr = DeviceScalars(2, self.device)
        self._p32 = [self._master[n] if n in self._master
                     else self._local(n, p) for n, p in self._trainable]
        self._slots = [[self._state[n][k] for n, _ in self._trainable]
                       for k in range(self._n_state)]
        self._low = [(self._local(n, p), self._master[n])
                     for n, p in self._trainable
                     if n in self._master and n not in self._flat]
        if dp > 1:
            self._build_dp(shapes)
        if self._guard is not None:
            self._build_guard()
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

    def _build_guard(self):
        """The guard's gate over the tensors a skipped step must leave as
        they were: the f32 weights and masters, the moments, the update
        count, the low-precision parameters or this rank's shards of them,
        the block's buffers and gradient-free parameters."""
        from ..resilience.guard import DeviceGate
        self._gate = DeviceGate(
            list(self._p32) + [s for slot in self._slots for s in slot] +
            ([self._t] if self._t is not None else []) +
            [p for p, _ in self._low] + list(self.block.buffers()) +
            [p.detach() for p in self.block.parameters()
             if not p.requires_grad], self.device)
        self._ptrs = {n: p.data_ptr() for n, p in self._trainable}

    def _after_restore(self):
        """After a guard rollback's restore. The JAX step re-places the
        restored host arrays on its mesh; here the restore wrote into the
        step's own tensors in place (``load_full_parameters``,
        ``set_states_bytes``), which the captured graphs read, so what is
        left is to refuse a restore that swapped a parameter's tensor."""
        if self._trainable is None or self._z3 is not None:
            return
        moved = [n for n, p in self._trainable
                 if p.data_ptr() != self._ptrs.get(n, p.data_ptr())]
        if moved:
            raise MXNetError(
                f"ShardedTrainStep: a restore replaced the tensors of "
                f"{moved[:3]}; the step updates its parameters in place "
                f"(restore through CheckpointManager(params=step.block, "
                f"trainer=step))")

    def _resolve_param_specs(self, names):
        """name -> PartitionSpec: a ``param_specs`` key matches a parameter
        by exact name or as a regular expression (``re.search``), the last
        matching key winning, as the JAX step matches them."""
        mapping = {n: P() for n in names}
        for pat, spec in self.param_specs.items():
            hits = [n for n in names
                    if n == pat or re.search(str(pat), n) is not None]
            if not hits:
                warnings.warn(f"ShardedTrainStep: param_spec {pat!r} matched "
                              f"no parameter (have e.g. {names[:5]})",
                              RuntimeWarning)
            for n in hits:
                mapping[n] = P(*spec) if isinstance(spec, (tuple, list)) \
                    else P(spec)
        return mapping

    def _local(self, n, p):
        """Parameter ``n``'s part this rank updates: the whole tensor; under
        ZeRO-1 a view of its shard, the ZeRO dim moved first; under ZeRO-3
        the kept shard, or a flat parameter's padded f32 slice."""
        if self._z3 is not None and n in self._z3.shard:
            return self._z3.shard[n]
        if n in self._flat:
            lay = self._flat[n]
            k = lay['padded'] // self._dp
            flat = torch.nn.functional.pad(
                p.detach().reshape(-1).to(torch.float32), (0, lay['pad']))
            return flat.narrow(0, self.mesh.rank * k, k)
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
        """The buffers of the dp step: the reduce-scattered f32 gradient
        shards; f32 gradients whole (the ZeRO dim first) where the capture
        needs them (every tensor under ZeRO-1, the replicated ones under
        ZeRO-3, whose step runs eagerly); the gather staging; and LAMB's
        per-shard sums of squares."""
        dp, dev = self._dp, self.device
        stage3 = self.zero_stage == 3
        self._gbuf, self._gshard, self._gather_stage = {}, {}, {}
        for n, p in self._trainable:
            d = self._zdim.get(n)
            moved = shapes[n] if d is None else \
                (shapes[n][d],) + shapes[n][:d] + shapes[n][d + 1:]
            if n in self._flat:
                self._gshard[n] = torch.zeros(
                    self._flat[n]['padded'] // dp, dtype=torch.float32,
                    device=dev)
                continue
            if d is not None:
                self._gshard[n] = torch.zeros(
                    (moved[0] // dp,) + moved[1:], dtype=torch.float32,
                    device=dev)
                if stage3:
                    continue
                self._gather_stage[n] = torch.empty(
                    (dp, moved[0] // dp) + moved[1:], dtype=p.dtype,
                    device=dev)
            self._gbuf[n] = torch.zeros(moved, dtype=torch.float32,
                                        device=dev)
        self._gs = [self._gshard.get(n, self._gbuf.get(n))
                    for n, _ in self._trainable]
        self._sharded_idx = [i for i, (n, _) in enumerate(self._trainable)
                             if n in self._gshard]
        self._sharded_at = torch.tensor(self._sharded_idx, dtype=torch.int64,
                                        device=dev)
        self._sq = torch.zeros(2, max(1, len(self._sharded_idx)),
                               dtype=torch.float32, device=dev)

    def _forward(self, inputs):
        """The block's forward under the remat policy (``MXTPU_REMAT``):
        'layer' and 'aggressive' checkpoint each region
        (``_remat_regions``; ``torch.utils.checkpoint``, non-reentrant),
        'layer' with a selective policy that keeps the products without
        batch dims; the generators and buffers are replayed
        (``_Recompute``). At ZeRO-3 the saved-tensor hooks keep gathered
        parameters out of autograd's residuals, and each region gathers
        its own layer groups inside it, so its recompute regathers
        them."""
        hooks = self._z3.hooks() if self._z3 is not None else \
            contextlib.nullcontext()
        with hooks:
            if self._remat_policy == 'none':
                return self.block(*inputs)
            rec = self._recompute
            rec.begin()
            wrapped = [(m, self._checkpointed(m)) for m in self._regions]
            try:
                for m, fn in wrapped:
                    m.forward = fn
                return self.block(*inputs)
            finally:
                for m, _ in wrapped:
                    del m.forward

    def _checkpointed(self, m):
        """``m.forward`` as one checkpoint region."""
        from torch.utils.checkpoint import \
            checkpoint, create_selective_checkpoint_contexts
        rec, z3, orig = self._recompute, self._z3, m.forward

        def run(*args, **kwargs):
            if z3 is not None:
                z3.gather_groups(z3.triggered_by(m))
            return orig(*args, **kwargs)

        def region(*args, **kwargs):
            r = rec.next_region()

            def contexts():
                if self._remat_policy == 'layer':
                    fwd, again = create_selective_checkpoint_contexts(
                        _layer_policy)
                else:
                    fwd, again = contextlib.nullcontext(), \
                        contextlib.nullcontext()
                return _both(rec.forward(r), fwd), \
                    _both(rec.recompute(r), again)
            return checkpoint(run, *args, use_reentrant=False,
                              preserve_rng_state=False, context_fn=contexts,
                              **kwargs)
        return region

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
        if self._gate is not None:
            self._gate.copy()
        prev = self._train_flags()
        try:
            with torch.enable_grad(), plain_calls():
                out = self._forward(inputs)
                outs = out if isinstance(out, (list, tuple)) else (out,)
                loss = self._scale(self.loss_fn(*outs, *labels).mean())
                grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            self._restore_flags(prev)
        with torch.no_grad():
            gs = [g.to(torch.float32) if g is not None else
                  torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for g, p in zip(grads, params)]
            if self._gate is not None:
                self._gate.check(gs, loss)
            if self._t is not None:
                self._t.add_(1)
            self._opt_update(self._p32, gs, self._slots, self._lr.values[0],
                             self._t_now(), **self.optimizer_params)
            if self._low:
                torch._foreach_copy_([p for p, _ in self._low],
                                     [m for _, m in self._low])
            if self._gate is not None:
                self._gate.select()
        return loss.detach()

    def _scale(self, loss):
        """The loss times the fault factor where this call is armed for it
        (the JAX step's ``fault_scale``): an exact identity at 1."""
        return loss * self._lr.values[1] if self._scaled else loss

    def _t_now(self):
        # every parameter's count moves together: the first one is t
        return None if self._t is None else self._t[0]

    # -- the dp step, in the segments its capture splits into ----------
    def _dp_forward(self, inputs):
        """Segment 1: the forward on this rank's rows; its outputs."""
        if self._gate is not None:
            self._gate.copy()
        prev = self._train_flags()
        try:
            with torch.enable_grad(), plain_calls(), \
                    _coll.data_axis(self.dp_axis):
                out = self._forward(inputs)
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
        z3 = self._z3
        try:
            # the data axis too: a recompute of the forward runs here
            with torch.enable_grad(), plain_calls(), \
                    _coll.data_axis(self.dp_axis):
                loss = self._scale(self.loss_fn(*leaves, *labs).mean())
                diff = [i for i, o in enumerate(outs) if o.requires_grad]
                cots = torch.autograd.grad(
                    loss, [leaves[i] for i in diff], allow_unused=True)
                mine = []
                for i, c in zip(diff, cots):
                    b = outs[i].shape[0]
                    mine.append(torch.zeros_like(outs[i]) if c is None
                                else c.narrow(0, r * b, b) * dp)
                if z3 is not None:
                    z3.in_backward = True
                try:
                    grads = torch.autograd.grad(
                        [outs[i] for i in diff], params, grad_outputs=mine,
                        allow_unused=True)
                finally:
                    if z3 is not None:
                        z3.in_backward = False
                        z3.free_all()
        finally:
            self._restore_flags(prev)
        with torch.no_grad():
            self._grads = {}
            for (n, p), g in zip(self._trainable, grads):
                if n in self._gbuf:
                    buf = self._gbuf[n]
                    if g is None:
                        buf.zero_()
                    else:
                        d = self._zdim.get(n)
                        buf.copy_(g if d is None else g.movedim(d, 0))
                else:           # ZeRO-3 sharded: reduce-scattered as it is
                    self._grads[n] = torch.zeros_like(p) if g is None else g
        return loss.detach()

    def _dp_reduce(self):
        """Segment 4: gradients summed over the world, reduce-scattered
        into this rank's shard or all-reduced where replicated."""
        with torch.no_grad():
            for n, _ in self._trainable:
                if n in self._gbuf and n in self._gshard:
                    _coll.reduce_scatter_into(self._gshard[n], self._gbuf[n])
                elif n in self._gbuf:
                    _coll.all_reduce_(self._gbuf[n])
                elif n in self._flat:
                    g = self._grads.pop(n).to(torch.float32).reshape(-1)
                    _coll.reduce_scatter_into(
                        self._gshard[n], torch.nn.functional.pad(
                            g, (0, self._flat[n]['pad'])))
                else:
                    g = self._grads.pop(n).to(torch.float32)
                    _coll.reduce_scatter_into(
                        self._gshard[n], g.movedim(self._zdim[n], 0))

    def _dp_update_phases(self, loss):
        """Segment 5 as functions between which a collective runs: the
        update, or LAMB's direction, its sums-of-squares all-reduce, and
        its step. Under the guard the flag comes first, over ``loss`` and
        this rank's reduced gradients, all-reduced (min) before the
        update, and the last phase ends with the gate."""
        phases, between = self._dp_updates()
        gate = self._gate
        if gate is None:
            return phases, between
        last = phases[-1]

        def gated():
            last()
            gate.select()
        return [lambda: gate.check(self._gs, loss)] + phases[:-1] + \
            [gated], [lambda: _coll.all_reduce_(gate.ok, op='min')] + between

    def _dp_updates(self):
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
        """Segment 6: every parameter whole again from its shards (under
        ZeRO-3 only the flat ones, from their f32 stores: the others stay
        sharded until the next forward gathers them)."""
        with torch.no_grad():
            for n, p in self._trainable:
                if n in self._flat:
                    m = self._master[n]
                    stage = m.new_empty((self._dp, m.numel()))
                    _coll.all_gather_into(stage, m)
                    p.detach().copy_(stage.reshape(-1)[:p.numel()]
                                     .reshape(p.shape))
                    continue
                d = self._zdim.get(n)
                if d is None or n not in self._gather_stage:
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
        if self._z3 is not None:
            self._z3.reset_stats()
        outs = self._dp_forward(inputs)
        gouts, glabs = self._gather_buffers(outs, labels)
        self._dp_gather(outs, labels, gouts, glabs)
        loss = self._dp_backward(outs, gouts, glabs)
        self._dp_reduce()
        phases, between = self._dp_update_phases(loss)
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
            if self._guard is not None:
                # the previous step's flag; a rollback restores in place,
                # and this call's batch trains against what it restored
                self._guard.pre_step()
            fault = _faults.fire('step.dispatch')
            self._scaled = self._guard is not None or \
                _faults.is_armed('step.dispatch')
            inputs = [self._cast(_as_tensor(x)) for x in _as_list(inputs)]
            labels = [_as_tensor(x) for x in _as_list(labels)]
            if self._trainable is None:
                with _trace.span('optimizer.state_init'):
                    self._place_deferred(inputs)
                    self._build()
            self._lr.write([self.lr if lr is None else lr,
                            float('nan') if fault == 'nan' else 1.0])
            if self.device.type != 'cuda' or not self.captured:
                with _trace.span('step.compiled'), \
                        _memory.oom_guard('step.dispatch'):
                    ins = [x.to(self.device) for x in inputs]
                    labs = [x.to(self.device) for x in labels]
                    loss = self._step_dp(ins, labs) if self._dp > 1 else \
                        self._step(ins, labs)
            else:
                loss = self._replay(inputs, labels)
        if self._guard is not None:
            self._guard.push_flag(self._gate.ok)
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
            (len(inputs),) + tuple((tuple(x.shape), x.dtype) for x in labels) \
            + (self._scaled,)
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
                _compile.set_signature(cctx, self.signature(ins, labs))
                _compile.end(cctx)
            elif _telem['on']:
                _metrics.record_compile(site, repr(sig),
                                        time.perf_counter() - t0)
            if self._recompute is not None:
                entry['offsets'] = self._recompute.offsets()
            self._graphs[sig] = entry
            return first
        with _trace.span('h2d.batch_put'):
            for buf, x in zip(entry['ins'] + entry['labs'], inputs + labels):
                buf.copy_(x, non_blocking=True)
        with _trace.span('step.compiled'), \
                _memory.oom_guard('step.dispatch'):
            if self._recompute is not None:
                self._recompute.sync(entry['offsets'])
            entry['run']()
        return entry['loss'].clone()

    def signature(self, inputs, labels):
        """The step's compile signature for these inputs: each argument's
        shape and dtype, and the flags that change what runs: the
        optimizer, the parameter count, the ZeRO stage, the remat policy
        and the flash-attention tile decisions made so far
        (``autotune.decision_flags``), as the JAX step's
        ``_build_signature`` names them."""
        from ..ops import autotune as _autotune
        return _compile.signature(
            [_compile.array_sig(f'input{i}', x) for i, x in enumerate(inputs)]
            + [_compile.array_sig(f'label{i}', x)
               for i, x in enumerate(labels)],
            {'optimizer': self._opt_update.__name__,
             'params': len(self._trainable), 'zero': self._zero_label,
             'remat': self._remat_policy,
             'guard': self._guard is not None, 'fault_scale': self._scaled,
             'autotune': _autotune.decision_flags() or None})

    def _twins(self):
        """The recompute's generator twins, made from what the eager step
        recorded (none without remat)."""
        return self._recompute.make_twins() if self._recompute is not None \
            else []

    def _capture_one(self, ins, labs):
        """dp = 1: the eager step on a side stream (this call's step), then
        the whole step as one graph, the recompute's generator twins
        registered with it."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            first = self._step(ins, labs)
        graph, loss, _ = capture(
            lambda: self._step(ins, labs), self.device,
            graph_generators(self.block, self.device) + self._twins(),
            stream=stream)
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
            self._twins(), stream=stream)
        phases, between = self._dp_update_phases(loss)
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
        step moves, by the JAX step's formulas: a ZeRO-1 tensor's
        reduce-scatter and all-gather move (dp-1)/dp of its bytes each, a
        replicated one's all-reduce twice that, counted at the
        parameter's own dtype; under ZeRO-3 a dim-sharded tensor is
        all-gathered twice (the forward's use and the backward's regather)
        and its f32 gradient reduce-scattered, a flat one's padded f32
        gradient reduce-scattered and its store all-gathered back.
        ``_gather_plan``: (layer group, bytes, gathers) a step, ZeRO-3."""
        dp, ring = self._dp, _ring(self._dp)
        plan = {}

        def add(kind, nbytes, count=1):
            b, c = plan.get((kind, self.dp_axis), (0.0, 0))
            plan[(kind, self.dp_axis)] = (b + nbytes, c + count)

        nbytes = {n: p.numel() * p.element_size() for n, p in self._trainable}
        for n, p in self._trainable:
            lay = self.zero3_layouts.get(n, {}).get('mode')
            if lay == 'dim':
                add('all_gather', 2 * ring * nbytes[n], 2)
                add('reduce_scatter', ring * p.numel() * 4)
            elif lay == 'flat':
                padded = self._flat[n]['padded']
                add('all_gather', ring * padded * 4)
                add('reduce_scatter', ring * padded * 4)
            elif self.zero_specs.get(n) is not None:
                add('all_gather', ring * nbytes[n])
                add('reduce_scatter', ring * nbytes[n])
            elif dp > 1:
                add('all_reduce', 2 * ring * nbytes[n])
        self._hop_plan = plan
        self._gather_plan = [
            (group, 2 * ring * sum(nbytes[n] for n in names), 2)
            for group, names in (self._z3.groups if self._z3 else [])]

    def _record_comm(self):
        if not self._hop_plan:
            return
        if _trace.enabled():
            for (kind, axis), (nbytes, count) in self._hop_plan.items():
                _trace.instant(f'comm.{kind}', bytes=int(nbytes),
                               count=count, axis=axis,
                               stage=self._zero_label)
            for layer, nbytes, count in self._gather_plan:
                _trace.instant('comm.all_gather', bytes=int(nbytes),
                               count=count, axis=self.dp_axis,
                               stage=self._zero_label, layer=layer)
        if _telem['on']:
            for (kind, axis), (nbytes, count) in self._hop_plan.items():
                _metrics.counter('mxnet_tpu_comm_collective_bytes_total').inc(
                    nbytes, kind=kind, axis=axis, stage=self._zero_label)
                _metrics.counter('mxnet_tpu_comm_collectives_total').inc(
                    count, kind=kind, axis=axis, stage=self._zero_label)

    def gather_bytes_per_step(self):
        """Analytic ring-wire bytes of the ZeRO-3 per-layer parameter
        gathers one step moves (0 outside stage 3)."""
        return int(sum(b for _l, b, _c in self._gather_plan))

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
        replicated footprint, plus the tensors too small to shard, the
        ZeRO-3 flat stores' pad included (``opt_state_pad_bytes``)."""
        total = sum(s.numel() * s.element_size()
                    for st in (self._state or {}).values() for s in st)
        total += sum(m.numel() * m.element_size()
                     for m in (self._master or {}).values())
        if self._t is not None:
            total += self._t.numel() * self._t.element_size()
        self.opt_state_pad_bytes = sum(
            lay['pad'] * 4 * (1 + self._n_state) // self._dp
            for lay in self._flat.values()) if self._trainable else 0
        return total

    def _held(self):
        """name -> the tensor of each parameter this rank holds between
        steps: its ZeRO-3 shard, or the parameter."""
        shards = self._z3.shard if self._z3 is not None else {}
        return {n: shards.get(n, p) for n, p in self.block.named_parameters()}

    def param_bytes_per_device(self):
        """Bytes of the block's parameters this rank holds between steps,
        in their own dtypes: each whole, or under ZeRO-3 the dim-sharded
        ones' 1/dp shards."""
        return sum(t.numel() * t.element_size()
                   for t in self._held().values())

    def full_parameters(self):
        """{name: tensor} of every parameter whole: under ZeRO-3 the
        sharded ones gathered from their shards (a collective: call it on
        every rank), else the block's own tensors."""
        out = {}
        for n, p in self.block.named_parameters():
            if self._z3 is not None and n in self._z3.shard:
                out[n] = self._z3.full(n)
            else:
                out[n] = p.detach()
        return out

    def stats(self):
        """The last step's figures: the ZeRO stage, whether the step runs
        as captured CUDA graphs (``captured``: ZeRO-3 runs eagerly), the
        remat policy, the ZeRO-3 layer groups, the group all-gathers the
        step made (the forward's and the backward's) and their host
        ms."""
        z3 = self._z3
        return {'zero_stage': self.zero_stage, 'captured': self.captured,
                'remat': self._remat_policy,
                'layer_groups': len(z3.groups) if z3 else 0,
                'gathers': z3.gathers if z3 else 0,
                'gather_ms': z3.gather_s * 1e3 if z3 else 0.0}

    def memory_pools(self):
        """This step's live tensors as named residency pools
        (``telemetry.memory``): params (as this rank holds them),
        optimizer_state."""
        pools = {'params': dict(self._held()), 'optimizer_state': {}}
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
        self.opt_state_bytes_per_device()       # refreshes the pad bytes
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
            'pad_bytes': self.opt_state_pad_bytes,
            'host_rss_bytes': _memory.host_rss_bytes(),
            **({'gather_bytes_per_layer': {
                g: int(b) for g, b, _c in self._gather_plan}}
               if self._gather_plan else {}),
        }

    # -- the states payload, gathered to logical tensors ----------------
    def _logical(self, n, x, host=_host_copy):
        """A master or moment of ``n`` as the whole logical tensor on the
        host, through ``host`` (gathered from every rank's shard under
        ZeRO; a ZeRO-3 flat store unflattened, its pad dropped)."""
        if n in self._flat:
            buf = x.new_empty((self._dp, x.numel()))
            _coll.all_gather_into(buf, x.detach())
            shape = dict(self._trainable)[n].shape
            return host(buf.reshape(-1)[:self._flat[n]['size']]
                        .reshape(shape))
        d = self._zdim.get(n)
        if d is None:
            return host(x)
        buf = x.new_empty((self._dp,) + tuple(x.shape))
        _coll.all_gather_into(buf, x.detach())
        return host(buf.reshape((-1,) + tuple(x.shape[1:])).movedim(0, d))

    def _shard_of(self, n, a):
        """This rank's part of the logical host array ``a`` of ``n``, in
        the layout of its master and moments."""
        t = torch.from_numpy(onp.asarray(a, onp.float32))
        if n in self._flat:
            lay = self._flat[n]
            k = lay['padded'] // self._dp
            return torch.nn.functional.pad(t.reshape(-1), (0, lay['pad'])) \
                .narrow(0, self.mesh.rank * k, k)
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
        return pickle.dumps(self.states_doc(_host_copy))

    def states_doc(self, host):
        """The ``get_states_bytes`` document before pickling, each tensor
        through ``host`` (tensor -> numpy array): the checkpoint manager
        passes asynchronous copies into pinned memory and pickles on its
        writer thread once they have landed."""
        if self._trainable is None:
            if self._pending_states is not None:
                return dict(self._pending_states)
            raise MXNetError("get_states_bytes: no optimizer state yet — "
                             "run at least one step first")
        counts = None if self._t is None else host(self._t)
        return {
            'format': STATES_FORMAT,
            'opt_state': {
                # a 0-d view: the host copy may still be landing
                n: tuple(self._logical(n, s, host) for s in self._state[n])
                + (() if counts is None else
                   (counts[i:i + 1].reshape(()),))
                for i, (n, _) in enumerate(self._trainable)},
            'master': {n: self._logical(n, m, host)
                       for n, m in self._master.items()},
            'step_count': self._step_count,
            'zero': self.zero, 'stage': self.zero_stage, 'dp': self._dp}

    def load_full_parameters(self, arrays, strict=True):
        """Write {structured name: host array} (``full_parameters``' names)
        into the parameters in place, so a captured graph stays valid;
        under ZeRO-3 each rank takes its shard. Once the step is built the
        f32 masters follow the new values (a states payload restored after
        this overwrites them with its own exact masters)."""
        from ..serialization import to_tensor
        with torch.no_grad():
            for n, p in self.block.named_parameters():
                if n not in arrays:
                    if strict:
                        raise MXNetError(
                            f"load_full_parameters: parameter {n!r} missing "
                            f"(pass strict=False to skip)")
                    continue
                t = to_tensor(arrays[n])
                if tuple(t.shape) != tuple(p.shape):
                    raise MXNetError(
                        f"load_full_parameters: {n!r} has shape "
                        f"{tuple(t.shape)}, the parameter {tuple(p.shape)}")
                if self._z3 is not None and n in self._z3.shard:
                    sh, d = self._z3.shard[n], self._z3.dims[n]
                    rows = sh.shape[0]
                    sh.copy_(t.movedim(d, 0).narrow(
                        0, self.mesh.rank * rows, rows))
                else:
                    p.detach().copy_(t)
            if self._trainable is not None:
                for n, p in self._trainable:
                    if n in self._master:
                        self._master[n].copy_(self._local(n, p))

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
        restored = doc.get('master', {})
        for n, m in restored.items():
            if n in self._master:
                self._master[n].copy_(self._shard_of(n, m))
        # a flat ZeRO-3 store with no saved master (a payload of stage 0 or
        # 1, where the parameter held the value) takes the parameter's
        for n, p in self._trainable:
            if n in self._flat and n not in restored:
                self._master[n].copy_(self._shard_of(
                    n, p.detach().float().cpu().numpy()))
        self._step_count = int(doc.get('step_count', self._step_count))
