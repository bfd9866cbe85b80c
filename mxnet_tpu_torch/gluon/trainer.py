"""Gluon Trainer on one device (counterpart of ``mxnet_tpu/gluon/
trainer.py``).

    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.1, 'momentum': 0.9})
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

The parameters are a Gluon Block's (``net.collect_params()``, a
ParameterDict, or a list of its Parameters) or ``torch.nn.Parameter``s
(``gluon.collect_params(module)`` of the BERT models, trained with
``torch.autograd``'s ``loss.backward()``). Either way the gradient is read
from the tensor's ``.grad``, where ``mx.autograd``'s backward writes a
Gluon Parameter's by its ``grad_req`` and torch's backward accumulates.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and applies
one optimizer update to every parameter that requires a gradient, as the
JAX Trainer does to every parameter whose ``grad_req`` is not 'null'.

Gradient buffers. The JAX Trainer reads each parameter's gradient
buffer, which a backward pass overwrites only where the loss reached the
parameter. The port keeps one buffer per parameter in the same role:
before each update it copies every ``.grad`` that is set into its buffer,
and a parameter whose ``.grad`` is None (the loss has not reached it
since ``zero_grad(set_to_none=True)``, torch's default) is updated with
what its buffer holds: its last gradient, zero if it never had one.
``zero_grad(set_to_none=False)`` zeroes the ``.grad`` tensors instead,
as the JAX ``Parameter.zero_grad()`` zeroes the buffer.

The fused update. An optimizer with ``fused_update = True`` (all but
LARS, SGLD and Nadam, as in the JAX package) has every parameter's
update run as one program, the JAX Trainer's ``_fused_apply``: the
per-step scalars (each parameter's lr and wd, its update count t,
rescale_grad) go into one device vector that the optimizer reads in
place of its Python values, as the JAX Trainer feeds them to its trace. On the card the program is captured once
per (parameters, optimizer class, dtypes) as a CUDA graph, after one
eager run that is that step's update, and replayed on every later step;
weights, masters and states are updated in place by the replay, so they
must stay the same tensors (a ``set_states_bytes`` recaptures). On the
CPU the same program runs eagerly. Any other optimizer takes the
per-parameter loop (``Updater``), as in JAX.

Telemetry, as the JAX Trainer reports it: ``step`` runs under a
``step.dispatch`` span with the update in ``optimizer.update`` (the fused
program's call in ``optimizer.fused``) and the OOM guard, then
``memory.on_step`` and ``flight.record_step``; with telemetry on, the
interval between two steps goes to ``telemetry.record_step`` (the first
interval, and any longer than 20x the running mean — a pause, a
capture — are left out; ``reset_step_timer()`` forgets the last step),
and the fused update's capture is a compile of site
``trainer:fused_update`` (the compile ledger when armed, else the
compile counters).

AMP, as in the JAX Trainer: after ``amp.init_trainer(trainer)``,
``amp.scale_loss`` sets ``_scale`` to the original scale over the loss
scale, so ``rescale_grad`` (a device scalar of the captured update, so a
new loss scale recaptures nothing) divides the scaled gradients back.
With a dynamic scaler each update first reduces the finiteness of every
gradient buffer on the device (one host sync); a non-finite one skips the
update, update counts included, and halves the scale.

Data parallelism. In a world of more than one rank (``parallel.dist``)
each rank runs its forward and backward on its own rows of the global
batch, and ``kvstore='device'`` (the default) or ``'local'`` reduces the
gradients over the world before the update: summed, so ``step(batch_size)``
takes the *global* batch size, as the JAX Trainer's global arrays do
(classic MXNet ``dist_sync`` workers pass their local batch size and
the kvstore's sum is rescaled by it; here the sum is divided once by the
global count). ``kvstore=None`` reduces nothing. The parameters are
broadcast from rank 0 when the Trainer is made (a parameter still
deferred then, at its first step). ZeRO-1 is on by default at dp > 1
(``MXTPU_ZERO``), in the fused update, as in the JAX Trainer's
``_zero_layout``: each gradient is reduce-scattered along its ZeRO dim
(the JAX step's ``compose_zero_spec``), the fused program updates the
shard against shard-sized states (master and moments), and the
parameters are all-gathered back; tensors that do not split evenly stay
replicated (all-reduced, updated whole). An update that reads a norm of
the whole weight (LAMB, ``Optimizer.whole_tensor``) and the
per-parameter loop keep every state replicated. ``get_states_bytes``
gathers the states to whole tensors (a collective: call it on every
rank), so a payload restores at any dp, under ZeRO or not. Stage 3
(``MXTPU_ZERO=3``), the weights themselves sharded, raises at dp > 1
(ROADMAP queue 1 item 7; ``ShardedTrainStep`` runs it). Under AMP
the finiteness of the local gradients is reduced over the world, so
every rank skips the same step.

The non-finite guard, as in the JAX Trainer: ``attach_guard(guard)``
(a ``resilience.NonFiniteGuard``) folds into the fused update, which it
recaptures, the finiteness of every gradient (one ``_foreach_norm`` at
inf, NaN and inf propagating) into a flag on the device, copies the
weights and every state tensor aside and, after the update, writes back
``torch.where(flag, new, old)``: a non-finite step is a no-op on the
device, inside the same CUDA graph. The guard reads the flag at the next
``step`` (``pre_step``), before the update; a bad flag rewinds the update
counts the skipped step advanced on the host, and a rollback restores
the last checkpoint and drops this step's update (its gradients were
computed against the weights before the restore). Under dp the flag is
taken in a program of its own and all-reduced (min) before the update,
so every rank skips the same step. The per-parameter loop checks the
gradients first and skips the update. The ``step.dispatch`` fault site
fires in every ``step``; ``nan`` poisons every gradient.

Sparse parameters (``stype`` or ``grad_stype`` not 'default', e.g.
``Embedding(sparse_grad=True)``): as in the JAX Trainer the fused update
declines them and every parameter takes the per-parameter loop, where a
``row_sparse`` gradient reaches the optimizer as a RowSparseNDArray, so
SGD's and Adam's ``lazy_update`` leave the rows without a gradient (and
their moments) as they were. ``sparse_layout()`` describes the tables
for the checkpoint manifest.

The distributed kvstore types, gradient compression and
update_on_kvstore raise (ROADMAP queue 1 item 8). The elastic hook of
the JAX Trainer waits for item 10.
"""
from __future__ import annotations

import time

import torch

from .. import config as _config
from .._capture import DeviceScalars, capture
from ..base import MXNetError, telem_flags as _telem
from ..parallel import collectives as _coll, dist as _dist
from ..parallel.step import P, compose_zero_spec
from ..resilience import faults as _faults
from ..resilience.guard import DeviceGate, finite_flag
from ..telemetry import compile as _compile, flight as _flight, \
    memory as _memory, metrics as _metrics, trace as _trace
from ..ndarray.sparse import RowSparseNDArray
from ..serialization import atomic_write_file
from .. import optimizer as opt
from .parameter import Parameter, tensor_of

__all__ = ['Trainer']


def _leaves(state):
    if isinstance(state, torch.Tensor):
        yield state
    elif isinstance(state, (list, tuple)):
        for s in state:
            yield from _leaves(s)


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, (list, tuple)):
        return tuple(_to_device(s, device) for s in state)
    return state


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None,
                 update_on_kvstore=None):
        if hasattr(params, 'values'):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters")
        for p in params:
            if not isinstance(p, (Parameter, torch.nn.Parameter)):
                raise ValueError(f"First argument must contain Parameters, "
                                 f"got {type(p)}")
        if kvstore not in ('device', 'local', None):
            raise MXNetError(f"kvstore {kvstore!r} is not ported: the port's "
                             f"Trainer reduces over the dp world with "
                             f"'device' or 'local' (None: no reduction); "
                             f"the distributed kvstores are ROADMAP queue 1 "
                             f"item 8")
        if compression_params is not None:
            raise MXNetError("gradient compression is not ported (ROADMAP "
                             "queue 1 item 8)")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore is not ported (ROADMAP "
                             "queue 1 item 8)")
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get('rescale_grad', 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        self._grads = {}       # index -> the gradient buffer the update reads
        self._fused = None     # [signature, graphs, scalars, parts, between]
        self._guard = None     # resilience.NonFiniteGuard (attach_guard)
        self._gate = None      # the guard's DeviceGate in the fused update
        self._fused_count_snapshot = None  # counts before the last update
        self._telem_last_step = None
        self._telem_step_ema = None
        # the dp world: gradients reduced over it, ZeRO-1 states (see the
        # module docstring)
        self._reduce = _dist.num_workers() > 1 and kvstore is not None
        self._zero_active = False
        self._zero_dp = 1
        self._zero_dims = {}     # index -> the dim its states shard along
        self._zero_grads = {}    # index -> its reduce-scattered shard
        self._broadcast = set()  # indices broadcast from rank 0
        self._contains_sparse_weight = any(
            getattr(p, '_stype', 'default') != 'default' for p in self._params)
        self._contains_sparse_grad = any(
            getattr(p, '_grad_stype', 'default') != 'default'
            for p in self._params)
        if self._reduce:
            self._broadcast_params()

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def sparse_layout(self):
        """The RowSparse layout of the eager update for the checkpoint
        manifest (``optimizer_state_layout.sparse``), as the JAX Trainer
        gives it: None when no parameter has a ``row_sparse`` gradient;
        else the update mode (lazy when the optimizer has lazy row
        updates) and the (vocab, dim) of every sparse-gradient table.
        Provenance only: the states stay table-shaped either way."""
        tables = {}
        for p in self._params:
            if getattr(p, '_grad_stype', 'default') != 'row_sparse':
                continue
            shape = tuple(p.shape or ())
            if len(shape) == 2:
                tables[p.name] = {'vocab': int(shape[0]),
                                  'dim': int(shape[1])}
        if not tables:
            return None
        lazy = bool(getattr(self._optimizer, 'lazy_update', False))
        return {'mode': 'lazy' if lazy else 'exact',
                'table_axis': None, 'tables': tables}

    def _row_sparse(self, i):
        return getattr(self._params[i], '_grad_stype', 'default') == \
            'row_sparse'

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every parameter, its gradient scaled by
        1/batch_size. ``ignore_stale_grad`` is accepted and changes
        nothing, as in the JAX Trainer: a parameter the loss did not reach
        is updated with what its gradient buffer holds."""
        if _telem['on']:
            self._time_step(batch_size)
        with _trace.span('step.dispatch'):
            if _faults.fire('step.dispatch') == 'nan':
                self._poison_grads()
            if self._guard is not None and \
                    self._guard.pre_step(on_bad=self._rewind_update_counts):
                # a rollback just restored the weights, states and RNG:
                # the gradients were computed against the weights before
                # it, so this step's update is dropped
                return
            self._optimizer.rescale_grad = self._scale / batch_size
            with _trace.span('optimizer.update'), \
                    _memory.oom_guard('step.dispatch'):
                self._update()
        _memory.on_step(self._optimizer.num_update)
        _flight.record_step(self._optimizer.num_update)

    def _time_step(self, batch_size):
        now = time.perf_counter()
        last, ema = self._telem_last_step, self._telem_step_ema
        self._telem_last_step = now
        if last is None:
            return
        dt = now - last
        if ema is None:
            # the first interval seeds the filter but is not recorded: it
            # typically holds the capture (and may hold a pause)
            self._telem_step_ema = dt
        elif dt <= 20.0 * ema:
            _metrics.record_step(dt, batch_size)
            self._telem_step_ema = 0.9 * ema + 0.1 * dt

    def attach_guard(self, guard):
        """Bind a ``resilience.NonFiniteGuard`` (see the module docstring).
        Recaptures the fused update, which the guard changes."""
        self._guard = guard
        self._fused = None

    def _poison_grads(self):
        """Injected ``step.dispatch:nan`` fault: every gradient becomes NaN
        on the device (the ``.grad`` where set, else its buffer), so the
        guard's detection, skip and rollback take a real non-finite
        step."""
        for i, param in enumerate(self._params):
            if isinstance(param, Parameter) and \
                    not param._is_materialized():
                continue
            p = tensor_of(param)
            if not p.requires_grad:
                continue
            g = p.grad if p.grad is not None else self._grads.get(i)
            if g is not None:
                g.mul_(float('nan'))

    def _rewind_update_counts(self):
        """A guard-skipped step was a no-op on the device, but the fused
        update advanced the host-side update counts before the flag was
        known: rewind them, so bias correction and schedules keyed on
        ``num_update`` see the skip as a true no-op."""
        snap = self._fused_count_snapshot
        if snap is not None:
            counts, num = snap
            self._optimizer._index_update_count = dict(counts)
            self._optimizer.num_update = num
            self._fused_count_snapshot = None

    def _grads_ok(self, grads):
        """The per-parameter loop's check, before it updates: every
        gradient finite (over the world under dp). One host sync."""
        ok = finite_flag(grads)
        if self._reduce:
            ok = _coll.all_reduce_(ok, op='min')
        return bool(ok)

    def reset_step_timer(self):
        """Forget the previous step() timestamp so an intervening pause
        (validation pass, checkpoint save) is not measured as step time."""
        self._telem_last_step = None

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    @torch.no_grad()
    def _update(self):
        items = self._gather_grads()
        if self._reduce:
            self._broadcast_params()
        # AMP's dynamic loss scaling: on a non-finite gradient the update
        # is skipped (no update count moves) and the scale shrinks,
        # decided before the fused update replays
        scaler = getattr(self, '_amp_loss_scaler', None)
        if scaler is not None and scaler.dynamic:
            overflow = scaler.has_overflow([g for _, _, g in items])
            if self._reduce:
                flag = torch.tensor([float(overflow)],
                                    device=_dist.device())
                overflow = bool(_coll.all_reduce_(flag, op='max').item())
            scaler.update_scale(overflow)
            if overflow:
                return
        if self._reduce:
            items = self._reduce_grads(items)
        if not self._fused_apply(items):
            if self._guard is not None and items:
                # the loop cannot gate on the device: check first (the
                # skip happens before any count moves: nothing to rewind)
                self._fused_count_snapshot = None
                ok = self._grads_ok([g for _, _, g in items])
                self._guard.push_flag(ok)
                if not ok:
                    return
            for i, p, g in items:
                if self._row_sparse(i):
                    # the optimizer reads the stype: lazy row updates
                    g = RowSparseNDArray(g)
                self._updater(i, g, p)
        if self._zero_active:
            self._gather_params()

    # -- the dp world ---------------------------------------------------
    def _broadcast_params(self):
        """Rank 0's value of every parameter not broadcast yet (a deferred
        one once it is placed)."""
        for i, param in enumerate(self._params):
            if i in self._broadcast:
                continue
            if isinstance(param, Parameter) and \
                    not param._is_materialized():
                continue
            _coll.broadcast_(tensor_of(param).data)
            self._broadcast.add(i)

    def _zero_dim(self, p):
        spec = compose_zero_spec(tuple(p.shape), P(), 'dp',
                                 _dist.num_workers())
        return None if spec is None else list(spec).index('dp')

    def _shard(self, i, t):
        """The ZeRO shard of index ``i``'s full-shaped ``t`` this rank
        updates: a view, the ZeRO dim first."""
        d = self._zero_dims[i]
        s = t.shape[d] // self._zero_dp
        return t.movedim(d, 0).narrow(0, _dist.rank() * s, s)

    def _reduce_grads(self, items):
        """The gradient buffers summed over the world, in f32:
        reduce-scattered into f32 shards under ZeRO (the items then hold
        the shard views and shard gradients), all-reduced otherwise (and
        written back in the buffer's dtype)."""
        o = self._optimizer
        stage = _config.get('MXTPU_ZERO')
        if stage == 3:
            raise MXNetError(
                "Trainer: MXTPU_ZERO=3 shards the weights between steps, "
                "which the eager forward would need gathered on every "
                "module; the Trainer's stage 3 is not ported (ROADMAP queue "
                "1 item 7). ShardedTrainStep(..., zero=3) runs it")
        zero = stage > 0 and getattr(o, 'fused_update', False) and \
            not o.whole_tensor
        if zero != self._zero_active:
            self._zero_active = zero
            self._zero_dp = _dist.num_workers() if zero else 1
            self._zero_dims = {}
            self._fused = None
            self._relayout_states()
        out = []
        for i, p, g in items:
            if zero and i not in self._zero_dims:
                d = self._zero_dim(p)
                if d is not None:
                    self._zero_dims[i] = d
                    shard = g.movedim(d, 0).narrow(
                        0, 0, g.shape[d] // self._zero_dp)
                    self._zero_grads[i] = torch.empty(
                        shard.shape, dtype=torch.float32, device=g.device)
                    self._relayout_states(i)
            if i in self._zero_dims:
                d = self._zero_dims[i]
                _coll.reduce_scatter_into(
                    self._zero_grads[i],
                    g.movedim(d, 0).to(torch.float32,
                                       memory_format=torch.contiguous_format))
                out.append((i, self._shard(i, p), self._zero_grads[i]))
            else:
                g32 = _coll.all_reduce_(g.float())
                if g32 is not g:
                    g.copy_(g32)
                out.append((i, p, g))
        return out

    def _gather_params(self):
        for i, d in self._zero_dims.items():
            p = tensor_of(self._params[i])
            buf = p.new_empty((self._zero_dp,) + tuple(
                self._shard(i, p).shape))
            _coll.all_gather_into(buf, self._shard(i, p.detach()))
            p.detach().movedim(d, 0).copy_(
                buf.reshape((-1,) + tuple(buf.shape[2:])))

    def _state_map(self, i, fn):
        """Index ``i``'s state with ``fn`` applied to each tensor leaf."""
        def walk(s):
            if isinstance(s, torch.Tensor):
                return fn(s)
            if isinstance(s, (list, tuple)):
                return type(s)(walk(x) for x in s)
            return s
        return walk(self._updater.states[i])

    def _relayout_states(self, only=None):
        """States made whole-shaped (a restore, or before ZeRO) to the
        ZeRO layout: weight-shaped leaves become this rank's shard."""
        for i in list(self._updater.states):
            if (only is not None and i != only) or i not in self._zero_dims:
                continue
            wshape = tuple(tensor_of(self._params[i]).shape)
            self._updater.states[i] = self._state_map(
                i, lambda s: self._shard(i, s).contiguous()
                if tuple(s.shape) == wshape else s)

    def _whole_states(self):
        """{index: state} with every ZeRO shard gathered to its whole
        tensor (a collective)."""
        states = {}
        for i in self._updater.states:
            d = self._zero_dims.get(i)
            if d is None:
                states[i] = self._updater.states[i]
                continue
            sshape = tuple(self._zero_grads[i].shape)

            def whole(s, d=d, sshape=sshape):
                if tuple(s.shape) != sshape:
                    return s
                buf = s.new_empty((self._zero_dp,) + sshape)
                _coll.all_gather_into(buf, s)
                return buf.reshape((-1,) + sshape[1:]).movedim(0, d)
            states[i] = self._state_map(i, whole)
        return states

    def opt_state_bytes_per_device(self):
        """Bytes of optimizer state this rank holds (ZeRO-1: ~1/dp of the
        replicated footprint, plus the tensors too small to shard)."""
        return sum(t.numel() * t.element_size()
                   for st in self._updater.states.values()
                   for t in _leaves(st))

    def param_bytes_per_device(self):
        """Bytes of the parameters this rank holds (whole, in their
        dtypes)."""
        return sum(tensor_of(p).numel() * tensor_of(p).element_size()
                   for p in self._params
                   if not isinstance(p, Parameter) or p._is_materialized())

    def _gather_grads(self):
        """[(index, parameter, gradient buffer)] of the trainable
        parameters, every ``.grad`` that is set copied into its buffer."""
        items, dst, src = [], [], []
        for i, param in enumerate(self._params):
            if isinstance(param, Parameter):
                param._check_initialized()
            p = tensor_of(param)
            if not p.requires_grad:
                continue
            buf = self._grads.get(i)
            if buf is None:
                buf = self._grads[i] = torch.zeros_like(
                    p, memory_format=torch.contiguous_format)
            if p.grad is not None:
                dst.append(buf)
                src.append(p.grad)
            items.append((i, p, buf))
        if dst:
            torch._foreach_copy_(dst, src)
        return items

    def _fused_apply(self, items):
        """Every update as one program (see the module docstring). False
        when the optimizer does not declare ``fused_update``: the caller
        then runs the per-parameter loop."""
        if not items:
            return True
        o = self._optimizer
        if not getattr(o, 'fused_update', False):
            return False
        if self._contains_sparse_weight or self._contains_sparse_grad:
            # sparse parameters take the per-parameter loop, whose
            # optimizer call reads each gradient's stype (lazy updates),
            # as the JAX Trainer declines its fused update for them
            return False
        updater = self._updater
        indices = [i for i, _, _ in items]
        for i, p, _ in items:
            if i not in updater.states:
                updater.states[i] = o.create_state_multi_precision(i, p)
                updater.states_synced[i] = True
        # host-side per-step scalars, the counts first (as JAX does); the
        # counts before them are kept for the guard's rewind
        self._fused_count_snapshot = (dict(o._index_update_count),
                                      o.num_update)
        for i in indices:
            o._update_count(i)
        values = o._get_lrs(indices) + o._get_wds(indices) + \
            [o._index_update_count[i] for i in indices] + [o.rescale_grad]
        device = items[0][1].device
        sig = (tuple(indices), o.__class__,
               tuple(p.dtype for _, p, _ in items), device,
               self._guard is not None)
        if self._fused is None or self._fused[0] != sig:
            scalars = DeviceScalars(len(values), device)
            update = self._program(items, scalars.values)
            parts, between = self._guarded(items, update) \
                if self._guard is not None else ([update], [])
            self._fused = [sig, None, scalars, parts, between]
        _, graphs, scalars, parts, between = self._fused
        scalars.write(values)
        with _trace.span('optimizer.fused'):
            if device.type != 'cuda':
                runs = parts
            elif graphs is None:
                # the warm-up run is this step's update; later steps replay
                graphs = self._fused[1] = self._capture(parts, device, items)
                runs = []
            else:
                runs = [g.replay for g in graphs]
            for k, run in enumerate(runs):
                run()
                if k < len(between):
                    between[k]()
        if self._guard is not None:
            self._guard.push_flag(self._gate.ok)
        return True

    def _guarded(self, items, update):
        """The fused update under the guard, as the programs to run in
        order and the host steps between them: the flag over the
        gradients (all-reduced, min, between the two programs under dp),
        then the weights and state tensors copied aside, the update, and
        each tensor written back as ``where(flag, new, old)``."""
        gate = self._gate = DeviceGate(
            [p for _, p, _ in items] + [t for i, _, _ in items
                                        for t in _leaves(
                                            self._updater.states[i])],
            items[0][1].device)
        grads = [g for _, _, g in items]

        def check():
            gate.check(grads)

        def apply():
            gate.copy()
            update()
            gate.select()
        if self._reduce:
            return [check, apply], [lambda: _coll.all_reduce_(gate.ok,
                                                              op='min')]

        def both():
            check()
            apply()
        return [both], []

    def _capture(self, parts, device, items):
        """Each program captured as a CUDA graph, each after one eager
        warm-up run that is this step's (the host steps between them run
        between the warm-ups)."""
        site = 'trainer:fused_update'
        cctx = _compile.begin(site)
        t0 = time.perf_counter()
        between = self._fused[4]
        try:
            graphs = []
            for k, part in enumerate(parts):
                graphs.append(capture(part, device, warm_up=True)[0])
                if k < len(between):
                    between[k]()
        except BaseException:
            _compile.abort(cctx)
            raise
        if cctx is not None:
            _compile.set_signature(cctx, _compile.signature(
                [_compile.array_sig(f'param{i}', p) for i, p, _ in items],
                {'optimizer': self._optimizer.__class__.__name__,
                 'params': len(items), 'guard': self._guard is not None}))
            _compile.end(cctx)
        elif _telem['on']:
            _metrics.record_compile(site, repr(self._fused[0][:3]),
                                    time.perf_counter() - t0)
        return graphs

    def _program(self, items, scalars):
        """The fused update over ``items``: the optimizer's own
        ``update_multi_precision`` for each parameter, with its scalar
        accessors shadowed by entries of the device vector ``scalars``
        (lrs, wds, ts, rescale_grad) while it runs, as the JAX Trainer
        shadows them while it traces."""
        o = self._optimizer
        n = len(items)
        pos = {i: k for k, (i, _, _) in enumerate(items)}
        lrs, wds, ts = scalars[:n], scalars[n:2 * n], scalars[2 * n:3 * n]
        rescale = scalars[3 * n]
        states = [self._updater.states[i] for i, _, _ in items]

        class _Counts:
            def __getitem__(self, idx):
                return ts[pos[idx]]

        def program():
            saved = (o._index_update_count, o.rescale_grad)
            o._get_lr = lambda idx: lrs[pos[idx]]
            o._get_wd = lambda idx: wds[pos[idx]]
            o._update_count = lambda idx: None
            o._index_update_count = _Counts()
            o.rescale_grad = rescale
            try:
                for (i, p, g), st in zip(items, states):
                    o.update_multi_precision(i, p, g, st)
            finally:
                for name in ('_get_lr', '_get_wd', '_update_count'):
                    o.__dict__.pop(name, None)
                o._index_update_count, o.rescale_grad = saved
        return program

    def get_states_bytes(self):
        """The states payload as bytes: {index: state as numpy, whole
        tensors under ZeRO too} and the pickled optimizer (update counts,
        rescale_grad, schedule)."""
        if not self._zero_dims:
            return self._updater.get_states(dump_optimizer=True)
        held, self._updater.states = self._updater.states, \
            self._whole_states()
        try:
            return self._updater.get_states(dump_optimizer=True)
        finally:
            self._updater.states = held

    def set_states_bytes(self, states):
        """Restore a ``get_states_bytes`` payload: the states go to their
        parameters' devices, the optimizer gets the live parameters back,
        and the fused update is recaptured over the new state tensors."""
        self._updater.set_states(states)
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updater.states = {
            i: _to_device(s, tensor_of(self._params[i]).device)
            for i, s in self._updater.states.items()}
        if self._zero_dims:
            self._relayout_states()
        self._fused = None

    def save_states(self, fname):
        """Atomic: a temporary file, then ``os.replace``."""
        atomic_write_file(fname, self.get_states_bytes())

    def load_states(self, fname):
        with open(fname, 'rb') as f:
            self.set_states_bytes(f.read())
