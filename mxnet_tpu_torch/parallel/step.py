"""The compiled training step (counterpart of ``mxnet_tpu/parallel/step.py``
``ShardedTrainStep``) on one device.

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

Not ported, each refused by name: a mesh of more than one device and
``param_specs`` (ROADMAP queue 1 item 6), ZeRO-3 and ``MXTPU_REMAT``
(item 7), ``compression_params`` and ``hierarchy`` (item 8), ``guard``
(item 9), sparse gradients (item 12).
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
from .mesh import make_mesh

__all__ = ['ShardedTrainStep', 'rename_states', 'STATES_FORMAT']

STATES_FORMAT = 'sharded_train_step_v1'

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


def _lamb_update(ps, gs, st, lr, t, beta1=0.9, beta2=0.999, eps=1e-6,
                 wd=0.01):
    ms, vs = st
    _moments(gs, ms, vs, beta1, beta2)
    mhat, vhat = _bias_corrected(ms, vs, t, beta1, beta2)
    den = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
    upd = torch._foreach_div(mhat, den)
    torch._foreach_add_(upd, torch._foreach_mul(ps, wd))
    r1 = torch.stack(torch._foreach_norm(ps))
    r2 = torch.stack(torch._foreach_norm(upd))
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    torch._foreach_mul_(upd, list((lr * ratio).unbind(0)))
    torch._foreach_sub_(ps, upd)


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


class ShardedTrainStep:
    """One training step per call over one device (see the module
    docstring). ``mesh`` defaults to a mesh over the device of the
    block's parameters."""

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
        if param_specs:
            raise MXNetError("ShardedTrainStep: param_specs (sharded "
                             "parameters) are not ported; the port trains "
                             "on one device (ROADMAP queue 1 item 6)")
        if zero is not None and int(zero) == 3:
            raise MXNetError("ShardedTrainStep: ZeRO-3 is not ported "
                             "(ROADMAP queue 1 item 7)")
        if zero is not None and int(zero) not in (0, 1):
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
        if any(d != self.device for d in self.mesh.devices.flat):
            raise MXNetError(f"ShardedTrainStep: mesh {self.mesh} is not on "
                             f"the block's device {self.device}")
        self.donate = donate
        self.zero_stage = 0          # one device: nothing to shard
        self.zero = False
        self._trainable = None       # [(name, parameter)], sorted by name
        self._master = None          # name -> f32 master of a bf16/f16 one
        self._state = None           # name -> tuple of f32 state tensors
        self._t = None               # the update count, int32 on the device
        self._lr = None              # DeviceScalars: this step's rate
        self._graphs = {}            # signature -> (graph, ins, labels, loss)
        self._step_count = 0
        self._pending_states = None  # a restored payload awaiting the build

    # ------------------------------------------------------------------
    def _build(self):
        named = sorted(self.block.named_parameters())
        self._trainable = [(n, p) for n, p in named if p.requires_grad]
        self._master = {
            n: p.detach().to(torch.float32).clone()
            for n, p in self._trainable
            if p.is_floating_point() and p.element_size() < 4}
        self._state = {n: tuple(torch.zeros(p.shape, dtype=torch.float32,
                                            device=self.device)
                                for _ in range(self._n_state))
                       for n, p in self._trainable}
        self._t = torch.zeros((), dtype=torch.int32, device=self.device) \
            if self._has_t else None
        self._lr = DeviceScalars(1, self.device)
        self._p32 = [self._master.get(n, p) for n, p in self._trainable]
        self._slots = [[self._state[n][k] for n, _ in self._trainable]
                       for k in range(self._n_state)]
        self._low = [(p, self._master[n]) for n, p in self._trainable
                     if n in self._master]
        if self._pending_states is not None:
            doc, self._pending_states = self._pending_states, None
            self._apply_states(doc)

    def _step(self, inputs, labels):
        """Forward, loss, gradients and update on the given tensors;
        returns the loss. Allocates nothing that outlives it and reads
        the rate from the device scalar, so it can be captured."""
        params = [p for _, p in self._trainable]
        prev, prev_flag = self.block.training, state.is_training
        # layers read the module flag, nd ops autograd's (as the JAX step
        # sets it around the forward and the loss)
        self.block.train()
        state.is_training = True
        try:
            with torch.enable_grad(), plain_calls():
                out = self.block(*inputs)
                outs = out if isinstance(out, (list, tuple)) else (out,)
                loss = self.loss_fn(*outs, *labels).mean()
                grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            self.block.train(prev)
            state.is_training = prev_flag
        with torch.no_grad():
            gs = [g.to(torch.float32) if g is not None else
                  torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for g, p in zip(grads, params)]
            if self._t is not None:
                self._t.add_(1)
            self._opt_update(self._p32, gs, self._slots, self._lr.values[0],
                             self._t, **self.optimizer_params)
            if self._low:
                torch._foreach_copy_([p for p, _ in self._low],
                                     [m for _, m in self._low])
        return loss.detach()

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
                    loss = self._step([x.to(self.device) for x in inputs],
                                      [x.to(self.device) for x in labels])
            else:
                loss = self._replay(inputs, labels)
        self._step_count += 1
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
                    graph, loss, first = capture(
                        lambda: self._step(ins, labs), self.device,
                        graph_generators(self.block, self.device),
                        warm_up=True)
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
            self._graphs[sig] = (graph, ins, labs, loss)
            return first
        graph, ins, labs, loss = entry
        with _trace.span('h2d.batch_put'):
            for buf, x in zip(ins + labs, inputs + labels):
                buf.copy_(x, non_blocking=True)
        with _trace.span('step.compiled'), \
                _memory.oom_guard('step.dispatch'):
            graph.replay()
        return loss.clone()

    # ------------------------------------------------------------------
    def opt_state_bytes_per_device(self):
        """Bytes of optimizer state (moments, masters, the update count)
        the device holds."""
        total = sum(s.numel() * s.element_size()
                    for st in (self._state or {}).values() for s in st)
        total += sum(m.numel() * m.element_size()
                     for m in (self._master or {}).values())
        if self._t is not None:
            total += self._t.element_size()
        return total

    def param_bytes_per_device(self):
        """Bytes of the block's parameters in their own dtypes."""
        return sum(p.numel() * p.element_size()
                   for p in self.block.parameters())

    def get_states_bytes(self):
        """The optimizer state as the JAX step's ``sharded_train_step_v1``
        payload: {name: (moments..., t as an int32 array)} and the f32
        masters, all numpy, keyed by structured parameter name (see
        ``rename_states`` for the JAX package's names)."""
        if self._trainable is None:
            if self._pending_states is not None:
                return pickle.dumps(self._pending_states)
            raise MXNetError("get_states_bytes: no optimizer state yet — "
                             "run at least one step first")
        t = () if self._t is None else \
            (onp.asarray(self._t.cpu().numpy(), onp.int32),)
        doc = {
            'format': STATES_FORMAT,
            'opt_state': {n: tuple(s.cpu().numpy() for s in st) + t
                          for n, st in self._state.items()},
            'master': {n: m.cpu().numpy() for n, m in self._master.items()},
            'step_count': self._step_count,
            'zero': self.zero, 'stage': self.zero_stage, 'dp': 1}
        return pickle.dumps(doc)

    def set_states_bytes(self, blob):
        """Restore a ``get_states_bytes`` payload (this package's or, after
        ``rename_states``, the JAX step's) into the existing state tensors,
        in place, so a captured graph stays valid."""
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
                dst.copy_(torch.from_numpy(onp.asarray(src, onp.float32)))
        if len(counts) > 1:
            raise MXNetError(f"set_states_bytes: the parameters' update "
                             f"counts differ ({sorted(counts)}); this step "
                             f"keeps one count for all")
        if counts:
            self._t.fill_(counts.pop())
        for n, m in doc.get('master', {}).items():
            if n in self._master:
                self._master[n].copy_(torch.from_numpy(
                    onp.asarray(m, onp.float32)))
        self._step_count = int(doc.get('step_count', self._step_count))
