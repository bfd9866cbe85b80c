"""Symbol: lazy graph construction and the Executor (counterpart of
``mxnet_tpu/symbol.py``, ref: python/mxnet/symbol/symbol.py,
include/mxnet/executor.h).

A Symbol is a node of a DAG over the port's op registry (``base.
_OP_REGISTRY``): ``mx.sym.<op>`` exists for every registered op, with the
JAX package's CamelCase aliases (``FullyConnected``, ``BatchNorm``, ...)
and its auto-created parameters (``_AUTO_PARAMS``: ``fc1_weight``,
``bn1_moving_mean`` marked as an auxiliary state, ...). ``tojson``/
``fromjson`` write and read the JAX package's JSON byte for byte, so a
graph saved by either package loads in the other.

Shape inference runs each op on ``meta`` tensors (no data, no device);
an op whose wrapper launches a hand-written kernel for any tensor not on
the CPU has a shape rule instead (``register_shape_rule``), so no meta
tensor reaches a kernel or a kernel's plain version.

The Executor (``simple_bind``/``bind``) runs the graph eagerly, node by
node, on the bound tensors, with its gradients from ``torch.autograd``:
``forward(is_train=True)`` runs under the port's training mode, and each
BatchNorm node's new moving statistics are written back into
``aux_dict`` (MXNet 1.6's behaviour; the JAX executor leaves both out,
ROADMAP queue 3). ``ctx=None`` is the card (``context.resolve_device``);
the CPU only when asked for or inside ``with mx.cpu():``.

Differences from the JAX package, each a fault of its own there:

- a tuple or list passed as an op's positional input raises an
  ``MXNetError`` naming the op (the JAX ``_OpMaker`` drops it, so
  ``sym.Activation(sym.BatchNorm(x))`` loses ``x``); multi-output ops
  still return the JAX package's tuple, so ``bn[0]`` works in both;
- ``bind`` honours ``aux_states`` and ``group2ctx``, ``copy_params_from``
  its ``aux_params``, and ``infer_shape`` infers weights from the data
  shapes and returns the auxiliary states' shapes, as MXNet does.
"""
from __future__ import annotations

import json

import numpy as onp
import torch

from .base import MXNetError, _OP_REGISTRY, _OP_ALIASES, get_op, state, \
    telem_flags as _telem, torch_dtype
from .context import Context, resolve_device
from .ndarray.ndarray import NDArray

__all__ = ['Symbol', 'Executor', 'var', 'Variable', 'zeros', 'ones', 'load',
           'fromjson', 'infer_shapes_partial', 'register_shape_rule']


def _iter_nodes(root, order='pre', key=id):
    """Iterative DFS over the Symbol DAG, each node visited once (by
    ``key``): no RecursionError on deep chains, no exponential re-walks
    of shared subgraphs. 'pre' yields a node before its inputs; 'post'
    after (inputs always precede consumers in 'post')."""
    seen = set()
    out = []
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            out.append(node)
            continue
        k = key(node)
        if k in seen:
            continue
        seen.add(k)
        if order == 'pre':
            out.append(node)
        else:
            stack.append((node, True))
        for i in reversed(node.inputs):
            stack.append((i, False))
    return out


def _resolve_name(op, name):
    """One naming path for nodes and pre-named nodes (auto-created
    parameters need the node's name before the node exists)."""
    from .name import current as _nm_current
    nm = _nm_current()
    if nm is not None:
        return nm.get(name, op or 'var')
    if name is None:
        base = op if op else 'var'
        Symbol._counter[0] += 1
        return f"{base}{Symbol._counter[0]}"
    return name


class Symbol:
    _counter = [0]

    def __init__(self, op=None, inputs=(), attrs=None, name=None,
                 num_outputs=1, out_index=0, pre_resolved=False):
        self.op = op                  # None => variable
        self.inputs = list(inputs)
        self.attrs = dict(attrs or {})
        name = name if pre_resolved else _resolve_name(op, name)
        self._name = name
        self.num_outputs = num_outputs
        self.out_index = out_index
        # node identity, shared by the indexed output views of one node;
        # variables share it by name so rebuilt graphs bind consistently
        Symbol._counter[0] += 1
        self._uid = name if op is None else Symbol._counter[0]

    # ---- introspection ----------------------------------------------------
    @property
    def name(self):
        return self._name

    def list_arguments(self):
        seen = []
        for s in _iter_nodes(self, 'pre'):
            if s.op is None and s._name not in seen \
                    and not s.attrs.get('__aux__'):
                seen.append(s._name)
        return seen

    def list_outputs(self):
        return [self._name + '_output']

    def list_auxiliary_states(self):
        """Variables carrying the ``__aux__`` marker (the auto-created
        BatchNorm moving statistics): allocated by the executors, without
        gradient or optimizer update."""
        seen = []
        for s in _iter_nodes(self, 'pre'):
            if s.op is None and s.attrs.get('__aux__') \
                    and s._name not in seen:
                seen.append(s._name)
        return seen

    def get_internals(self):
        return _SymbolList(_iter_nodes(self, 'post'))

    def attr(self, key):
        return self.attrs.get(key)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            if self.num_outputs == 1:
                if idx != 0:
                    raise MXNetError("index out of range")
                return self
            if not 0 <= idx < self.num_outputs:
                raise MXNetError("index out of range")
            view = Symbol.__new__(Symbol)
            view.op = self.op
            view.inputs = list(self.inputs)
            view.attrs = dict(self.attrs)
            view._name = self._name   # verbatim: no NameManager re-prefix
            view.num_outputs = self.num_outputs
            view.out_index = idx
            view._uid = self._uid     # same node, another output slot
            return view
        raise MXNetError("Symbol only supports integer indexing")

    # ---- graph building ---------------------------------------------------
    def _bin(self, other, opname, scalar_op):
        if isinstance(other, Symbol):
            return _apply(opname, [self, other], {})
        return _apply(scalar_op, [self], {'scalar': other})

    def __add__(self, other):
        return self._bin(other, 'broadcast_add', 'plus_scalar')

    __radd__ = __add__

    def __sub__(self, other):
        return self._bin(other, 'broadcast_sub', 'minus_scalar')

    def __rsub__(self, other):
        return _apply('rminus_scalar', [self], {'scalar': other})

    def __mul__(self, other):
        return self._bin(other, 'broadcast_mul', 'mul_scalar')

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._bin(other, 'broadcast_div', 'div_scalar')

    def __rtruediv__(self, other):
        return _apply('rdiv_scalar', [self], {'scalar': other})

    def __pow__(self, other):
        return self._bin(other, 'broadcast_power', 'power_scalar')

    def __neg__(self):
        return _apply('negative', [self], {})

    # ---- evaluation -------------------------------------------------------
    def eval_dict(self, bindings):
        """Evaluate eagerly given {name: NDArray or tensor}."""
        out, _ = _evaluate(self, {k: (v._data if isinstance(v, NDArray)
                                      else v)
                                  for k, v in bindings.items()})
        return NDArray(out)

    def eval(self, ctx=None, **kwargs):
        return [self.eval_dict(kwargs)]

    def infer_shape(self, **shapes):
        """(argument shapes, output shapes, auxiliary state shapes) from
        the shapes given (weights inferred from the data as at bind), or
        (None, None, None) where an argument stays unknown."""
        inferred, out = _propagate_shapes(self, shapes)
        names = self.list_arguments()
        aux = self.list_auxiliary_states()
        if out is None or any(n not in inferred for n in names + aux):
            return None, None, None
        return ([inferred[n] for n in names], [out],
                [inferred[n] for n in aux])

    def infer_type(self, **types):
        return ([onp.float32] * len(self.list_arguments()), [onp.float32],
                [onp.float32] * len(self.list_auxiliary_states()))

    # ---- binding ----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req='write', type_dict=None,
                    group2ctx=None, **shapes):
        """An Executor with every argument and auxiliary state allocated
        (zeros; variances one) from the given shapes, the rest inferred
        (ref: symbol.py:1507 simple_bind). ``type_dict`` gives a dtype by
        name (default float32); ``grad_req`` is one request for all, or a
        dict or list by argument; ``group2ctx`` maps ``__ctx_group__``
        attributes (``mx.AttrScope(ctx_group=...)``) to contexts."""
        names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        device = _ctx_device(ctx)
        group_dev = _group_devices(group2ctx)
        arg_dev = dict.fromkeys(names + aux_names, device)
        if group_dev:
            for node in _iter_nodes(self, 'pre', key=lambda n: n._uid):
                if node.op is None and \
                        node.attrs.get('__ctx_group__') in group_dev:
                    arg_dev[node._name] = \
                        group_dev[node.attrs['__ctx_group__']]
        missing = [n for n in names + aux_names if n not in shapes]
        if missing:
            inferred = infer_shapes_partial(self, shapes)
            for n in missing:
                if n in inferred:
                    shapes[n] = inferred[n]
        types = {k: torch_dtype(v) for k, v in (type_dict or {}).items()}
        reqs = _grad_reqs(grad_req, names)

        def alloc(n, what):
            if n not in shapes:
                raise MXNetError(f"simple_bind: no shape for {what} {n} (not "
                                 f"inferable from the given shapes)")
            return NDArray(torch.zeros(tuple(shapes[n]), device=arg_dev[n],
                                       dtype=types.get(n, torch.float32)))
        args = {n: alloc(n, 'argument') for n in names}
        aux = {}
        for n in aux_names:
            aux[n] = alloc(n, 'auxiliary state')
            if n.endswith(('moving_var', 'running_var')):
                aux[n]._data = torch.ones_like(aux[n]._data)
        grads = {n: NDArray(torch.zeros_like(args[n]._data))
                 for n in names if reqs[n] != 'null'}
        return Executor(self, args, grads, reqs, ctx, group2ctx=group2ctx,
                        aux_states=aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req='write',
             aux_states=None, group2ctx=None, **kwargs):
        """An Executor over the given arrays (ref: symbol.py:1809 bind):
        ``args``, ``args_grad`` and ``aux_states`` as lists in
        ``list_arguments``/``list_auxiliary_states`` order or dicts."""
        names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, dict(args or {}), dict(args_grad or {}),
                        _grad_reqs(grad_req, names), ctx,
                        group2ctx=group2ctx, aux_states=aux_states)

    # ---- serialization ----------------------------------------------------
    def tojson(self):
        nodes = []
        index = {}  # node uid -> node index (indexed views share the uid)
        names = {}  # serialized name -> uid (duplicate-name guard)
        for s in _iter_nodes(self, 'post', key=lambda n: n._uid):
            in_refs = [(index[i._uid], i.out_index) for i in s.inputs]
            if s._name in names and names[s._name] != s._uid:
                raise MXNetError(
                    f"duplicate node name '{s._name}' in graph; names must "
                    "be unique to serialize")
            names[s._name] = s._uid
            index[s._uid] = len(nodes)
            nodes.append({'op': s.op or 'null', 'name': s._name,
                          'attrs': {k: str(v) for k, v in s.attrs.items()},
                          'inputs': [[i, oi, 0] for i, oi in in_refs]})
        return json.dumps({'nodes': nodes,
                           'heads': [[index[self._uid], self.out_index, 0]],
                           'mxnet_tpu_version': 2}, indent=2)

    def save(self, fname):
        from .serialization import atomic_write_file
        atomic_write_file(fname, self.tojson().encode('utf-8'))

    def __repr__(self):
        return f"<Symbol {self._name}>"


class _SymbolList(list):
    def __getitem__(self, key):
        if isinstance(key, str):
            for s in self:
                if s.name == key or s.name + '_output' == key:
                    return s
            raise MXNetError(f"no internal symbol {key}")
        return super().__getitem__(key)


def _clean_attrs(node):
    return {k: v for k, v in node.attrs.items() if not k.startswith('__')}


def _pick(value, index):
    return value[index] if isinstance(value, (tuple, list)) else value


def _call(node, ins):
    opdef = get_op(node.op)
    try:
        return opdef.fn(*ins, **_clean_attrs(node))
    except (MXNetError, torch.cuda.OutOfMemoryError):
        raise
    except (TypeError, ValueError, IndexError, RuntimeError) as e:
        raise MXNetError(f"Error in operator {node._name} ({node.op}): "
                         f"{e}") from e


def _evaluate(root, bindings, device_map=None, hook=None):
    """(root's value, {node uid: value}): every node once, inputs before
    consumers, iteratively. ``device_map`` ({group or None: device}) runs
    each node on its group's device, its inputs moved there first (the
    reference's cross_device_copy); ``hook(node, value)`` sees every
    node's value."""
    cache = {}
    for node in _iter_nodes(root, 'post', key=lambda n: n._uid):
        if node.op is None:
            if node._name not in bindings:
                raise MXNetError(f"unbound variable {node._name}")
            out = bindings[node._name]
        else:
            ins = [_pick(cache[i._uid], i.out_index) for i in node.inputs]
            if device_map:
                target = device_map.get(node.attrs.get('__ctx_group__')) \
                    or device_map[None]
                ins = [t.to(target) if isinstance(t, torch.Tensor) else t
                       for t in ins]
            out = _call(node, ins)
        if hook is not None:
            hook(node, out)
        cache[node._uid] = out
    return _pick(cache[root._uid], root.out_index), cache


def _op_arity(opname, attrs):
    """Static output count of an op node (multi-output ops declare it in
    the registry; -1 means set by the arguments)."""
    n = get_op(opname).num_outputs
    if n != -1:
        return n
    if opname in ('split', 'SliceChannel', 'slice_channel'):
        return int(attrs.get('num_outputs', 1))
    if opname == 'topk':
        return 2 if attrs.get('ret_typ') == 'both' else 1
    if opname == 'rnn':
        return 3 if attrs.get('mode', 'lstm') == 'lstm' else 2
    return 1


# ---------------------------------------------------------------------------
# Auto-created parameters: sym.FullyConnected(x, num_hidden=N) with only
# its data input gets fcN_weight / fcN_bias variables, their shapes
# inferred at bind. Table: op -> [(suffix, shape_rule(data_shape, attrs),
# skip_if)], the JAX package's (symbol.py:386-428).
# ---------------------------------------------------------------------------

def _truthy(v):
    return v in (True, 1, '1', 'true', 'True')


def _prod(t):
    out = 1
    for s in t:
        out *= int(s)
    return out


def _t2(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x) for x in v)


_AUTO_PARAMS = {
    'fully_connected': [
        ('weight', lambda d, a: (int(a['num_hidden']),
                                 _prod(d[1:])
                                 if _truthy(a.get('flatten', True))
                                 else int(d[-1])), None),
        ('bias', lambda d, a: (int(a['num_hidden']),),
         lambda a: _truthy(a.get('no_bias', False))),
    ],
    'convolution': [
        ('weight', lambda d, a: (int(a['num_filter']), int(d[1]))
         + _t2(a['kernel']), None),
        ('bias', lambda d, a: (int(a['num_filter']),),
         lambda a: _truthy(a.get('no_bias', False))),
    ],
    'deconvolution': [
        # MXNet's layout: (in_channels, num_filter, kh, kw)
        ('weight', lambda d, a: (int(d[1]), int(a['num_filter']))
         + _t2(a['kernel']), None),
        ('bias', lambda d, a: (int(a['num_filter']),),
         lambda a: _truthy(a.get('no_bias', True))),
    ],
    # a suffix starting with '!' marks an auxiliary state (no gradient, no
    # optimizer update: the reference's mutable inputs)
    'batch_norm': [
        ('gamma', lambda d, a: (int(d[1]),), None),
        ('beta', lambda d, a: (int(d[1]),), None),
        ('!moving_mean', lambda d, a: (int(d[1]),), None),
        ('!moving_var', lambda d, a: (int(d[1]),), None),
    ],
    'layer_norm': [
        ('gamma', lambda d, a: (int(d[int(a.get('axis', -1))]),), None),
        ('beta', lambda d, a: (int(d[int(a.get('axis', -1))]),), None),
    ],
    'instance_norm': [
        ('gamma', lambda d, a: (int(d[1]),), None),
        ('beta', lambda d, a: (int(d[1]),), None),
    ],
    'embedding': [
        ('weight', lambda d, a: (int(a['input_dim']),
                                 int(a['output_dim'])), None),
    ],
}


def _softmax_label(d, a):
    if _truthy(a.get('multi_output', False)) and len(d) > 2:
        return (int(d[0]),) + tuple(int(x) for x in d[2:])
    return tuple(int(x) for x in d[:-1])


# op -> rule(data shape, attrs) for the label, its second input (MXNet
# infers it backwards from the output; here from the data)
_LABEL_RULES = {
    'softmax_output': _softmax_label, 'SoftmaxOutput': _softmax_label,
    'linear_regression_output': lambda d, a: tuple(d),
    'mae_regression_output': lambda d, a: tuple(d),
    'logistic_regression_output': lambda d, a: tuple(d),
}


# op -> fn(input shapes, attrs) -> output shape or list of shapes, for the
# ops shape inference must not run on meta tensors
_SHAPE_RULES = {
    'multi_head_attention': lambda shapes, attrs: shapes[0],
}


def register_shape_rule(opname, rule):
    """Give op ``opname`` a shape rule, ``rule(input shapes, attrs)`` ->
    its output shape (a tuple, or a list of tuples for several), used by
    shape inference in place of a run on meta tensors."""
    _SHAPE_RULES[opname] = rule


def _meta_shapes(node, in_shapes):
    """The output shape(s) of ``node`` for these input shapes: its shape
    rule, else one run of the op on meta tensors (float32, then int32
    where float32 fails); None where neither works."""
    rule = _SHAPE_RULES.get(node.op)
    if rule is not None:
        out = rule(in_shapes, node.attrs)
        return [tuple(o) for o in out] if isinstance(out, list) \
            else tuple(out)
    fn = get_op(node.op).fn
    clean = _clean_attrs(node)
    for dtype in (torch.float32, torch.int32):
        try:
            with torch.no_grad():
                out = fn(*[torch.empty(s, dtype=dtype, device='meta')
                           for s in in_shapes], **clean)
        except Exception:   # noqa: BLE001  (any failure: try the next)
            continue
        if isinstance(out, (list, tuple)):
            return [tuple(o.shape) for o in out]
        return tuple(out.shape)
    return None


def infer_shapes_partial(root, known):
    """Forward shape propagation over the DAG: {variable name: shape} for
    every variable resolvable from ``known`` (typically the data shapes):
    auto-created parameters through their shape rules, op outputs
    through ``_meta_shapes`` (ref: nnvm InferShape)."""
    return _propagate_shapes(root, known)[0]


def _propagate_shapes(root, known):
    """(infer_shapes_partial's dict, the root's output shape or None)."""
    shape_of = {}    # uid -> tuple (one output) | list of tuples

    def shape_for(node):
        raw = shape_of.get(node._uid)
        if raw is None:
            return None
        return raw[node.out_index] if isinstance(raw, list) else raw

    result = {}
    for node in _iter_nodes(root, 'post', key=lambda n: n._uid):
        if node.op is None:
            shp = known.get(node._name) or node.attrs.get('__shape__')
            if shp is not None:
                shape_of[node._uid] = tuple(shp)
                result[node._name] = tuple(shp)
            continue
        dshape = shape_for(node.inputs[0]) if node.inputs else None
        # explicit parameter variables take the auto-created ones' rules
        # by position, as nnvm infers them; then the label rules
        specs = [r for _sfx, r, skip in _AUTO_PARAMS.get(node.op, ())
                 if skip is None or not skip(node.attrs)]
        rules = dict(zip(range(1, len(node.inputs)), specs))
        if node.op in _LABEL_RULES and len(node.inputs) > 1:
            rules[1] = _LABEL_RULES[node.op]
        for pos, v in enumerate(node.inputs[1:], 1):
            if v.op is not None or v._uid in shape_of or dshape is None:
                continue
            rule = getattr(v, '_shape_rule', None) or rules.get(pos)
            if rule is None:
                continue
            try:
                shp = tuple(rule(dshape, node.attrs))
            except (KeyError, TypeError, ValueError, IndexError):
                continue
            shape_of[v._uid] = shp
            result[v._name] = shp
        in_shapes = [shape_for(i) for i in node.inputs]
        if any(s is None for s in in_shapes):
            continue
        out = _meta_shapes(node, in_shapes)
        if out is not None:
            shape_of[node._uid] = out
    return result, shape_for(root)


def _apply(opname, inputs, attrs, name=None):
    from .attribute import current_attrs
    attrs = current_attrs(attrs)
    specs = _AUTO_PARAMS.get(opname)
    resolved = None
    if specs is not None and len(inputs) == 1:
        # only the data input given: make {node}_{suffix} parameter
        # variables carrying their shape rules for bind-time inference
        resolved = _resolve_name(opname, name)
        for suffix, rule, skip in specs:
            if skip is not None and skip(attrs):
                continue
            aux = suffix.startswith('!')
            clean_suffix = suffix[1:] if aux else suffix
            v = Symbol(None, (), None, f"{resolved}_{clean_suffix}",
                       pre_resolved=True)
            v._shape_rule = rule
            # the markers serialize, so a round-tripped graph re-binds
            v.attrs['__auto_param__'] = suffix
            if aux:
                v.attrs['__aux__'] = True
            inputs = list(inputs) + [v]
    n = _op_arity(opname, attrs)
    s = Symbol(opname, inputs, attrs, resolved or name, num_outputs=n,
               pre_resolved=resolved is not None)
    if n == 1:
        return s
    return tuple(s[i] for i in range(n))


def var(name, attr=None, shape=None, dtype=None, init=None, stype=None,
        lr_mult=None, wd_mult=None, **kwargs):
    """A graph input (ref: symbol.py var/Variable); ``shape`` is kept as
    the ``__shape__`` hint, the other keywords change nothing, as in the
    JAX package."""
    from .attribute import current_attrs
    s = Symbol(None, (), current_attrs(attr), name)
    if shape is not None:
        s.attrs['__shape__'] = shape
    return s


Variable = var


def zeros(shape, dtype='float32', **kwargs):
    return _apply('zeros', [], {'shape': shape, 'dtype': dtype})


def ones(shape, dtype='float32', **kwargs):
    return _apply('ones', [], {'shape': shape, 'dtype': dtype})


def load(fname):
    with open(fname) as f:
        return fromjson(f.read())


def fromjson(js):
    data = json.loads(js)
    built = []
    for node in data['nodes']:
        inputs = []
        for ref in node['inputs']:
            src = built[ref[0]]
            oi = ref[1] if len(ref) > 1 else 0
            inputs.append(src[oi] if src.num_outputs > 1 else src)
        attrs = {}
        for k, v in node.get('attrs', {}).items():
            try:
                attrs[k] = eval(v, {'__builtins__': {}})  # literals only
            except Exception:   # noqa: BLE001  (a plain string)
                attrs[k] = v
        if node['op'] == 'null':
            v = var(node['name'])
            v.attrs.update(attrs)   # __shape__/__auto_param__ markers
            built.append(v)
        else:
            n = _op_arity(node['op'], attrs)
            built.append(Symbol(node['op'], inputs, attrs, node['name'],
                                num_outputs=n))
    head = data['heads'][0]
    s = built[head[0]]
    oi = head[1] if len(head) > 1 else 0
    return s[oi] if s.num_outputs > 1 else s


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _ctx_device(ctx):
    """The torch device of an executor's context: the card for None
    (the CPU inside ``with mx.cpu():``), raising without one."""
    if isinstance(ctx, Context):
        return ctx.device
    return resolve_device(ctx)


def _group_devices(group2ctx):
    return {g: _ctx_device(c) for g, c in (group2ctx or {}).items()}


def _grad_reqs(grad_req, names):
    """{argument: 'write' | 'add' | 'null'} from one request, a dict
    (missing names 'null') or a list in argument order."""
    if isinstance(grad_req, str):
        reqs = dict.fromkeys(names, grad_req)
    elif isinstance(grad_req, dict):
        reqs = {n: grad_req.get(n, 'null') for n in names}
    else:
        reqs = dict(zip(names, grad_req))
    bad = {r for r in reqs.values()} - {'write', 'add', 'null', 'inplace'}
    if bad:
        raise MXNetError(f"unknown grad_req {sorted(bad)}")
    return {n: 'write' if r == 'inplace' else r for n, r in reqs.items()}


def _as_tensor(v, like):
    t = v._data if isinstance(v, NDArray) else \
        v if isinstance(v, torch.Tensor) else torch.as_tensor(onp.asarray(v))
    return t.detach().to(device=like.device, dtype=like.dtype)


_BATCH_NORMS = ('batch_norm', 'sync_batch_norm_op')


def _new_moving_stats(root, cache):
    """(variable name, new value) for the moving mean and variance (the
    second and third outputs) of each BatchNorm node of an evaluation,
    whose fourth and fifth inputs are variables."""
    out = []
    for node in _iter_nodes(root, 'pre', key=lambda n: n._uid):
        if node.op not in _BATCH_NORMS or len(node.inputs) < 5:
            continue
        vals = cache[node._uid]
        out += [(v._name, vals[slot].detach())
                for slot, v in ((1, node.inputs[3]), (2, node.inputs[4]))
                if v.op is None]
    return out


class Executor:
    """Runs a bound Symbol (ref: include/mxnet/executor.h:53, python
    executor.py): ``forward`` evaluates the graph node by node, ``backward``
    writes each argument's gradient into ``grad_dict`` by its request
    ('write' replaces, 'add' accumulates, 'null' skips; ``out_grads``
    default to ones). The graph of a training forward stays alive until
    the next forward, so ``backward`` may run more than once."""

    def __init__(self, symbol, args, args_grad, grad_req, ctx,
                 group2ctx=None, aux_states=None):
        self._symbol = symbol
        self.arg_dict = args
        self.grad_dict = args_grad
        self.aux_dict = dict(aux_states or {})
        self._names = symbol.list_arguments()
        missing = [n for n in self._names if n not in args]
        if missing:
            raise MXNetError(f"bind: no array for arguments {missing}")
        self._grad_req = grad_req if isinstance(grad_req, dict) else \
            _grad_reqs(grad_req, self._names)
        self._ctx = ctx
        self._group2ctx = group2ctx
        self._device_map = None
        if group2ctx:
            self._device_map = _group_devices(group2ctx)
            self._device_map[None] = _ctx_device(ctx)
        self.outputs = []
        self._head = None      # the training forward's output
        self._leaves = None    # {argument: the tensor differentiated}
        self._monitor = None   # set by monitor.Monitor.install

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, value)`` for every node output on every
        forward (ref: executor.py set_monitor_callback)."""
        class _AlwaysOn:
            activated = True

            def __init__(self, cb, mall):
                self._cb = cb
                self.monitor_all = mall

            def _record(self, name, value):
                self._cb(name, value)

        self._monitor = None if callback is None else \
            _AlwaysOn(callback, monitor_all)

    def _hook(self):
        mon = self._monitor
        if mon is None or not mon.activated:
            return None

        def record(node, value):
            if node.op is None and not getattr(mon, 'monitor_all', False):
                return
            vals = value if isinstance(value, tuple) else (value,)
            for vi, v in enumerate(vals):
                nm = node._name + (f'_out{vi}' if len(vals) > 1 else
                                   '_output')
                mon._record(nm, NDArray(v.detach()))
        return record

    def forward(self, is_train=False, **kwargs):
        t0 = None
        if _telem['on']:
            import time as _time
            t0 = _time.perf_counter()
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k!r}")
            dst = self.arg_dict[k]
            dst._data = _as_tensor(v, dst._data)
        self._head = self._leaves = None   # free the last step's graph
        need_grad = is_train and any(r != 'null'
                                     for r in self._grad_req.values())
        bind, leaves = {}, {}
        for n in self._names:
            t = self.arg_dict[n]._data
            if need_grad and self._grad_req[n] != 'null' and \
                    t.is_floating_point():
                t = leaves[n] = t.detach().requires_grad_()
            bind[n] = t
        for n, a in self.aux_dict.items():
            bind[n] = a._data
        training = state.is_training
        state.is_training = bool(is_train)
        try:
            with torch.enable_grad() if need_grad else torch.no_grad():
                out, cache = _evaluate(self._symbol, bind, self._device_map,
                                       self._hook())
        finally:
            state.is_training = training
        if is_train:
            self._write_moving_stats(cache)
        if need_grad:
            self._head, self._leaves = out, leaves
        self.outputs = [NDArray(out.detach())]
        if t0 is not None:
            from . import telemetry as _telemetry
            _telemetry.inc('mxnet_tpu_executor_forward_total')
            _telemetry.observe('mxnet_tpu_executor_forward_seconds',
                               _time.perf_counter() - t0)
        return self.outputs

    def _write_moving_stats(self, cache):
        """Each BatchNorm node's new moving statistics into the auxiliary
        states it read, in place."""
        with torch.no_grad():
            for name, t in _new_moving_stats(self._symbol, cache):
                dst = self.aux_dict.get(name)
                if dst is not None:
                    dst._data.copy_(t)

    def backward(self, out_grads=None):
        if self._head is None:
            raise MXNetError("call forward(is_train=True) before backward")
        head = self._head
        if out_grads is None:
            ct = torch.ones_like(head)
        else:
            if isinstance(out_grads, (list, tuple)):
                out_grads = out_grads[0]
            ct = _as_tensor(out_grads, head)
        names = [n for n in self._leaves
                 if self.grad_dict.get(n) is not None]
        if not names or not head.requires_grad:
            grads = [None] * len(names)
        else:
            grads = torch.autograd.grad(
                [head], [self._leaves[n] for n in names], grad_outputs=[ct],
                retain_graph=True, allow_unused=True)
        for n, g in zip(names, grads):
            buf = self.grad_dict[n]
            g = torch.zeros_like(buf._data) if g is None else \
                g.detach().to(buf._data.dtype)
            if self._grad_req[n] == 'add':
                buf._data = buf._data + g
            else:
                buf._data = g

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """An executor of the same graph at new argument shapes: unchanged
        arguments (the weights) and the auxiliary states are shared."""
        new_args = {}
        for n in self._names:
            cur = self.arg_dict[n]._data
            shape = tuple(kwargs.get(n, cur.shape))
            new_args[n] = self.arg_dict[n] if shape == tuple(cur.shape) \
                else NDArray(torch.zeros(shape, device=cur.device,
                                         dtype=cur.dtype))
        grads = {n: NDArray(torch.zeros_like(new_args[n]._data))
                 for n in self._names if self._grad_req[n] != 'null'}
        return Executor(self._symbol, new_args, grads, self._grad_req,
                        self._ctx, group2ctx=self._group2ctx,
                        aux_states=self.aux_dict)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for src, dst_dict in ((arg_params, self.arg_dict),
                              (aux_params or {}, self.aux_dict)):
            for name, arr in src.items():
                if name in dst_dict:
                    dst = dst_dict[name]
                    dst._data = _as_tensor(arr, dst._data)
                elif not allow_extra_params:
                    raise MXNetError(f"extra param {name}")


class _OpMaker:
    """``sym.<op>`` wrappers for the registered ops, mirroring ``nd.<op>``."""

    @staticmethod
    def make(opname):
        def fn(*args, name=None, **kwargs):
            sym_inputs = []
            for i, a in enumerate(args):
                if isinstance(a, (tuple, list)):
                    raise MXNetError(
                        f"sym.{opname}: positional input {i} is a "
                        f"{type(a).__name__}, not a Symbol (a multi-output "
                        f"op's outputs: index it, e.g. bn[0])")
                if isinstance(a, Symbol):
                    sym_inputs.append(a)
            attrs = {k: v for k, v in kwargs.items()
                     if not isinstance(v, Symbol)}
            sym_inputs += [v for v in kwargs.values()
                           if isinstance(v, Symbol)]
            return _apply(opname, sym_inputs, attrs, name)
        fn.__name__ = fn.__qualname__ = opname
        return fn

    @staticmethod
    def populate(namespace):
        for opname in _OP_REGISTRY:
            if opname not in namespace:
                namespace[opname] = _OpMaker.make(opname)


_OpMaker.populate(globals())

# MXNet's spellings (FullyConnected, _Plus, _contrib_ROIAlign, ...) are
# the registry's aliases (ops/ref_aliases.py): each names the maker of its
# canonical op, as the JAX package's CamelCase table does. The legacy
# names the alias table leaves out or maps elsewhere keep the JAX
# package's meaning (symbol.py:768-779).
for _alias, _canonical in _OP_ALIASES.items():
    globals().setdefault(_alias, globals()[_canonical])
for _camel, _snake in {
        'SoftmaxOutput': 'softmax_output', 'SliceChannel': 'split',
        'RNN': 'rnn', 'LRN': 'lrn', 'SequenceLast': 'sequence_last',
        'SequenceReverse': 'sequence_reverse'}.items():
    globals()[_camel] = globals()[_snake]


def __getattr__(name):
    """``sym.<op>`` for an op (or alias) registered after this module was
    imported (``operator.register``'s ``Custom``), resolved through
    ``get_op``."""
    try:
        opname = get_op(name).name
    except MXNetError:
        raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no "
                             f"attribute {name!r}") from None
    fn = globals()[name] = globals().get(opname) or _OpMaker.make(opname)
    return fn
