"""Symbol/Gluon -> ONNX export (counterpart of
``mxnet_tpu/contrib/onnx/mx2onnx.py``, ref: python/mxnet/contrib/onnx/
mx2onnx/export_model.py + _op_translations.py).

Walks the Symbol DAG (a HybridBlock is traced into one first, as
``export`` traces it) and emits one ONNX node, or a small group, per
node; parameters become graph initializers, read back from wherever they
live (the card or the CPU). The protobuf is written directly at opset 17 (no ``onnx`` package). The
translation table is the JAX package's, so both packages export a net to
the same nodes, attributes and initializers. A HybridBlock is traced
under a fresh ``NameManager``, so its nodes are named alike at every
export and the same weights write the same bytes.
"""
from __future__ import annotations

import numpy as onp

from . import onnx_repr as O

__all__ = ['export_model']


def _tuple(v, n=2):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


class _Ctx:
    def __init__(self, params):
        self.nodes = []          # NodeProto bytes, topo order
        self.initializers = []   # TensorProto bytes
        self.init_names = set()
        self.params = params
        self.counter = 0

    def uniq(self, base):
        self.counter += 1
        return f"{base}_{self.counter}"

    def add_init(self, name, arr):
        if name not in self.init_names:
            self.initializers.append(O.tensor(name, onp.asarray(arr)))
            self.init_names.add(name)
        return name

    def const(self, base, arr):
        return self.add_init(self.uniq(base), arr)

    def emit(self, op_type, inputs, outputs, attrs=None, name=''):
        self.nodes.append(O.node(op_type, inputs, outputs,
                                 name or self.uniq(op_type), attrs))


def _conv(ctx, s, ins, out):
    a = s.attrs
    kernel = _tuple(a.get('kernel'))
    nd = len(kernel)
    pad = _tuple(a.get('pad', 0), nd)
    attrs = {'kernel_shape': list(kernel),
             'strides': list(_tuple(a.get('stride', 1), nd)),
             'dilations': list(_tuple(a.get('dilate', 1), nd)),
             'pads': list(pad) * 2,
             'group': int(a.get('num_group', 1))}
    ctx.emit('Conv', ins, [out], attrs)


def _fc(ctx, s, ins, out):
    a = s.attrs
    flatten = a.get('flatten', True)
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 and not a.get('no_bias', False) else None
    if flatten:
        flat = ctx.uniq('flatten_out')
        ctx.emit('Flatten', [x], [flat], {'axis': 1})
        gemm_in = [flat, w] + ([b] if b else [])
        if not b:
            zeros = ctx.const('fc_zero_bias',
                              onp.zeros((int(a['num_hidden']),), onp.float32))
            gemm_in = [flat, w, zeros]
        ctx.emit('Gemm', gemm_in, [out], {'transB': 1, 'alpha': 1.0,
                                          'beta': 1.0})
    else:
        # y = x @ W.T (+ b) on the last axis
        wt = ctx.uniq('weight_T')
        ctx.emit('Transpose', [w], [wt], {'perm': [1, 0]})
        mm = ctx.uniq('matmul_out') if b else out
        ctx.emit('MatMul', [x, wt], [mm])
        if b:
            ctx.emit('Add', [mm, b], [out])


def _act(ctx, s, ins, out):
    table = {'relu': 'Relu', 'sigmoid': 'Sigmoid', 'tanh': 'Tanh',
             'softrelu': 'Softplus', 'softsign': 'Softsign'}
    act = s.attrs.get('act_type', 'relu')
    if act not in table:
        raise ValueError(f"ONNX export: unsupported activation {act}")
    ctx.emit(table[act], ins, [out])


def _leaky(ctx, s, ins, out):
    act = s.attrs.get('act_type', 'leaky')
    if act == 'leaky':
        ctx.emit('LeakyRelu', [ins[0]], [out],
                 {'alpha': float(s.attrs.get('slope', 0.25))})
    elif act == 'elu':
        ctx.emit('Elu', [ins[0]], [out],
                 {'alpha': float(s.attrs.get('slope', 0.25))})
    elif act == 'prelu':
        ctx.emit('PRelu', ins[:2], [out])
    elif act == 'gelu':
        # erf-formulation: x * 0.5 * (1 + erf(x / sqrt(2)))
        div = ctx.const('gelu_sqrt2', onp.array(onp.sqrt(2.0), onp.float32))
        xd = ctx.uniq('gelu_xd')
        ctx.emit('Div', [ins[0], div], [xd])
        er = ctx.uniq('gelu_erf')
        ctx.emit('Erf', [xd], [er])
        one = ctx.const('gelu_one', onp.array(1.0, onp.float32))
        half = ctx.const('gelu_half', onp.array(0.5, onp.float32))
        p1 = ctx.uniq('gelu_p1')
        ctx.emit('Add', [er, one], [p1])
        ph = ctx.uniq('gelu_ph')
        ctx.emit('Mul', [p1, half], [ph])
        ctx.emit('Mul', [ins[0], ph], [out])
    else:
        raise ValueError(f"ONNX export: unsupported leaky_relu {act}")


def _bn(ctx, s, ins, out):
    if s.out_index != 0:
        raise ValueError("ONNX export: running-stat outputs of batch_norm "
                         "are not exportable")
    attrs = {'epsilon': float(s.attrs.get('eps', 1e-3)),
             'momentum': float(s.attrs.get('momentum', 0.9))}
    ins = list(ins[:5])
    if s.attrs.get('fix_gamma', True):
        # mx fix_gamma treats gamma as ones; ONNX BN always applies scale,
        # so bake in a ones tensor shaped like beta/gamma
        gamma_arr = ctx.params.get(ins[1])
        shape = (gamma_arr.shape if gamma_arr is not None
                 else ctx.params[ins[2]].shape)
        ins[1] = ctx.const('bn_fixed_gamma', onp.ones(shape, onp.float32))
    ctx.emit('BatchNormalization', ins, [out], attrs)


def _pool(ctx, s, ins, out):
    a = s.attrs
    ptype = a.get('pool_type', 'max')
    if a.get('global_pool', False):
        op = {'max': 'GlobalMaxPool', 'avg': 'GlobalAveragePool'}.get(ptype)
        if op is None:
            raise ValueError(f"ONNX export: global {ptype} pool unsupported")
        ctx.emit(op, ins, [out])
        return
    kernel = _tuple(a.get('kernel'))
    nd = len(kernel)
    # a pooling symbol without a 'stride' attr computes stride=1
    # (ops/nn.py pooling default) — export must match, not kernel-stride
    attrs = {'kernel_shape': list(kernel),
             'strides': list(_tuple(a.get('stride', 1), nd)),
             'pads': list(_tuple(a.get('pad', 0), nd)) * 2}
    if ptype == 'avg':
        attrs['count_include_pad'] = int(a.get('count_include_pad', True))
    op = {'max': 'MaxPool', 'avg': 'AveragePool'}.get(ptype)
    if op is None:
        raise ValueError(f"ONNX export: pool_type {ptype} unsupported")
    ctx.emit(op, ins, [out], attrs)


def _reshape(ctx, s, ins, out):
    shape = s.attrs.get('shape')
    if shape is None:
        raise ValueError("ONNX export: reshape needs a static shape attr")
    shape = [int(x) for x in (shape if isinstance(shape, (list, tuple))
                              else [shape])]
    if any(x in (-2, -3, -4) for x in shape):
        raise ValueError("ONNX export: reshape special codes -2/-3/-4 "
                         "unsupported")
    shp = ctx.const('reshape_shape', onp.array(shape, onp.int64))
    ctx.emit('Reshape', [ins[0], shp], [out])


def _scalar_arith(onnx_op, reverse=False):
    def h(ctx, s, ins, out):
        c = ctx.const('scalar', onp.array(float(s.attrs.get('scalar', 0.0)),
                                          onp.float32))
        args = [c, ins[0]] if reverse else [ins[0], c]
        ctx.emit(onnx_op, args, [out])
    return h


def _binary(onnx_op):
    def h(ctx, s, ins, out):
        ctx.emit(onnx_op, ins[:2], [out])
    return h


def _unary(onnx_op, **fixed):
    def h(ctx, s, ins, out):
        ctx.emit(onnx_op, [ins[0]], [out], fixed or None)
    return h


def _softmax(ctx, s, ins, out):
    ctx.emit('Softmax', [ins[0]], [out],
             {'axis': int(s.attrs.get('axis', -1))})


def _transpose(ctx, s, ins, out):
    axes = s.attrs.get('axes')
    attrs = {'perm': [int(x) for x in axes]} if axes else None
    ctx.emit('Transpose', [ins[0]], [out], attrs)


def _concat(ctx, s, ins, out):
    ctx.emit('Concat', ins, [out],
             {'axis': int(s.attrs.get('dim', s.attrs.get('axis', 1)))})


def _dropout(ctx, s, ins, out):
    ratio = ctx.const('dropout_ratio',
                      onp.array(float(s.attrs.get('p', 0.5)), onp.float32))
    train = ctx.const('dropout_training', onp.array(False))
    ctx.emit('Dropout', [ins[0], ratio, train], [out])


def _embedding(ctx, s, ins, out):
    # mx: embedding(data=indices, weight); ONNX: Gather(weight, indices)
    idx64 = ctx.uniq('emb_idx64')
    ctx.emit('Cast', [ins[0]], [idx64], {'to': 7})
    ctx.emit('Gather', [ins[1], idx64], [out], {'axis': 0})


def _layer_norm(ctx, s, ins, out):
    ctx.emit('LayerNormalization', ins[:3], [out],
             {'axis': int(s.attrs.get('axis', -1)),
              'epsilon': float(s.attrs.get('eps', 1e-5))})


def _reduce(onnx_op):
    def h(ctx, s, ins, out):
        a = s.attrs
        axis = a.get('axis')
        attrs = {'keepdims': int(a.get('keepdims', False))}
        if axis is not None:
            axes = [int(axis)] if isinstance(axis, int) else \
                [int(x) for x in axis]
            attrs['axes'] = axes
        ctx.emit(onnx_op, [ins[0]], [out], attrs)
    return h


def _clip(ctx, s, ins, out):
    lo = ctx.const('clip_min',
                   onp.array(float(s.attrs.get('a_min', 0.0)), onp.float32))
    hi = ctx.const('clip_max',
                   onp.array(float(s.attrs.get('a_max', 0.0)), onp.float32))
    ctx.emit('Clip', [ins[0], lo, hi], [out])


def _cast(ctx, s, ins, out):
    dt = O.DTYPE_TO_ONNX[str(onp.dtype(s.attrs.get('dtype', 'float32')))]
    ctx.emit('Cast', [ins[0]], [out], {'to': dt})


def _flatten(ctx, s, ins, out):
    ctx.emit('Flatten', [ins[0]], [out], {'axis': 1})


def _expand_dims(ctx, s, ins, out):
    ax = ctx.const('unsq_axes',
                   onp.array([int(s.attrs.get('axis', 0))], onp.int64))
    ctx.emit('Unsqueeze', [ins[0], ax], [out])


def _squeeze(ctx, s, ins, out):
    axis = s.attrs.get('axis')
    if axis is None:
        ctx.emit('Squeeze', [ins[0]], [out])
    else:
        axes = [int(axis)] if isinstance(axis, int) else \
            [int(x) for x in axis]
        ax = ctx.const('sq_axes', onp.array(axes, onp.int64))
        ctx.emit('Squeeze', [ins[0], ax], [out])


_TRANSLATIONS = {
    'convolution': _conv,
    'fully_connected': _fc,
    'activation': _act,
    'leaky_relu': _leaky,
    'batch_norm': _bn,
    'pooling': _pool,
    'flatten': _flatten,
    'reshape': _reshape,
    'transpose': _transpose,
    'concat': _concat,
    'dropout': _dropout,
    'embedding': _embedding,
    'layer_norm': _layer_norm,
    'softmax': _softmax,
    'log_softmax': _unary('LogSoftmax'),
    'relu': _unary('Relu'),
    'sigmoid': _unary('Sigmoid'),
    'tanh': _unary('Tanh'),
    'exp': _unary('Exp'),
    'log': _unary('Log'),
    'sqrt': _unary('Sqrt'),
    'abs': _unary('Abs'),
    'negative': _unary('Neg'),
    'erf': _unary('Erf'),
    'floor': _unary('Floor'),
    'ceil': _unary('Ceil'),
    'identity': _unary('Identity'),
    'broadcast_add': _binary('Add'), 'elemwise_add': _binary('Add'),
    'broadcast_sub': _binary('Sub'), 'elemwise_sub': _binary('Sub'),
    'broadcast_mul': _binary('Mul'), 'elemwise_mul': _binary('Mul'),
    'broadcast_div': _binary('Div'), 'elemwise_div': _binary('Div'),
    'broadcast_power': _binary('Pow'),
    'broadcast_maximum': _binary('Max'),
    'broadcast_minimum': _binary('Min'),
    'dot': _binary('MatMul'),
    'batch_dot': _binary('MatMul'),
    'plus_scalar': _scalar_arith('Add'),
    'minus_scalar': _scalar_arith('Sub'),
    'rminus_scalar': _scalar_arith('Sub', reverse=True),
    'mul_scalar': _scalar_arith('Mul'),
    'div_scalar': _scalar_arith('Div'),
    'rdiv_scalar': _scalar_arith('Div', reverse=True),
    'power_scalar': _scalar_arith('Pow'),
    'mean': _reduce('ReduceMean'),
    'sum': _reduce('ReduceSum_axesattr'),  # handled below
    'max': _reduce('ReduceMax'),
    'min': _reduce('ReduceMin'),
    'prod': _reduce('ReduceProd'),
    'clip': _clip,
    'cast': _cast,
    'expand_dims': _expand_dims,
    'squeeze': _squeeze,
}


def _emit_sum(ctx, s, ins, out):
    """ReduceSum: axes moved to an input at opset 13."""
    a = s.attrs
    axis = a.get('axis')
    attrs = {'keepdims': int(a.get('keepdims', False))}
    inputs = [ins[0]]
    if axis is not None:
        axes = [int(axis)] if isinstance(axis, int) else \
            [int(x) for x in axis]
        inputs.append(ctx.const('sum_axes', onp.array(axes, onp.int64)))
    ctx.emit('ReduceSum', inputs, [out], attrs)


_TRANSLATIONS['sum'] = _emit_sum


def export_model(sym, params, input_shapes=None, input_types=None,
                 onnx_file_path='model.onnx', input_names=('data',),
                 verbose=False, opset_version=17):
    """Export a Symbol (or HybridBlock) + params to an ONNX file
    (ref: mx2onnx/export_model.py export_model).

    sym: Symbol or HybridBlock; params: {name: NDArray}; input_shapes:
    list of shapes for each graph input. Returns onnx_file_path.
    """
    from ...gluon.block import HybridBlock
    from ...ndarray.ndarray import NDArray
    from ... import symbol as sym_mod

    if isinstance(sym, HybridBlock):
        from ...name import NameManager
        block = sym
        params = {name: p.data()
                  for name, p in block.collect_params().items()}
        inputs = [sym_mod.var(n) for n in input_names]
        # a fresh name manager: the traced nodes are named alike at every
        # export of the block, whatever symbols the process made before
        with NameManager():
            sym = block(*inputs)

    params = {k.split(':', 1)[-1]: v for k, v in params.items()}
    ctx = _Ctx(params)

    arg_names = sym.list_arguments()
    data_inputs = [n for n in arg_names if n not in params]

    # walk DAG in topo order, one ONNX node (or small group) per symbol node
    visited = {}

    def out_name(s):
        return s._name if s.num_outputs == 1 else \
            f"{s._name}_out{s.out_index}"

    def visit(s):
        key = (s._name, s.out_index)
        if key in visited:
            return visited[key]
        if s.op is None:
            visited[key] = s._name
            return s._name
        ins = [visit(i) for i in s.inputs]
        out = out_name(s)
        handler = _TRANSLATIONS.get(s.op)
        if handler is None:
            raise ValueError(
                f"ONNX export: no translation for op '{s.op}' "
                f"(node {s._name})")
        handler(ctx, s, ins, out)
        visited[key] = out
        return out

    final = visit(sym)

    for name, arr in params.items():
        if name in arg_names:
            val = arr.asnumpy() if isinstance(arr, NDArray) else \
                onp.asarray(arr)
            ctx.add_init(name, val)

    if input_shapes is None:
        input_shapes = [['N'] + ['?'] * 3] * len(data_inputs)
    graph_inputs = [O.value_info(n, list(shape))
                    for n, shape in zip(data_inputs, input_shapes)]
    graph_outputs = [O.value_info(final, None)]

    g = O.graph(ctx.nodes, 'mxnet_tpu_graph', ctx.initializers,
                graph_inputs, graph_outputs)
    m = O.model(g, opset=opset_version)
    with open(onnx_file_path, 'wb') as f:
        f.write(m)
    if verbose:
        print(f"exported {len(ctx.nodes)} nodes, "
              f"{len(ctx.initializers)} initializers -> {onnx_file_path}")
    return onnx_file_path
