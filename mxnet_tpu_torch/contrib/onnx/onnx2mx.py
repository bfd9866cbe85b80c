"""ONNX -> Symbol import (counterpart of
``mxnet_tpu/contrib/onnx/onnx2mx.py``, ref: python/mxnet/contrib/onnx/
onnx2mx/_import_helper.py + _op_translations.py).

``import_model`` gives a port Symbol with its parameters as NDArrays on
the current context (the card unless a ``with mx.cpu():`` scope says
otherwise); ``import_to_gluon(ctx=)`` a ``SymbolBlock`` whose parameters
live on ``ctx`` (the card for None). A file the JAX package exported
imports here, and the other way round.
"""
from __future__ import annotations

import numpy as onp

from . import onnx_repr as O

__all__ = ['import_model', 'import_to_gluon']


def _ints(v):
    return [int(x) for x in v]


class _Importer:
    def __init__(self, model):
        self.model = model
        self.inits = model['initializers']
        self.env = {}         # ONNX value name -> Symbol
        self.arg_params = {}  # var name -> numpy array
        self.consumed = set()

    def build(self):
        from ... import symbol as sym_mod
        self.sym_mod = sym_mod
        for name, shape, _ in self.model['inputs']:
            if name not in self.inits:
                self.env[name] = sym_mod.var(name)
        for node in self.model['nodes']:
            self._convert(node)
        outs = []
        for name, _, _ in self.model['outputs']:
            outs.append(self._get(name))
        return outs

    def _get(self, name):
        """Symbol for a value name; initializers become param vars."""
        if name in self.env:
            return self.env[name]
        if name in self.inits:
            v = self.sym_mod.var(name)
            self.arg_params[name] = self.inits[name]
            self.env[name] = v
            self.consumed.add(name)
            return v
        raise ValueError(f"ONNX import: undefined value '{name}'")

    def _const_value(self, name):
        """Numeric value of a name that must be a constant initializer."""
        if name in self.inits:
            self.consumed.add(name)
            return self.inits[name]
        raise ValueError(f"ONNX import: '{name}' must be a constant")

    def _convert(self, node):
        op = node['op_type']
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"ONNX import: unsupported op '{op}'")
        out = handler(node)
        outputs = node['outputs']
        if isinstance(out, (list, tuple)):
            for name, s in zip(outputs, out):
                self.env[name] = s
        else:
            self.env[outputs[0]] = out

    # ---- ops ---------------------------------------------------------------
    @staticmethod
    def _sym_pads(op_name, pads, nd):
        """ONNX pads = [begin..., end...]; the framework conv/pool take
        symmetric pads only — reject silent truncation."""
        begin, end = pads[:nd], pads[nd:2 * nd]
        if begin != end:
            raise ValueError(
                f"ONNX import: {op_name} with asymmetric pads {pads} is "
                "unsupported (begin != end); pad the input explicitly")
        return tuple(begin)

    def _op_Conv(self, n):
        a = n['attrs']
        ins = [self._get(x) for x in n['inputs']]
        kernel = _ints(a.get('kernel_shape', [1, 1]))
        pads = _ints(a.get('pads', [0] * 2 * len(kernel)))
        w = self.inits.get(n['inputs'][1])
        num_filter = int(w.shape[0]) if w is not None else 0
        return self.sym_mod.convolution(
            *ins, kernel=tuple(kernel),
            stride=tuple(_ints(a.get('strides', [1] * len(kernel)))),
            dilate=tuple(_ints(a.get('dilations', [1] * len(kernel)))),
            pad=self._sym_pads('Conv', pads, len(kernel)),
            num_filter=num_filter,
            num_group=int(a.get('group', 1)),
            no_bias=len(ins) < 3)

    def _op_Gemm(self, n):
        a = n['attrs']
        ins = [self._get(x) for x in n['inputs']]
        if not a.get('transB', 0):
            raise ValueError("ONNX import: Gemm without transB unsupported")
        if float(a.get('alpha', 1.0)) != 1.0 or \
                float(a.get('beta', 1.0)) != 1.0:
            raise ValueError(
                "ONNX import: Gemm with alpha/beta != 1 is unsupported")
        w = self.inits.get(n['inputs'][1])
        nh = int(w.shape[0]) if w is not None else 0
        return self.sym_mod.fully_connected(
            *ins, num_hidden=nh, no_bias=len(ins) < 3, flatten=False)

    def _op_MatMul(self, n):
        a_sym, b_sym = (self._get(x) for x in n['inputs'])
        return self.sym_mod.dot(a_sym, b_sym)

    def _op_BatchNormalization(self, n):
        a = n['attrs']
        ins = [self._get(x) for x in n['inputs']]
        out = self.sym_mod.batch_norm(
            *ins, eps=float(a.get('epsilon', 1e-5)),
            momentum=float(a.get('momentum', 0.9)), fix_gamma=False,
            use_global_stats=True)
        return out[0] if isinstance(out, tuple) else out

    def _op_LayerNormalization(self, n):
        a = n['attrs']
        ins = [self._get(x) for x in n['inputs']]
        return self.sym_mod.layer_norm(
            *ins, axis=int(a.get('axis', -1)),
            eps=float(a.get('epsilon', 1e-5)))

    def _pool(self, n, ptype, global_pool):
        a = n['attrs']
        x = self._get(n['inputs'][0])
        if global_pool:
            return self.sym_mod.pooling(x, pool_type=ptype, global_pool=True)
        kernel = _ints(a.get('kernel_shape', [1, 1]))
        pads = _ints(a.get('pads', [0] * 2 * len(kernel)))
        # ONNX spec defaults: strides = all 1s, count_include_pad = 0
        return self.sym_mod.pooling(
            x, kernel=tuple(kernel), pool_type=ptype,
            stride=tuple(_ints(a.get('strides', [1] * len(kernel)))),
            pad=self._sym_pads(f'{ptype}Pool', pads, len(kernel)),
            count_include_pad=bool(a.get('count_include_pad', 0)))

    def _op_MaxPool(self, n):
        return self._pool(n, 'max', False)

    def _op_AveragePool(self, n):
        return self._pool(n, 'avg', False)

    def _op_GlobalMaxPool(self, n):
        return self._pool(n, 'max', True)

    def _op_GlobalAveragePool(self, n):
        return self._pool(n, 'avg', True)

    def _act(self, n, act):
        return self.sym_mod.activation(self._get(n['inputs'][0]),
                                       act_type=act)

    def _op_Relu(self, n):
        return self._act(n, 'relu')

    def _op_Sigmoid(self, n):
        return self._act(n, 'sigmoid')

    def _op_Tanh(self, n):
        return self._act(n, 'tanh')

    def _op_Softplus(self, n):
        return self._act(n, 'softrelu')

    def _op_LeakyRelu(self, n):
        return self.sym_mod.leaky_relu(
            self._get(n['inputs'][0]), act_type='leaky',
            slope=float(n['attrs'].get('alpha', 0.01)))

    def _op_Elu(self, n):
        return self.sym_mod.leaky_relu(
            self._get(n['inputs'][0]), act_type='elu',
            slope=float(n['attrs'].get('alpha', 1.0)))

    def _op_PRelu(self, n):
        ins = [self._get(x) for x in n['inputs']]
        return self.sym_mod.leaky_relu(*ins, act_type='prelu')

    def _op_Erf(self, n):
        return self.sym_mod.erf(self._get(n['inputs'][0]))

    def _op_Flatten(self, n):
        return self.sym_mod.flatten(self._get(n['inputs'][0]))

    def _op_Softmax(self, n):
        return self.sym_mod.softmax(self._get(n['inputs'][0]),
                                    axis=int(n['attrs'].get('axis', -1)))

    def _op_LogSoftmax(self, n):
        return self.sym_mod.log_softmax(self._get(n['inputs'][0]),
                                        axis=int(n['attrs'].get('axis', -1)))

    def _op_Dropout(self, n):
        # inference: identity
        return self.sym_mod.identity(self._get(n['inputs'][0]))

    def _op_Identity(self, n):
        return self.sym_mod.identity(self._get(n['inputs'][0]))

    def _op_Reshape(self, n):
        shape = self._const_value(n['inputs'][1])
        return self.sym_mod.reshape(self._get(n['inputs'][0]),
                                    shape=tuple(int(x) for x in shape))

    def _op_Transpose(self, n):
        perm = n['attrs'].get('perm')
        x = self._get(n['inputs'][0])
        if perm is None:
            return self.sym_mod.transpose(x)
        return self.sym_mod.transpose(x, axes=tuple(_ints(perm)))

    def _op_Concat(self, n):
        ins = [self._get(x) for x in n['inputs']]
        return self.sym_mod.concat(*ins, dim=int(n['attrs'].get('axis', 0)))

    def _op_Gather(self, n):
        data = n['inputs'][0]
        idx = self._get(n['inputs'][1])
        axis = int(n['attrs'].get('axis', 0))
        if data in self.inits and axis == 0:
            w = self.inits[data]
            return self.sym_mod.embedding(
                idx, self._get(data), input_dim=int(w.shape[0]),
                output_dim=int(w.shape[1]) if w.ndim > 1 else 1)
        return self.sym_mod.take(self._get(data), idx, axis=axis)

    def _op_Cast(self, n):
        to = int(n['attrs'].get('to', 1))
        return self.sym_mod.cast(self._get(n['inputs'][0]),
                                 dtype=O.ONNX_TO_DTYPE.get(to, 'float32'))

    def _binary(self, n, opname):
        a_name, b_name = n['inputs'][:2]
        # scalar constant operand → scalar op
        for name, scalar_op, sym_first in (
                (b_name, opname, True), (a_name, opname, False)):
            if name in self.inits and self.inits[name].ndim == 0:
                scalar = float(self.inits[name])
                other = self._get(a_name if sym_first else b_name)
                self.consumed.add(name)
                table = {'broadcast_add': 'plus_scalar',
                         'broadcast_sub': ('minus_scalar' if sym_first
                                           else 'rminus_scalar'),
                         'broadcast_mul': 'mul_scalar',
                         'broadcast_div': ('div_scalar' if sym_first
                                           else 'rdiv_scalar'),
                         'broadcast_power': 'power_scalar'}
                sop = table.get(opname)
                if sop:
                    return getattr(self.sym_mod, sop)(other, scalar=scalar)
        ins = [self._get(a_name), self._get(b_name)]
        return getattr(self.sym_mod, opname)(*ins)

    def _op_Add(self, n):
        return self._binary(n, 'broadcast_add')

    def _op_Sub(self, n):
        return self._binary(n, 'broadcast_sub')

    def _op_Mul(self, n):
        return self._binary(n, 'broadcast_mul')

    def _op_Div(self, n):
        return self._binary(n, 'broadcast_div')

    def _op_Pow(self, n):
        return self._binary(n, 'broadcast_power')

    def _op_Max(self, n):
        return self._binary(n, 'broadcast_maximum')

    def _op_Min(self, n):
        return self._binary(n, 'broadcast_minimum')

    def _unary(self, n, opname):
        return getattr(self.sym_mod, opname)(self._get(n['inputs'][0]))

    def _op_Exp(self, n):
        return self._unary(n, 'exp')

    def _op_Log(self, n):
        return self._unary(n, 'log')

    def _op_Sqrt(self, n):
        return self._unary(n, 'sqrt')

    def _op_Abs(self, n):
        return self._unary(n, 'abs')

    def _op_Neg(self, n):
        return self._unary(n, 'negative')

    def _op_Floor(self, n):
        return self._unary(n, 'floor')

    def _op_Ceil(self, n):
        return self._unary(n, 'ceil')

    def _reduce(self, n, opname, axes_as_input=False):
        a = n['attrs']
        x = self._get(n['inputs'][0])
        kw = {'keepdims': bool(a.get('keepdims', 1))}
        axes = None
        if axes_as_input and len(n['inputs']) > 1:
            axes = [int(v) for v in self._const_value(n['inputs'][1])]
        elif 'axes' in a:
            axes = _ints(a['axes'])
        if axes is not None:
            kw['axis'] = tuple(axes)
        return getattr(self.sym_mod, opname)(x, **kw)

    def _op_ReduceMean(self, n):
        return self._reduce(n, 'mean')

    def _op_ReduceSum(self, n):
        return self._reduce(n, 'sum', axes_as_input=True)

    def _op_ReduceMax(self, n):
        return self._reduce(n, 'max')

    def _op_ReduceMin(self, n):
        return self._reduce(n, 'min')

    def _op_ReduceProd(self, n):
        return self._reduce(n, 'prod')

    def _op_Clip(self, n):
        x = self._get(n['inputs'][0])
        lo = float(self._const_value(n['inputs'][1])) \
            if len(n['inputs']) > 1 else -onp.inf
        hi = float(self._const_value(n['inputs'][2])) \
            if len(n['inputs']) > 2 else onp.inf
        return self.sym_mod.clip(x, a_min=lo, a_max=hi)

    def _op_Unsqueeze(self, n):
        x = self._get(n['inputs'][0])
        if len(n['inputs']) > 1:
            axes = [int(v) for v in self._const_value(n['inputs'][1])]
        else:
            axes = _ints(n['attrs'].get('axes', [0]))
        for ax in axes:
            x = self.sym_mod.expand_dims(x, axis=ax)
        return x

    def _op_Squeeze(self, n):
        x = self._get(n['inputs'][0])
        if len(n['inputs']) > 1:
            axes = tuple(int(v) for v in self._const_value(n['inputs'][1]))
            return self.sym_mod.squeeze(x, axis=axes)
        if 'axes' in n['attrs']:
            return self.sym_mod.squeeze(
                x, axis=tuple(_ints(n['attrs']['axes'])))
        return self.sym_mod.squeeze(x)

    def _op_Constant(self, n):
        val = n['attrs'].get('value')
        if val is None:
            raise ValueError("ONNX import: Constant without tensor value")
        name = n['outputs'][0]
        self.inits[name] = onp.asarray(val)
        return self._get(name)


def import_model(model_file):
    """Import an ONNX file → (sym, arg_params, aux_params)
    (ref: onnx2mx/_import_helper.py import_model)."""
    from ...ndarray.ndarray import array as nd_array
    with open(model_file, 'rb') as f:
        buf = f.read()
    model = O.parse_model(buf)
    imp = _Importer(model)
    outs = imp.build()
    sym = outs[0] if len(outs) == 1 else outs
    arg_params = {k: nd_array(onp.ascontiguousarray(v))
                  for k, v in imp.arg_params.items()}
    return sym, arg_params, {}


def import_to_gluon(model_file, ctx=None):
    """Import an ONNX file into a Gluon SymbolBlock (ref:
    contrib/onnx/onnx2mx import_to_gluon)."""
    from ...gluon.block import SymbolBlock
    from ... import symbol as sym_mod
    sym, arg_params, aux_params = import_model(model_file)
    param_names = set(arg_params)
    input_names = [n for n in sym.list_arguments() if n not in param_names]
    inputs = [sym_mod.var(n) for n in input_names]
    net = SymbolBlock(sym, inputs)
    net._load_arg_dict({**arg_params, **aux_params}, ctx=ctx)
    return net
