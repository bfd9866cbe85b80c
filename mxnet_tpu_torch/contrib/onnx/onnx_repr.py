"""ONNX message builders/parsers over the wire layer (field numbers per
onnx/onnx.proto3); a copy of ``mxnet_tpu/contrib/onnx/onnx_repr.py``
apart from the producer name a model carries."""
from __future__ import annotations

import numpy as onp

from . import _proto as P

# TensorProto.DataType
DTYPE_TO_ONNX = {'float32': 1, 'uint8': 2, 'int8': 3, 'int32': 6,
                 'int64': 7, 'bool': 9, 'float16': 10, 'float64': 11,
                 'bfloat16': 16}
ONNX_TO_DTYPE = {v: k for k, v in DTYPE_TO_ONNX.items()}

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR = 1, 2, 3, 4
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


def tensor(name: str, arr: onp.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = onp.ascontiguousarray(arr)
    dt = DTYPE_TO_ONNX[str(arr.dtype)]
    msg = b''.join(P.f_varint(1, d) for d in arr.shape)
    msg += P.f_varint(2, dt)
    msg += P.f_bytes(8, name)
    msg += P.f_bytes(9, arr.tobytes())
    return msg


def parse_tensor(buf: bytes):
    f = P.parse_message(buf)
    dims = P.get_repeated_ints(f, 1)
    dt = P.get_int(f, 2, 1)
    name = P.get_str(f, 8)
    dtype = onp.dtype(ONNX_TO_DTYPE.get(dt, 'float32'))
    if 9 in f:  # raw_data
        arr = onp.frombuffer(f[9][-1], dtype=dtype).reshape(dims)
    elif 4 in f and dt == 1:  # float_data
        arr = onp.array(P.get_repeated_floats(f, 4),
                        onp.float32).reshape(dims)
    elif 7 in f:  # int64_data
        arr = onp.array(P.get_repeated_ints(f, 7), onp.int64).reshape(dims)
    elif 5 in f:  # int32_data
        arr = onp.array(P.get_repeated_ints(f, 5), onp.int32).reshape(dims)
    else:
        arr = onp.zeros(dims, dtype)
    return name, arr


def attribute(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    msg = P.f_bytes(1, name)
    if isinstance(value, bool):
        msg += P.f_varint(3, int(value)) + P.f_varint(20, A_INT)
    elif isinstance(value, int):
        msg += P.f_varint(3, value) + P.f_varint(20, A_INT)
    elif isinstance(value, float):
        msg += P.f_float(2, value) + P.f_varint(20, A_FLOAT)
    elif isinstance(value, str):
        msg += P.f_bytes(4, value) + P.f_varint(20, A_STRING)
    elif isinstance(value, bytes):
        msg += P.f_bytes(4, value) + P.f_varint(20, A_STRING)
    elif isinstance(value, onp.ndarray):
        msg += P.f_bytes(5, tensor('', value)) + P.f_varint(20, A_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, bool)) for v in value):
            msg += b''.join(P.f_varint(8, int(v)) for v in value)
            msg += P.f_varint(20, A_INTS)
        elif all(isinstance(v, float) for v in value):
            msg += b''.join(P.f_float(7, v) for v in value)
            msg += P.f_varint(20, A_FLOATS)
        else:
            msg += b''.join(P.f_bytes(9, str(v)) for v in value)
            msg += P.f_varint(20, A_STRINGS)
    else:
        raise TypeError(f"unsupported attribute type for {name}: {value!r}")
    return msg


def parse_attribute(buf: bytes):
    f = P.parse_message(buf)
    name = P.get_str(f, 1)
    atype = P.get_int(f, 20, 0)
    if atype == A_FLOAT:
        return name, P.get_float(f, 2)
    if atype == A_INT:
        return name, P.get_int(f, 3)
    if atype == A_STRING:
        return name, P.get_str(f, 4)
    if atype == A_TENSOR:
        return name, parse_tensor(f[5][-1])[1]
    if atype == A_FLOATS:
        return name, P.get_repeated_floats(f, 7)
    if atype == A_INTS:
        return name, P.get_repeated_ints(f, 8)
    if atype == A_STRINGS:
        return name, [v.decode() for v in f.get(9, [])]
    # untyped (some writers omit type): infer
    if 3 in f:
        return name, P.get_int(f, 3)
    if 2 in f:
        return name, P.get_float(f, 2)
    if 8 in f:
        return name, P.get_repeated_ints(f, 8)
    return name, None


def node(op_type: str, inputs, outputs, name='', attrs=None,
         domain='') -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5,
    domain=7."""
    msg = b''.join(P.f_bytes(1, i) for i in inputs)
    msg += b''.join(P.f_bytes(2, o) for o in outputs)
    if name:
        msg += P.f_bytes(3, name)
    msg += P.f_bytes(4, op_type)
    for k, v in (attrs or {}).items():
        msg += P.f_bytes(5, attribute(k, v))
    if domain:
        msg += P.f_bytes(7, domain)
    return msg


def parse_node(buf: bytes):
    f = P.parse_message(buf)
    inputs = [v.decode() for v in f.get(1, [])]
    outputs = [v.decode() for v in f.get(2, [])]
    name = P.get_str(f, 3)
    op_type = P.get_str(f, 4)
    attrs = dict(parse_attribute(a) for a in f.get(5, []))
    return {'op_type': op_type, 'name': name, 'inputs': inputs,
            'outputs': outputs, 'attrs': attrs}


def value_info(name: str, shape, elem_type=1) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1};
    Dimension{dim_value=1, dim_param=2}.

    shape=None omits the shape field entirely (unknown rank); an empty
    list declares a rank-0 scalar."""
    tt = P.f_varint(1, elem_type)
    if shape is not None:
        dims = b''
        for d in shape:
            if isinstance(d, int):
                dims += P.f_bytes(1, P.f_varint(1, d))
            else:
                dims += P.f_bytes(1, P.f_bytes(2, str(d)))
        tt += P.f_bytes(2, dims)
    tp = P.f_bytes(1, tt)
    return P.f_bytes(1, name) + P.f_bytes(2, tp)


def parse_value_info(buf: bytes):
    f = P.parse_message(buf)
    name = P.get_str(f, 1)
    shape = []
    elem_type = 1
    if 2 in f:
        tp = P.parse_message(f[2][-1])
        if 1 in tp:
            tt = P.parse_message(tp[1][-1])
            elem_type = P.get_int(tt, 1, 1)
            if 2 in tt:
                sh = P.parse_message(tt[2][-1])
                for d in sh.get(1, []):
                    df = P.parse_message(d)
                    if 1 in df:
                        shape.append(P.get_int(df, 1))
                    else:
                        shape.append(P.get_str(df, 2))
    return name, shape, elem_type


def graph(nodes, name, initializers, inputs, outputs) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    msg = b''.join(P.f_bytes(1, n) for n in nodes)
    msg += P.f_bytes(2, name)
    msg += b''.join(P.f_bytes(5, t) for t in initializers)
    msg += b''.join(P.f_bytes(11, vi) for vi in inputs)
    msg += b''.join(P.f_bytes(12, vi) for vi in outputs)
    return msg


def model(graph_msg: bytes, opset=17, producer='mxnet_tpu_torch') -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    opset_msg = P.f_varint(2, opset)  # OperatorSetIdProto{domain=1,version=2}
    msg = P.f_varint(1, 8)  # IR version 8
    msg += P.f_bytes(2, producer)
    msg += P.f_bytes(7, graph_msg)
    msg += P.f_bytes(8, opset_msg)
    return msg


def parse_model(buf: bytes):
    f = P.parse_message(buf)
    if 7 not in f:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    g = P.parse_message(f[7][-1])
    nodes = [parse_node(n) for n in g.get(1, [])]
    initializers = dict(parse_tensor(t) for t in g.get(5, []))
    inputs = [parse_value_info(vi) for vi in g.get(11, [])]
    outputs = [parse_value_info(vi) for vi in g.get(12, [])]
    opset = 13
    for os_ in f.get(8, []):
        osf = P.parse_message(os_)
        if P.get_str(osf, 1) == '':
            opset = P.get_int(osf, 2, 13)
    return {'nodes': nodes, 'initializers': initializers, 'inputs': inputs,
            'outputs': outputs, 'opset': opset,
            'producer': P.get_str(f, 2)}
