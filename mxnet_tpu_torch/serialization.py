"""Reference-format NDArray binary serialization (dmlc stream layout).

The port's own copy of ``mxnet_tpu/serialization.py``'s reader and writer
(it imports nothing from that package). It implements the on-disk format
of the reference's ``NDArray::Save/Load`` (ref:
src/ndarray/ndarray.cc:1597-1868), so a ``.params`` file written by
``mxnet_tpu``'s ``save_parameters`` loads here 1:1:

file := uint64 0x112 (list magic) | uint64 reserved
        | uint64 n   | n × ndarray
        | uint64 m   | m × (uint64 len | utf8 name)

ndarray := uint32 magic (V2 0xF993fac9 / V3 0xF993faca)
         | int32 stype                      (0 dense, 1 row_sparse, 2 csr)
         | [storage_shape: tshape]          (sparse only)
         | tshape shape
         | int32 dev_type | int32 dev_id    (context; loaded as cpu)
         | int32 type_flag                  (mshadow dtype enum)
         | sparse: n_aux × (int32 aux_type | tshape aux_shape)
         | raw data (little-endian, C order)
         | sparse: n_aux × raw aux data

tshape := int32 ndim | ndim × int64

Legacy V1 (0xF993fac8) and pre-V1 (magic = ndim, uint32 dims) streams are
readable too. The pickle fallback for the JAX package's earliest files is
not carried over. Everything here is host-side numpy.
"""
from __future__ import annotations

import io
import os
import struct
import tempfile
from typing import Dict, List, Sequence, Tuple, Union

import numpy as onp

try:  # numpy bfloat16, where the optional ml_dtypes package is installed
    import ml_dtypes
    _BF16 = onp.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = None

NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA
LIST_MAGIC = 0x112

# mshadow type flags (ref: 3rdparty/mshadow/mshadow/base.h:333-345)
_FLAG_TO_DTYPE = {
    0: onp.dtype(onp.float32), 1: onp.dtype(onp.float64),
    2: onp.dtype(onp.float16), 3: onp.dtype(onp.uint8),
    4: onp.dtype(onp.int32), 5: onp.dtype(onp.int8),
    6: onp.dtype(onp.int64), 7: onp.dtype(onp.bool_),
    8: onp.dtype(onp.int16),
}
# numpy has no bfloat16. Where ml_dtypes is missing, a bfloat16 array is
# held as its raw bits in a 2-byte structured dtype, written and read under
# the same type flag as the JAX package's ml_dtypes arrays (the same bytes)
BF16_BITS = onp.dtype([('bfloat16', '<u2')])
BF16 = _BF16 if _BF16 is not None else BF16_BITS
_FLAG_TO_DTYPE[12] = BF16
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}
_DTYPE_TO_FLAG[BF16_BITS] = 12

_STYPE_NAUX = {0: 0, 1: 1, 2: 2}   # dense / row_sparse / csr
_STYPE_NAME = {0: 'default', 1: 'row_sparse', 2: 'csr'}


class FormatError(ValueError):
    pass


def _write_tshape(out: io.BytesIO, shape: Sequence[int]) -> None:
    out.write(struct.pack('<i', len(shape)))
    out.write(struct.pack(f'<{len(shape)}q', *[int(d) for d in shape]))


def _read_tshape(f) -> Tuple[int, ...]:
    ndim, = struct.unpack('<i', _read_exact(f, 4))
    if ndim < 0:
        return None  # unknown shape (np semantics none-array)
    return struct.unpack(f'<{ndim}q', _read_exact(f, 8 * ndim))


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise FormatError("truncated NDArray stream")
    return b


def _as_le_bytes(arr: onp.ndarray) -> bytes:
    a = onp.ascontiguousarray(arr)
    if a.dtype.byteorder == '>':
        a = a.byteswap().view(a.dtype.newbyteorder('<'))
    return a.tobytes()


def write_ndarray(out: io.BytesIO, arr: onp.ndarray) -> None:
    """One dense ndarray. V2 layout; 0-d arrays use V3 because in V2 an
    empty shape means "none array" and carries no data (ref:
    NDArray::Save is_np_shape branch, ndarray.cc:1607-1615)."""
    arr = onp.asarray(arr)
    flag = _DTYPE_TO_FLAG.get(arr.dtype)
    if flag is None:
        raise FormatError(f"dtype {arr.dtype} has no mshadow type flag")
    magic = NDARRAY_V3_MAGIC if arr.ndim == 0 else NDARRAY_V2_MAGIC
    out.write(struct.pack('<I', magic))
    out.write(struct.pack('<i', 0))               # kDefaultStorage
    _write_tshape(out, arr.shape)
    out.write(struct.pack('<ii', 1, 0))           # Context{kCPU, 0}
    out.write(struct.pack('<i', flag))
    out.write(_as_le_bytes(arr))


def read_ndarray(f):
    """One ndarray. Returns a dense numpy array, or for sparse payloads a
    tuple (stype_name, data, aux_arrays, shape)."""
    magic, = struct.unpack('<I', _read_exact(f, 4))
    if magic not in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        return _read_legacy(f, magic)
    stype, = struct.unpack('<i', _read_exact(f, 4))
    if stype not in _STYPE_NAUX:
        raise FormatError(f"unknown storage type {stype}")
    naux = _STYPE_NAUX[stype]
    storage_shape = _read_tshape(f) if naux else None
    shape = _read_tshape(f)
    if shape is None or (magic == NDARRAY_V2_MAGIC and len(shape) == 0):
        return None
    _read_exact(f, 8)                             # context (ignored: load cpu)
    flag, = struct.unpack('<i', _read_exact(f, 4))
    if flag not in _FLAG_TO_DTYPE:
        raise FormatError(f"unknown dtype flag {flag}")
    dtype = _FLAG_TO_DTYPE[flag]
    aux = []
    if naux:
        if storage_shape is None:
            raise FormatError("sparse ndarray with unknown storage_shape")
        aux_meta = []
        for _ in range(naux):
            aflag, = struct.unpack('<i', _read_exact(f, 4))
            ashape = _read_tshape(f)
            aux_meta.append((_FLAG_TO_DTYPE[aflag], ashape))
        data_shape = storage_shape
    else:
        data_shape = shape
    n = int(onp.prod(data_shape)) if len(data_shape) else 1
    data = onp.frombuffer(_read_exact(f, n * dtype.itemsize),
                          dtype=dtype.newbyteorder('<')
                          if dtype.itemsize > 1 else dtype).reshape(data_shape)
    data = data.astype(dtype) if data.dtype != dtype else data
    if naux:
        for adtype, ashape in aux_meta:
            an = int(onp.prod(ashape)) if len(ashape) else 1
            aux.append(onp.frombuffer(
                _read_exact(f, an * adtype.itemsize), dtype=adtype)
                .reshape(ashape))
        return (_STYPE_NAME[stype], data, aux, shape)
    return data


def _read_legacy(f, magic):
    """V1 and pre-V1 dense layouts (ref: NDArray::LegacyLoad)."""
    if magic == NDARRAY_V1_MAGIC:
        shape = _read_tshape(f)
    else:  # magic IS ndim; dims are uint32
        ndim = magic
        if ndim > 32:
            raise FormatError(f"bad NDArray magic 0x{magic:x}")
        shape = struct.unpack(f'<{ndim}I', _read_exact(f, 4 * ndim))
    if shape is None or len(shape) == 0:
        return None
    _read_exact(f, 8)                             # context
    flag, = struct.unpack('<i', _read_exact(f, 4))
    dtype = _FLAG_TO_DTYPE[flag]
    n = int(onp.prod(shape))
    return onp.frombuffer(_read_exact(f, n * dtype.itemsize),
                          dtype=dtype).reshape(shape)


def is_bfloat16(a) -> bool:
    """Is ``a`` (an array or a dtype) bfloat16, as ml_dtypes' or as raw
    bits (``BF16_BITS``)?"""
    dt = onp.dtype(getattr(a, 'dtype', a))
    return dt == BF16_BITS or dt.name == 'bfloat16'


def to_numpy(t) -> onp.ndarray:
    """A CPU tensor as a numpy array over its memory; bfloat16 as
    ``BF16`` (the same bits)."""
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def to_tensor(a):
    """A numpy array as a CPU tensor over its memory (bfloat16 from either
    form, by its bits). The tensor of a read-only array (one loaded from a
    file) is for reading only."""
    import warnings
    import torch
    a = onp.ascontiguousarray(a)
    bf16 = is_bfloat16(a)
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='The given NumPy array '
                                'is not writable')
        t = torch.from_numpy(a.view(onp.int16) if bf16 else a)
    return t.view(torch.bfloat16) if bf16 else t


def sparse_to_dense(stype: str, data: onp.ndarray, aux: List[onp.ndarray],
                    shape: Tuple[int, ...]) -> onp.ndarray:
    """Densify a deserialized CSR/RowSparse payload."""
    out = onp.zeros(shape, data.dtype)
    if stype == 'row_sparse':
        indices, = aux
        out[indices.astype(onp.int64)] = data
    elif stype == 'csr':
        indptr, indices = aux
        for r in range(shape[0]):
            cols = indices[indptr[r]:indptr[r + 1]].astype(onp.int64)
            out[r, cols] = data[indptr[r]:indptr[r + 1]]
    else:
        raise FormatError(f"unknown sparse stype {stype}")
    return out


def save_ndarray_file(data: Union[Dict[str, onp.ndarray],
                                  List[onp.ndarray], onp.ndarray]) -> bytes:
    """Serialize to the reference .params/.ndarray container format."""
    if isinstance(data, onp.ndarray):
        arrays, names = [data], []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        arrays, names = list(data), []
    out = io.BytesIO()
    out.write(struct.pack('<QQ', LIST_MAGIC, 0))
    out.write(struct.pack('<Q', len(arrays)))
    for a in arrays:
        write_ndarray(out, onp.asarray(a))
    out.write(struct.pack('<Q', len(names)))
    for nm in names:
        b = nm.encode('utf-8')
        out.write(struct.pack('<Q', len(b)))
        out.write(b)
    return out.getvalue()


def load_ndarray_file(buf: bytes):
    """Parse a reference container. Returns (list_of_arrays, names).
    Sparse entries are returned as (stype, data, aux, shape) tuples."""
    f = io.BytesIO(buf)
    header, _reserved = struct.unpack('<QQ', _read_exact(f, 16))
    if header != LIST_MAGIC:
        raise FormatError(f"bad NDArray file magic 0x{header:x}")
    n, = struct.unpack('<Q', _read_exact(f, 8))
    arrays = [read_ndarray(f) for _ in range(n)]
    m, = struct.unpack('<Q', _read_exact(f, 8))
    names = []
    for _ in range(m):
        ln, = struct.unpack('<Q', _read_exact(f, 8))
        names.append(_read_exact(f, ln).decode('utf-8'))
    if names and len(names) != len(arrays):
        raise FormatError("name count mismatch in NDArray file")
    return arrays, names


def is_ndarray_file(buf: bytes) -> bool:
    return len(buf) >= 8 and struct.unpack('<Q', buf[:8])[0] == LIST_MAGIC


def load_params_dict(buf: bytes, strip_arg_aux: bool = True):
    """Parse a .params blob into {name: dense numpy array}. Sparse entries
    are densified; reference save_checkpoint-style 'arg:'/'aux:' prefixes
    are stripped when every key carries one."""
    if not is_ndarray_file(buf):
        raise FormatError("params blob is not a reference-format NDArray "
                          "file")
    arrays, names = load_ndarray_file(buf)
    out = {}
    for k, v in zip(names, arrays):
        if isinstance(v, tuple):
            v = sparse_to_dense(*v)
        if v is None:
            raise FormatError(f"entry '{k}' is a none-array")
        out[k] = v
    if strip_arg_aux and out and \
            all(k.startswith(('arg:', 'aux:')) for k in out):
        out = {k.split(':', 1)[1]: v for k, v in out.items()}
    return out


def atomic_write_file(path: str, data: bytes) -> None:
    """Crash-safe write of one file: a temporary file in the same
    directory, fsync, then one ``os.replace``, so a kill mid-write leaves
    the previous contents (or no file), never a truncated one."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + '.tmp-',
                               dir=d)
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
