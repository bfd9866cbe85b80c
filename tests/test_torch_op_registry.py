"""The port's op registry against the JAX package's on the CPU (the
counterpart of tests/test_op_registry.py): the two registries hold the
same ops and aliases; every ``_np*``/``_npi*`` op runs on the same inputs
in both packages and agrees in value, dtype and shape; and every op the
port registers is run by the sweep or exempt with the test file that
holds it against the JAX package, so a newly registered op with neither
fails here, whatever order the files run in. The other ops are in
tests/test_torch_op_registry_legacy.py, the gradients in
tests/test_torch_op_gradients.py; both use this file's checks.

The inputs are ``mxnet_tpu_torch/_op_cases.py``'s: the JAX sweep's tables
(tests/test_op_registry.py's ``_explicit_cases``,
``_legacy_explicit_cases`` and family rules) in numpy, plus cases for the
ops those tables leave to other files; chip_smoke.py's ``ops`` phase runs
the same cases on the card. Values are held at float32 rtol 1e-5 (atol
1e-6 for values near 0), integer and bool outputs exactly, dtypes and
shapes exactly. The random ops are held by dtype and shape here, by their
distributions in tests/test_torch_random_ops.py; the decompositions with
sign and order freedoms (svd, eig, eigh, syevd) by invariants.
"""
import numpy as onp
import pytest
import torch
import jax
import jax.numpy as jnp

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.base import (get_op as jget, list_ops as jlist,
                            list_op_aliases as jaliases)
from mxnet_tpu_torch import _op_cases as C
from mxnet_tpu_torch.base import (get_op as tget, list_ops as tlist,
                                  list_op_aliases as taliases)
from test_torch_jax_globals import jax_globals  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6

_EXEMPT = C.EXEMPT
_RANDOM = C.RANDOM
_INVARIANT = C.INVARIANT
# int64, as the reference asks, where the JAX package's x64-off arrays
# give int32 (tests/test_torch_ndarray.py::test_shape_and_size_arrays)
_DTYPE_EXCEPT = {'shape_array': ('int64', 'int32'),
                 'size_array': ('int64', 'int32')}


def _case(op):
    """(args, kwargs) of op's sweep case, or None."""
    return C.case(op, tget(op).fn)


def _to_jax(x):
    if isinstance(x, C.BF16):
        return jnp.asarray(x.array).astype(jnp.bfloat16)
    if isinstance(x, (onp.ndarray, onp.generic)):
        return jnp.asarray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(v) for v in x)
    return x


def _to_torch(x):
    return C.to_torch(x)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _np_of(leaf):
    if hasattr(leaf, 'asnumpy'):      # an NDArray (the control-flow ops)
        return leaf.asnumpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    return onp.asarray(leaf)


def _dtype_name(leaf):
    if hasattr(leaf, 'asnumpy'):
        return leaf.asnumpy().dtype.name
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype)[len('torch.'):]
    return onp.asarray(leaf).dtype.name


def _run(op, args, kwargs):
    mj.random.seed(0)
    mt.random.seed(0)
    want = jget(op).fn(*_to_jax(args), **_to_jax(kwargs))
    with mt.cpu():
        got = tget(op).fn(*_to_torch(args), **_to_torch(kwargs))
    return got, want


def _check_invariants(op, args, got):
    a = onp.asarray(args[0], onp.float64)
    g = [_np_of(x).astype(onp.complex128 if _np_of(x).dtype.kind == 'c'
                          else onp.float64) for x in _leaves(got)]
    if op == '_npi_svd':
        u, s, vh = g
        onp.testing.assert_allclose(u @ onp.diag(s) @ vh, a, atol=1e-5)
    elif op == '_npi_eig':
        w, v = g
        onp.testing.assert_allclose(a @ v, v * w[None, :], atol=1e-4)
    elif op == '_npi_eigh':
        w, v = g
        onp.testing.assert_allclose(v @ onp.diag(w) @ v.T, a, atol=1e-4)
    elif op == 'linalg_syevd':
        u, w = g
        onp.testing.assert_allclose(u.T @ onp.diag(w) @ u, a, atol=1e-4)
        assert (onp.diff(w) >= 0).all()


def check_op(op):
    """Run op in both packages on its case and hold the results."""
    if op in _EXEMPT:
        assert op in tlist()
        return
    case = _case(op)
    assert case is not None, f"{op}: no sweep case and no exemption"
    got, want = _run(op, *case)
    gl, wl = _leaves(got), _leaves(want)
    assert len(gl) == len(wl), op
    for g, w in zip(gl, wl):
        gn, wn = _np_of(g), _np_of(w)
        assert gn.shape == wn.shape, (op, gn.shape, wn.shape)
        want_dtype = wn.dtype.name if str(getattr(w, 'dtype', '')) != \
            'bfloat16' else 'bfloat16'
        if op in _DTYPE_EXCEPT:
            assert (_dtype_name(g), want_dtype) == _DTYPE_EXCEPT[op]
        else:
            assert _dtype_name(g) == want_dtype, (op, _dtype_name(g),
                                                  want_dtype)
    if op in _RANDOM:
        return
    if op in _INVARIANT:
        _check_invariants(op, case[0], got)
        return
    for g, w in zip(gl, wl):
        gn, wn = _np_of(g), _np_of(w)
        if wn.dtype.kind in 'fc':
            onp.testing.assert_allclose(gn, wn, rtol=RTOL, atol=ATOL,
                                        err_msg=op)
        else:
            onp.testing.assert_array_equal(gn, wn, err_msg=op)


def _grad_ops():
    """The differentiable unary, binary and reduction ops with float
    inputs (the JAX sweep's gradient selection)."""
    out = []
    for op in jlist():
        if jget(op).nograd or op.endswith('_update'):
            continue
        if op.startswith('_np'):
            if C.parse_np_op(op)[0] in C.NON_SMOOTH:
                continue
        elif op in C.NON_SMOOTH or (
                op.startswith('broadcast_') and op[len('broadcast_'):]
                not in ('add', 'sub', 'mul', 'div', 'power', 'maximum',
                        'minimum', 'hypot')):
            continue
        fam = C._family(op, C._Draw(op))
        if fam is None or any(onp.asarray(a).dtype.kind in 'iub'
                              for a in fam[0] if hasattr(a, 'shape')):
            continue
        out.append(op)
    return out


def check_gradient(op):
    """sum(cos(op(x...))) differentiated by torch.autograd and jax.grad
    with respect to every array argument."""
    args, kwargs = _case(op)
    idx = [i for i, a in enumerate(args) if isinstance(a, onp.ndarray)]

    def jloss(*xs):
        full = list(_to_jax(args))
        for i, x in zip(idx, xs):
            full[i] = x
        return jnp.sum(jnp.cos(jget(op).fn(*full, **kwargs)
                               .astype(jnp.float32)))

    want = jax.grad(jloss, argnums=tuple(range(len(idx))))(
        *[jnp.asarray(args[i]) for i in idx])
    xs = [torch.tensor(args[i], requires_grad=True) for i in idx]
    full = list(_to_torch(args))
    for i, x in zip(idx, xs):
        full[i] = x
    loss = torch.sum(torch.cos(tget(op).fn(*full, **kwargs)
                               .to(torch.float32)))
    if not loss.requires_grad:
        # a bool or integer result (isnan, logical_not): JAX's gradient
        # through the cast is zero
        for w in want:
            assert not onp.asarray(w).any(), op
        return
    got = torch.autograd.grad(loss, xs)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), rtol=1e-4,
                                    atol=1e-5, err_msg=op)


def test_registries_hold_the_same_ops_and_aliases():
    assert set(tlist()) == set(jlist())
    assert len(tlist()) >= 636
    assert taliases() == jaliases()
    assert len(taliases()) >= 339


@pytest.mark.parametrize('op', [o for o in jlist() if o.startswith('_np')])
def test_numpy_op_matches_jax(op):
    check_op(op)


def test_every_registered_op_is_run_or_exempt():
    missing = [op for op in tlist()
               if op not in _EXEMPT and _case(op) is None]
    assert missing == []
    assert set(_EXEMPT) <= set(tlist())
    assert all(v.startswith('tests/test_torch_') for v in _EXEMPT.values())
