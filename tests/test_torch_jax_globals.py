"""The JAX package's process-wide state that a port test file puts back
as it found it, and the fixture that does it.

Every ``tests/test_torch_*.py`` file that runs code of the JAX package
takes the module-scoped autouse fixture ``jax_globals`` from here::

    from test_torch_jax_globals import jax_globals  # noqa: F401

It restores these when the file is done:

- the global name counters (``gluon.block._BlockScope._global_counter``
  and ``symbol.Symbol._counter``): a port file's unnamed JAX blocks and
  symbols would otherwise move the names of reference tests that run
  later in the same worker (``tests/test_zero3.py`` and ``test_zero1.py``
  pair parameters by sorted prefixed names);
- the op registry (``mxnet_tpu.base._OP_REGISTRY`` and the libraries
  ``mxnet_tpu.library`` loaded): ops a port file registers in the JAX
  package, an op library's, leave with it;
- the executed-op accounting (``mxnet_tpu.base.invoked_ops`` and the
  one-shot flags that feed it): ``tests/test_zz_op_coverage.py`` holds
  the ops that the reference's own test files ran in its worker against
  the registry. The port's op sweeps call 300 or more JAX ops as their
  references; counted there, they would lift a worker past the
  coverage test's full-suite bar with the reference files' coverage
  still partial. After the restore a JAX op that a port file ran
  records itself again when a reference test runs it.

The cases below hold the restore itself.
"""
import pytest

import numpy as onp


def snapshot():
    """The state ``restore`` puts back."""
    from mxnet_tpu import library
    from mxnet_tpu.base import _OP_REGISTRY, invoked_ops
    from mxnet_tpu.gluon.block import _BlockScope
    from mxnet_tpu.symbol import Symbol
    return (dict(_BlockScope._global_counter), Symbol._counter[0],
            set(invoked_ops), dict(_OP_REGISTRY), dict(library._loaded))


def _reset_flags(keep):
    """Clear the one-shot flags of every op whose names are not all in
    ``keep``, so that its next call records it again."""
    from mxnet_tpu.base import _FN_OPNAMES, _OP_REGISTRY
    for od in _OP_REGISTRY.values():
        raw = getattr(od.fn, '__wrapped_op_fn__', None)
        if getattr(od.fn, '_seen', False) and \
                not _FN_OPNAMES.get(raw, set()) <= keep:
            od.fn._seen = False
    for fn, names in _FN_OPNAMES.items():
        if getattr(fn, '__op_use_recorded__', False) and not names <= keep:
            try:
                fn.__op_use_recorded__ = False
            except AttributeError:
                pass


def restore(state):
    from mxnet_tpu import library
    from mxnet_tpu.base import _FN_OPNAMES, _OP_REGISTRY, invoked_ops
    from mxnet_tpu.gluon.block import _BlockScope
    from mxnet_tpu.symbol import Symbol
    counters, symbols, ops, registry, libraries = state
    _BlockScope._global_counter.clear()
    _BlockScope._global_counter.update(counters)
    Symbol._counter[0] = symbols
    added = set(_OP_REGISTRY) - set(registry)
    _OP_REGISTRY.clear()
    _OP_REGISTRY.update(registry)
    for fn in [f for f, names in _FN_OPNAMES.items() if names & added]:
        _FN_OPNAMES[fn] -= added
        if not _FN_OPNAMES[fn]:
            del _FN_OPNAMES[fn]
    library._loaded.clear()
    library._loaded.update(libraries)
    invoked_ops.clear()
    invoked_ops.update(ops)
    _reset_flags(ops)


@pytest.fixture(autouse=True, scope='module')
def jax_globals():
    state = snapshot()
    yield
    restore(state)


def _forget(names):
    from mxnet_tpu.base import invoked_ops
    invoked_ops.difference_update(names)
    _reset_flags(set(invoked_ops))


def _through_invoke(nd):
    nd.arccos(nd.array(onp.array([0.5], 'float32')))


def _through_get_op(nd):
    from mxnet_tpu.base import get_op
    get_op('arcsinh').fn(nd.array(onp.array([0.5], 'float32'))._data)


@pytest.mark.parametrize('op, call', [('arccos', _through_invoke),
                                      ('arcsinh', _through_get_op)])
def test_restore_forgets_ops_run_after_the_snapshot(op, call):
    """An op run after the snapshot is gone from ``invoked_ops`` after the
    restore, and records itself again at its next call (through the
    frontend's invoke, and through ``get_op(name).fn``)."""
    from mxnet_tpu import nd
    from mxnet_tpu.base import invoked_ops
    _forget({op})
    state = snapshot()
    call(nd)
    assert op in invoked_ops
    restore(state)
    assert op not in invoked_ops
    call(nd)
    assert op in invoked_ops


def test_restore_drops_ops_registered_after_the_snapshot():
    """An op registered in the JAX package after the snapshot is gone
    after the restore; what was registered before stays as it was."""
    from mxnet_tpu.base import _OP_REGISTRY, get_op, register_op
    relu = _OP_REGISTRY['relu']
    state = snapshot()

    @register_op('_port_test_only_op')
    def _port_test_only_op(x):
        return x
    get_op('_port_test_only_op').fn(onp.zeros(1))
    restore(state)
    assert '_port_test_only_op' not in _OP_REGISTRY
    assert _OP_REGISTRY['relu'] is relu


def test_restore_keeps_what_the_snapshot_held():
    """Names in the snapshot stay, and the block-name counters come back
    as they were."""
    import mxnet_tpu as jmx
    from mxnet_tpu import nd
    from mxnet_tpu.base import invoked_ops
    from mxnet_tpu.gluon.block import _BlockScope
    from mxnet_tpu.symbol import Symbol
    nd.arctan(nd.array(onp.array([0.5], 'float32')))
    state = snapshot()
    counters = dict(_BlockScope._global_counter)
    symbols = Symbol._counter[0]
    jmx.gluon.nn.Dense(3)
    jmx.sym.relu(jmx.sym.var('x'))
    assert dict(_BlockScope._global_counter) != counters
    assert Symbol._counter[0] != symbols
    restore(state)
    assert 'arctan' in invoked_ops
    assert dict(_BlockScope._global_counter) == counters
    assert Symbol._counter[0] == symbols
