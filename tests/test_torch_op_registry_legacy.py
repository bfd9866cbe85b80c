"""The port's legacy (non-``_np``) ops against the JAX package's on the
CPU, op by op (inputs and bounds: tests/test_torch_op_registry.py; the
gradients are in tests/test_torch_op_gradients.py).
"""
import pytest

from mxnet_tpu.base import list_ops as jlist

from test_torch_op_registry import check_op
from test_torch_jax_globals import jax_globals  # noqa: F401


@pytest.mark.parametrize('op', [o for o in jlist()
                                if not o.startswith('_np')])
def test_op_matches_jax(op):
    check_op(op)
