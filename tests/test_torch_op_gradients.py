"""Gradients of the port's differentiable unary, binary and reduction
ops against the JAX package's: the port's torch.autograd gradient of
sum(cos(op(x))) against jax.grad's with respect to every array argument,
at rtol 1e-4, on the JAX sweep's inputs (tests/test_torch_op_registry.py).
"""
import pytest

from test_torch_op_registry import _grad_ops, check_gradient


@pytest.mark.parametrize('op', _grad_ops())
def test_gradient_matches_jax(op):
    check_gradient(op)


def test_gradient_sweep_is_wide():
    assert len(_grad_ops()) >= 95
