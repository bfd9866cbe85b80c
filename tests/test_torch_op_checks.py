"""The rules by which the card holds the port's ops
(``mxnet_tpu_torch/_op_checks.py``), run with the CPU as the device:
every registered op has a case and holds against itself, every sampler
has a law, and each sampler's draws on the CPU follow its law at
n = 200000 (moments, Kolmogorov-Smirnov or chi-square, and the
structural rules). chip_smoke.py's ``ops`` phase and
tests/test_torch_ops_cuda.py run the same checks on the card.
"""
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _op_cases as C
from mxnet_tpu_torch import _op_checks as K
from mxnet_tpu_torch.base import get_op, list_ops


def test_every_registered_op_has_a_case_and_holds_on_the_cpu():
    faults = {}
    for op in list_ops():
        _, fault = K.compare_on_device(op, 'cpu')
        if fault:
            faults[op] = fault
    assert faults == {}


def test_every_sampler_has_a_law():
    assert set(C.RANDOM) <= set(K.LAWS)
    assert set(K.LAWS) <= set(list_ops())


@pytest.mark.parametrize('op', sorted(K.LAWS))
def test_sampler_follows_its_law_on_the_cpu(op):
    z, p, fault = K.law_check(op, 'cpu')
    assert fault is None, f'{op}: {fault}'


def test_a_sampler_that_ignores_its_parameter_fails_its_law(monkeypatch):
    """sample_normal drawing every row from the first row's parameters:
    the second row's law fails."""
    real = get_op('sample_normal').fn

    def first_row_only(mu, sigma, shape=(), dtype='float32'):
        return real(mu[:1].expand_as(mu), sigma[:1].expand_as(sigma),
                    shape=shape, dtype=dtype)
    monkeypatch.setattr(get_op('sample_normal'), 'fn', first_row_only)
    _, _, fault = K.law_check('sample_normal', 'cpu')
    assert fault is not None


def test_a_shuffle_that_drops_a_row_is_not_a_permutation(monkeypatch):
    real = get_op('shuffle').fn
    monkeypatch.setattr(get_op('shuffle'), 'fn',
                        lambda data: torch.cat([real(data)[1:], data[:1]]))
    _, _, fault = K.law_check('shuffle', 'cpu')
    assert fault is not None


def test_a_host_sampler_is_held_exactly_across_devices():
    """sample_unique_zipfian draws from the CPU generator wherever its
    output goes, so the same seed gives the same draws."""
    fn = get_op('sample_unique_zipfian').fn
    outs = []
    for _ in range(2):
        mt.random.seed(3)
        with mt.cpu():
            outs.append(fn(1000, shape=(16,))[0])
    assert torch.equal(*outs)
    assert 'sample_unique_zipfian' in C.HOST
