"""The port's copy of the .params reader/writer against the JAX package's,
and the port's Normal initializer."""
import ml_dtypes
import numpy as onp
import pytest
import torch

from mxnet_tpu import serialization as jser
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.initializer import Normal
from mxnet_tpu_torch.models.bert import BertModel
from test_torch_jax_globals import jax_globals  # noqa: F401


def _arrays():
    rng = onp.random.RandomState(0)
    return {'encoder.0.ln1.gamma': rng.randn(8).astype(onp.float32),
            'word_embed.weight': rng.randn(5, 3).astype(onp.float32),
            'ids': rng.randint(0, 9, (4,)).astype(onp.int32),
            'half': rng.randn(2, 2).astype(ml_dtypes.bfloat16),
            'step': onp.asarray(7, onp.int64)}


def test_writer_is_byte_identical_to_the_jax_writer():
    assert tser.save_ndarray_file(_arrays()) == jser.save_ndarray_file(
        _arrays())


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_files_load_across_packages(writer):
    arrays = _arrays()
    blob = (jser if writer == 'jax' else tser).save_ndarray_file(arrays)
    for reader in (jser.load_params_dict, tser.load_params_dict):
        got = reader(blob)
        assert list(got) == list(arrays)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype
            onp.testing.assert_array_equal(got[k], v)


def test_arg_aux_prefixes_are_stripped_and_bad_blobs_refused():
    blob = jser.save_ndarray_file({'arg:w': onp.ones(2, onp.float32),
                                   'aux:m': onp.zeros(2, onp.float32)})
    assert set(tser.load_params_dict(blob)) == {'w', 'm'}
    with pytest.raises(tser.FormatError):
        tser.load_params_dict(b'not a params file')
    with pytest.raises(tser.FormatError, match='truncated'):
        tser.load_params_dict(blob[:-3])


def test_normal_initializer_uses_its_generator():
    cfg = dict(vocab_size=32, hidden=16, layers=1, heads=2,
               intermediate=32, max_len=16)
    a, b = (BertModel(**cfg, device='cpu') for _ in range(2))
    Normal(0.02)(a, torch.Generator().manual_seed(3))
    Normal(0.02)(b, torch.Generator().manual_seed(3))
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name.endswith('weight'):
            assert 0.01 < float(pa.detach().std()) < 0.03, name
        elif name.endswith('gamma'):
            assert bool((pa == 1).all()), name
        else:
            assert bool((pa == 0).all()), name
