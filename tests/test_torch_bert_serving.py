"""The port's BertModel and continuous batcher against the JAX package's.

One JAX BertModel is initialised and run once; its parameters cross to the
port by their structured names (``params_from_mxnet_tpu``) and through a
``.params`` file written by ``mxnet_tpu``'s ``save_parameters``. Then both
packages serve the same ragged requests through their InferenceEngines.
Everything runs on the CPU (``device='cpu'``) in f32."""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.models.bert import BertModel as JBert
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.bert import BertModel
from mxnet_tpu_torch.serving.batcher import (batch_bucket_for, parse_buckets,
                                             seq_bucket_for)
from mxnet_tpu_torch.weights import load_parameters, params_from_mxnet_tpu


@pytest.fixture(autouse=True, scope='module')
def _jax_name_counters():
    """The JAX package's global block-name counters as this file found
    them, put back after it: its unnamed JAX blocks would otherwise move
    the prefixes of reference tests that run later in the same worker
    (``tests/test_zero3.py`` and ``test_zero1.py`` pair parameters by
    sorted prefixed names, ROADMAP queue 3)."""
    from mxnet_tpu.gluon.block import _BlockScope
    saved = dict(_BlockScope._global_counter)
    yield
    _BlockScope._global_counter.clear()
    _BlockScope._global_counter.update(saved)


CFG = dict(vocab_size=512, hidden=128, layers=2, heads=2, intermediate=512,
           max_len=128)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope='module')
def jax_bert():
    mx.random.seed(0)
    net = JBert(**CFG)
    net.initialize(mx.init.Normal(0.02))
    net(mx.nd.array(onp.zeros((1, 8), 'int32')))
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    return net, arrays


def _port_bert(arrays):
    net = BertModel(**CFG, device='cpu').eval()
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    return net


def _tokens(seed=0, shape=(3, 24)):
    return onp.random.RandomState(seed).randint(0, 512, shape).astype('int32')


@pytest.mark.parametrize('with_valid_length', [False, True])
def test_bert_forward_matches_jax(jax_bert, with_valid_length):
    jnet, arrays = jax_bert
    net = _port_bert(arrays)
    tok = _tokens()
    vl = onp.array([24, 11, 1], 'float32') if with_valid_length else None
    jx, jp = jnet(mx.nd.array(tok), None,
                  None if vl is None else mx.nd.array(vl))
    with torch.inference_mode():
        tx, tp = net(torch.from_numpy(tok), None,
                     None if vl is None else torch.from_numpy(vl))
    onp.testing.assert_allclose(tx.numpy(), jx.asnumpy(), rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(tp.numpy(), jp.asnumpy(), rtol=RTOL, atol=ATOL)


def test_params_file_round_trip(jax_bert, tmp_path):
    jnet, arrays = jax_bert
    path = str(tmp_path / 'bert.params')
    jnet.save_parameters(path)
    net = load_parameters(BertModel(**CFG, device='cpu').eval(), path)
    for name, p in net.named_parameters():
        onp.testing.assert_array_equal(p.detach().numpy(), arrays[name])
    tok = _tokens(1, (2, 16))
    jx, _ = jnet(mx.nd.array(tok))
    with torch.inference_mode():
        tx, _ = net(torch.from_numpy(tok))
    onp.testing.assert_allclose(tx.numpy(), jx.asnumpy(), rtol=RTOL, atol=ATOL)


def test_params_mismatch_fails_loudly(jax_bert):
    _, arrays = jax_bert
    net = BertModel(**CFG, device='cpu')
    missing = dict(arrays)
    missing.pop('encoder.1.ln2.beta')
    with pytest.raises(MXNetError, match='missing'):
        params_from_mxnet_tpu(missing, net)
    extra = dict(arrays, **{'encoder.9.ln1.gamma': onp.ones(128, 'float32')})
    with pytest.raises(MXNetError, match='extra'):
        params_from_mxnet_tpu(extra, net)
    bad = dict(arrays, **{'pooler.bias': onp.zeros(7, 'float32')})
    with pytest.raises(MXNetError, match='shape'):
        params_from_mxnet_tpu(bad, net)


def _serve_all(engine, requests, n_threads=3):
    out, errs = [None] * len(requests), []

    def client(idx):
        try:
            for i in idx:
                out[i] = engine.submit(requests[i], timeout=120.0)
        except Exception as e:                        # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client,
                                args=(range(t, len(requests), n_threads),))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


def test_served_outputs_match_jax_engine(jax_bert):
    jnet, arrays = jax_bert
    kw = dict(seq_buckets=(16, 32), batch_buckets=(1, 2, 4), deadline_ms=2)
    rng = onp.random.RandomState(7)
    requests = [list(rng.randint(1, 512, int(n)))
                for n in rng.randint(3, 33, 10)]
    j_eng = jserving.InferenceEngine(jserving.BlockRunner(jnet), **kw)
    t_eng = serving.InferenceEngine(
        serving.BlockRunner(_port_bert(arrays), device='cpu'), **kw)
    try:
        rep = serving.warmup(t_eng)
        assert set(rep['buckets']) == {f'b{b}_s{s}'
                                       for b, s in t_eng.bucket_grid()}
        j_out = _serve_all(j_eng, requests)
        t_out = _serve_all(t_eng, requests)
    finally:
        j_eng.drain()
        t_eng.drain()
    for req, j, t in zip(requests, j_out, t_out):
        assert t.shape == (len(req), CFG['hidden'])
        onp.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    st = t_eng.stats()
    assert st['requests'] == 10 and st['shed'] == 0
    assert st['p50_ms'] is not None and st['p99_ms'] >= st['p50_ms']


# ---------------------------------------------------------------------------
# buckets and shedding, as tests/test_serving.py checks the JAX engine
# ---------------------------------------------------------------------------

class _TokModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = torch.nn.Embedding(64, 4)

    def forward(self, x):
        return self.embed(x)


def _engine(**kw):
    kw.setdefault('seq_buckets', '8,16')
    kw.setdefault('batch_buckets', '1,2,4')
    kw.setdefault('deadline_ms', 2.0)
    return serving.InferenceEngine(
        serving.BlockRunner(_TokModel(), device='cpu'), **kw)


def test_bucket_helpers_match_jax():
    for spec in ('128, 32,64,32', '4', [8, 2, 2]):
        assert parse_buckets(spec) == jserving.parse_buckets(spec)
    for bad in ('', '0,8'):
        with pytest.raises(MXNetError):
            parse_buckets(bad)
    for n in (1, 32, 33, 64, 65):
        assert seq_bucket_for(n, (32, 64)) == jserving.seq_bucket_for(
            n, (32, 64))
    for n in (1, 3, 4):
        assert batch_bucket_for(n, (1, 2, 4)) == jserving.batch_bucket_for(
            n, (1, 2, 4))


def test_bucket_grid_largest_first():
    eng = _engine()
    try:
        grid = eng.bucket_grid()
        assert grid[0] == (4, 16)
        assert set(grid) == {(b, s) for s in (8, 16) for b in (1, 2, 4)}
    finally:
        eng.drain()


def test_too_long_request_is_a_client_error():
    eng = _engine()
    try:
        with pytest.raises(serving.RequestTooLarge):
            eng.submit(list(range(17)))
    finally:
        eng.drain()


def test_queue_limit_sheds():
    eng = _engine(queue_limit=1, deadline_ms=5000.0, batch_buckets='4')
    try:
        eng.submit_async([1, 2, 3])          # parks waiting for fill
        with pytest.raises(serving.RequestShed, match='queue full'):
            eng.submit_async([4, 5])
        assert eng.stats()['shed'] == 1
    finally:
        assert eng.drain() == 1              # the parked request flushes


def test_admission_and_draining_shed():
    eng = _engine(admission=lambda: 'memory_pressure')
    with pytest.raises(serving.RequestShed, match='memory_pressure'):
        eng.submit([1, 2, 3])
    eng.drain()
    eng.admission = None
    with pytest.raises(serving.RequestShed, match='draining'):
        eng.submit([1, 2, 3])
    assert eng.stats()['shed'] == 2


def test_oom_sheds_the_batch_and_the_engine_survives():
    calls = []

    def runner(mat):
        calls.append(mat.shape)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError('CUDA out of memory (test)')
        return onp.zeros(mat.shape + (2,), 'float32')

    eng = serving.InferenceEngine(runner, seq_buckets='8',
                                  batch_buckets='1', deadline_ms=1.0)
    try:
        with pytest.raises(serving.RequestShed, match='out of device memory'):
            eng.submit([1, 2, 3], timeout=10.0)
        assert eng.submit([1, 2, 3], timeout=10.0).shape == (3, 2)
        assert eng.stats()['shed'] == 1
    finally:
        eng.drain()


def test_padding_is_invisible_to_the_caller():
    eng = _engine()
    try:
        seq = [5, 9, 2, 41, 7]
        out = eng.submit(seq, timeout=10.0)
        padded = torch.tensor([seq + [0] * 3])
        with torch.inference_mode():
            solo = eng.runner.block(padded)[0, :5].numpy()
        assert out.shape == (5, 4)
        onp.testing.assert_array_equal(out, solo)
    finally:
        eng.drain()


# ---------------------------------------------------------------------------
# the models are HybridBlocks named as the JAX package names them
# ---------------------------------------------------------------------------

def _names_below_root(net):
    """collect_params() names without the model's own auto prefix (which
    depends on how many models were built before)."""
    root = net.prefix
    names = list(net.collect_params().keys())
    assert all(n.startswith(root) for n in names)
    return [n[len(root):] for n in names]


@pytest.mark.parametrize('model', ['BertModel', 'BertForPretraining'])
def test_hybrid_bert_names_match_jax(model):
    """The port's BERT models are HybridBlocks with the JAX models'
    children in the same name scopes: the structured names (and their
    order), the prefixed names below the model's own prefix, the encoder
    as a HybridSequential 'encoder_', and named_parameters() all agree."""
    import mxnet_tpu.models.bert as jbert
    from mxnet_tpu_torch.gluon import HybridBlock, nn
    import mxnet_tpu_torch.models.bert as tbert
    if model == 'BertModel':
        jnet, tnet = jbert.BertModel(**CFG), tbert.BertModel(**CFG,
                                                            device='cpu')
    else:
        jnet = jbert.BertForPretraining(dict(CFG, type_vocab=2))
        tnet = tbert.BertForPretraining(dict(CFG, type_vocab=2),
                                        device='cpu')
    assert isinstance(tnet, HybridBlock)
    jstruct = list(jnet._collect_params_with_prefix())
    assert list(tnet._collect_params_with_prefix()) == jstruct
    assert [n for n, _ in tnet.named_parameters()] == jstruct
    assert _names_below_root(tnet) == _names_below_root(jnet)
    bert = tnet if model == 'BertModel' else tnet.bert
    assert isinstance(bert.encoder, nn.HybridSequential)
    assert bert.encoder.prefix == bert.prefix + 'encoder_'
    assert all(isinstance(m, HybridBlock) for m in bert.encoder)
    assert bert.encoder[0].attention.qkv.prefix.endswith(
        'encoder_bertlayer0_bertselfattention0_qkv_')
