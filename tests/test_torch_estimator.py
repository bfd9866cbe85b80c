"""The port's Estimator (``mxnet_tpu_torch/gluon/contrib/estimator.py``)
and its handlers, against the JAX package's and as twins of its tests.

``test_fit_matches_jax``: one MLP (10 -> 16 relu -> 3) with the JAX
net's Xavier weights in both packages, the same ``DataLoader`` over an
``ArrayDataset`` of 128 rows (B = 32, no shuffle), SGD (lr 0.1, momentum
0.9) and ``SoftmaxCrossEntropyLoss``; an epoch-end handler records each
train metric (``Loss``, ``Accuracy``) after every epoch, and a
ValidationHandler's evaluation of the same loader runs every epoch.
Accuracy agrees exactly; the loss metric and the weights after 3 epochs
within 1e-5 relative (f32 on the CPU).

Twins: ``tests/test_train_e2e.py::test_estimator_fit``,
``tests/test_checkpoint.py::test_estimator_checkpoint_handler_saves_and_
resumes`` and ``::test_checkpoint_handler_warns_on_unsupported_save_best``,
``tests/test_resilience.py::test_watchdog_estimator_handler_beats``,
``::test_estimator_keyboard_interrupt_saves_and_exits_cleanly``,
``::test_estimator_sigterm_saves_and_exits_cleanly``,
``::test_estimator_failing_handler_leaks_no_hook_or_watchdog`` and
``::test_estimator_interrupt_during_train_begin_leaks_no_hook``.
"""
import logging
import os
import signal
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, gluon, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib import estimator as test_est
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader


@pytest.fixture(autouse=True, scope='module')
def _jax_name_counters():
    """The JAX package's global block-name counters as this file found
    them, put back after it (``tests/test_zero3.py`` and
    ``test_zero1.py`` pair parameters by sorted prefixed names)."""
    from mxnet_tpu.gluon.block import _BlockScope
    saved = dict(_BlockScope._global_counter)
    yield
    _BlockScope._global_counter.clear()
    _BlockScope._global_counter.update(saved)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mx.cpu():
        yield


def _toy_problem(n=256, d=10, classes=3, seed=0):
    rng = onp.random.RandomState(seed)
    w = rng.randn(d, classes).astype(onp.float32)
    x = rng.randn(n, d).astype(onp.float32)
    y = (x.dot(w) + 0.1 * rng.randn(n, classes)).argmax(axis=1)
    return x, y.astype(onp.float32)


def _toy_regression(n=64, d=4, seed=0):
    rng = onp.random.RandomState(seed)
    x = rng.randn(n, d).astype(onp.float32)
    w = rng.randn(d, 1).astype(onp.float32)
    return x, x.dot(w)


def _mlp(pk):
    net = pk.gluon.nn.HybridSequential()
    net.add(pk.gluon.nn.Dense(16, activation='relu', in_units=10))
    net.add(pk.gluon.nn.Dense(3, in_units=16))
    return net


def _fit(pk, values, x, y, epochs=3):
    """Estimator.fit in package ``pk`` from ``values``; returns (the
    metrics after each epoch, the validation metrics after each epoch,
    the values after fit)."""
    from importlib import import_module
    est_mod = import_module(pk.__name__ + '.gluon.contrib.estimator')
    data = import_module(pk.__name__ + '.gluon.data')
    net = _mlp(pk)
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(pk.nd.array(values[k]))
    trainer = pk.gluon.Trainer(net.collect_params(), 'sgd',
                               {'learning_rate': 0.1, 'momentum': 0.9})
    metrics = [pk.metric.Loss(), pk.metric.Accuracy()]
    val_metrics = [pk.metric.Accuracy(), pk.metric.Loss()]
    est = est_mod.Estimator(net, pk.gluon.loss.SoftmaxCrossEntropyLoss(),
                            metrics=metrics, trainer=trainer,
                            context=[pk.cpu()])
    loader = data.DataLoader(data.ArrayDataset(x, y), batch_size=32)
    seen, val_seen = [], []

    class Record(est_mod.EpochEnd):
        def epoch_end(self, estimator, *args, **kwargs):
            seen.append([m.get() for m in metrics])
            val_seen.append([m.get() for m in val_metrics])

    est.fit(loader, epochs=epochs, event_handlers=[
        est_mod.ValidationHandler(loader, lambda val_data: est.evaluate(
            val_data, val_metrics)), Record()])
    after = {k: p.data().asnumpy()
             for k, p in net._collect_params_with_prefix().items()}
    return seen, val_seen, after


def test_fit_matches_jax():
    x, y = _toy_problem(n=128)
    jnet = _mlp(mj)
    jnet.initialize(mj.init.Xavier())
    values = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    with mj.cpu():
        j_seen, j_val, j_after = _fit(mj, values, x, y)
    t_seen, t_val, t_after = _fit(mx, values, x, y)
    assert len(t_seen) == len(j_seen) == 3
    for got, want in zip(t_seen + t_val, j_seen + j_val):
        for (gn, gv), (wn, wv) in zip(got, want):
            assert gn == wn
            if gn == 'accuracy':
                assert gv == wv
            else:
                assert gv == pytest.approx(wv, rel=1e-5)
    for k in j_after:
        onp.testing.assert_allclose(t_after[k], j_after[k], rtol=1e-5,
                                    atol=1e-6, err_msg=k)


def test_handlers_stop_log_and_stop_early_as_in_jax(caplog):
    """StoppingHandler's batch limit, LoggingHandler at batch interval
    and EarlyStoppingHandler on a metric that cannot improve: the same
    stopping points and log lines' metric values in both packages."""
    from importlib import import_module
    x, y = _toy_problem(n=64)
    out = {}
    for pk in (mj, mx):
        est_mod = import_module(pk.__name__ + '.gluon.contrib.estimator')
        data = import_module(pk.__name__ + '.gluon.data')
        net = _mlp(pk)
        net.initialize(pk.init.One())
        trainer = pk.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': 0.0})
        acc = pk.metric.Accuracy()
        est = est_mod.Estimator(net, pk.gluon.loss.SoftmaxCrossEntropyLoss(),
                                metrics=acc, trainer=trainer,
                                context=[pk.cpu()])
        loader = data.DataLoader(data.ArrayDataset(x, y), batch_size=16)
        stop = est_mod.StoppingHandler()
        early = est_mod.EarlyStoppingHandler(acc, patience=1)
        log = est_mod.LoggingHandler(log_interval='batch', metrics=[acc])
        caplog.clear()
        with caplog.at_level(logging.INFO, logger='estimator'):
            est.fit(loader, epochs=10, event_handlers=[stop, early, log])
        lines = [r.message.split('time/batch')[0] + r.message.split('s ')[-1]
                 for r in caplog.records if '[Batch' in r.message]
        out[pk.__name__] = (stop.current_batch, stop.current_epoch,
                            early.stopped_epoch, lines)
        est2 = est_mod.Estimator(net, pk.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 metrics=pk.metric.Accuracy(),
                                 trainer=trainer, context=[pk.cpu()])
        stop2 = est_mod.StoppingHandler()
        est2.fit(loader, batches=3, event_handlers=[stop2])
        out[pk.__name__] += (stop2.current_batch,)
    assert out['mxnet_tpu_torch'] == out['mxnet_tpu']
    assert out['mxnet_tpu_torch'][2] == 1 and out['mxnet_tpu_torch'][-1] == 3


def test_estimator_fit():
    """The port's twin of tests/test_train_e2e.py::test_estimator_fit."""
    x, y = _toy_problem(n=128)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu'))
    net.add(nn.Dense(3))
    net.initialize(mx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 0.01})
    est = test_est.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             trainer=trainer, context=[mx.cpu()])
    loader = DataLoader(ArrayDataset(x, y), batch_size=32)
    est.fit(loader, epochs=3)
    out = net(nd.array(x)).asnumpy()
    assert float((out.argmax(axis=1) == y).mean()) > 0.5


def test_check_context_picks_the_card_when_there_is_one():
    """The card under the default context (gpu(0); this file's fixture
    scopes every test to the host, so it is entered here), the host when
    a scope asks for it; with no card it raises instead of falling back to
    the host (outside any scope: test_torch_isolation.py)."""
    net = nn.Dense(2, in_units=3)
    net.initialize()
    est = test_est.Estimator(net, gluon.loss.L2Loss(), context=[mx.cpu()])
    assert est._check_context() == [mx.cpu()]
    with mx.gpu(0):
        if torch.cuda.is_available():
            assert est._check_context() == [mx.gpu(0)]
        else:
            with pytest.raises(mx.base.MXNetError, match='no CUDA device'):
                est._check_context()


def _fit_once(model_dir, resume):
    net = nn.Dense(2, in_units=3)
    net.initialize(mx.init.Xavier())
    est = test_est.Estimator(net, loss=gluon.loss.L2Loss(),
                             context=[mx.cpu()])
    handler = test_est.CheckpointHandler(model_dir,
                                         resume_from_checkpoint=resume)
    rng = onp.random.RandomState(0)
    data = [(nd.array(rng.rand(4, 3).astype(onp.float32)),
             nd.array(rng.rand(4, 2).astype(onp.float32)))]
    est.fit(train_data=data, epochs=2, event_handlers=[handler])
    return net, handler


def test_estimator_checkpoint_handler_saves_and_resumes(tmp_path):
    d = str(tmp_path / 'est')
    net1, h1 = _fit_once(d, resume=False)
    steps = h1.manager.all_steps()
    assert steps, "CheckpointHandler must commit at least one checkpoint"
    w1 = net1.weight.data().asnumpy().copy()
    # resume: train_begin must restore the committed weights into a fresh
    # net, not just report the step number
    net2 = nn.Dense(2, in_units=3)
    net2.initialize(mx.init.Xavier())
    assert not onp.array_equal(net2.weight.data().asnumpy(), w1)
    est2 = test_est.Estimator(net2, loss=gluon.loss.L2Loss(),
                              context=[mx.cpu()])
    h2 = test_est.CheckpointHandler(d, resume_from_checkpoint=True)
    h2.train_begin(est2)
    assert h2.resumed_step == steps[-1]
    onp.testing.assert_array_equal(net2.weight.data().asnumpy(), w1)
    h2.manager.close()


def test_checkpoint_handler_warns_on_unsupported_save_best(tmp_path):
    with pytest.warns(RuntimeWarning, match='save_best'):
        test_est.CheckpointHandler(str(tmp_path), save_best=True)


def _regression_estimator():
    x, y = _toy_regression(n=32)
    net = nn.Dense(1, in_units=4)
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.01})
    est = test_est.Estimator(net, gluon.loss.L2Loss(),
                             metrics=mx.metric.Loss(), trainer=trainer,
                             context=[mx.cpu()])
    return est, DataLoader(ArrayDataset(x, y), batch_size=16)


def test_watchdog_estimator_handler_beats():
    est, loader = _regression_estimator()
    handler = test_est.WatchdogHandler(deadline_seconds=60)
    est.fit(loader, epochs=2, event_handlers=[handler])
    assert handler.watchdog is None        # stopped at train_end
    assert handler._step == 4              # one beat per batch


def _fit_estimator_with(tmp_path, interrupter):
    x, y = _toy_regression(n=64)
    net = nn.Dense(1, in_units=4)
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.01})
    est = test_est.Estimator(net, gluon.loss.L2Loss(),
                             metrics=mx.metric.Loss(), trainer=trainer,
                             context=[mx.cpu()])
    handler = test_est.CheckpointHandler(str(tmp_path), epoch_period=None)
    est.fit(DataLoader(ArrayDataset(x, y), batch_size=16), epochs=50,
            event_handlers=[handler, interrupter])
    return handler


def test_estimator_keyboard_interrupt_saves_and_exits_cleanly(tmp_path,
                                                              caplog):
    class InterruptAt(test_est.BatchEnd):
        def __init__(self, at):
            self.n, self.at = 0, at

        def batch_end(self, estimator, *args, **kwargs):
            self.n += 1
            if self.n == self.at:
                raise KeyboardInterrupt

    with caplog.at_level(logging.WARNING, logger='estimator'):
        _fit_estimator_with(tmp_path, InterruptAt(3))
    # no traceback escaped; one checkpoint committed at the interrupt step
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    assert any('resumable from step 3' in r.message for r in caplog.records)


def test_estimator_sigterm_saves_and_exits_cleanly(tmp_path, caplog):
    class SigtermAt(test_est.BatchEnd, test_est.EpochEnd):
        def __init__(self, at):
            self.n, self.at = 0, at
            self.epoch_ends = 0

        def batch_end(self, estimator, *args, **kwargs):
            self.n += 1
            if self.n == self.at:
                os.kill(os.getpid(), signal.SIGTERM)

        def epoch_end(self, estimator, *args, **kwargs):
            self.epoch_ends += 1

    interrupter = SigtermAt(2)
    with caplog.at_level(logging.WARNING, logger='estimator'):
        _fit_estimator_with(tmp_path, interrupter)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 2
    assert any('resumable from step 2' in r.message for r in caplog.records)
    # the preemption grace window is for the save, not epoch-end work
    assert interrupter.epoch_ends == 0
    # the preemption hook was uninstalled by manager.close() at train_end
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)


def test_estimator_failing_handler_leaks_no_hook_or_watchdog(tmp_path):
    """A train_begin/batch error escaping fit tears down the SIGTERM hook
    and any watchdog thread: train_end never runs on that path."""
    est, loader = _regression_estimator()

    class Boom(test_est.BatchEnd):
        def batch_end(self, estimator, *args, **kwargs):
            raise ValueError('boom')

    before = signal.getsignal(signal.SIGTERM)
    wd_handler = test_est.WatchdogHandler(deadline_seconds=60)
    with pytest.raises(ValueError, match='boom'):
        est.fit(loader, epochs=2,
                event_handlers=[test_est.CheckpointHandler(str(tmp_path)),
                                wd_handler, Boom()])
    assert signal.getsignal(signal.SIGTERM) == before
    assert wd_handler.watchdog is None
    assert not any(t.name == 'mxtpu-step-watchdog'
                   for t in threading.enumerate())


def test_estimator_interrupt_during_train_begin_leaks_no_hook(tmp_path):
    """Ctrl-C inside CheckpointHandler.train_begin leaves the handler out
    of the begun set, so its train_end (the normal uninstall path) is
    skipped; fit still takes the hook down before returning."""
    est, loader = _regression_estimator()

    class InterruptedRestore(test_est.CheckpointHandler):
        def train_begin(self, estimator, *args, **kwargs):
            super().train_begin(estimator, *args, **kwargs)
            raise KeyboardInterrupt       # ctrl-C lands mid-train_begin

    before = signal.getsignal(signal.SIGTERM)
    est.fit(loader, epochs=1,
            event_handlers=[InterruptedRestore(str(tmp_path))])
    assert signal.getsignal(signal.SIGTERM) == before
