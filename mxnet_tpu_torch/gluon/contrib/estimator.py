"""The Estimator fit loop and its event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``, ref: python/mxnet/gluon/contrib/
estimator/{estimator.py,event_handler.py}).

``Estimator(net, loss, metrics, trainer=, context=)`` runs MXNet's Gluon
loop over a data iterable: ``split_and_load`` onto the context (the card
unless ``context=`` or a ``with mx.cpu():`` scope names the host; with no
card it raises), ``autograd.record()``, the loss's
``backward()``, ``trainer.step(batch_size)``, then the handlers. The
handlers are the JAX package's: Stopping, Metric, Validation, Logging,
Checkpoint (over the port's ``checkpoint.CheckpointManager``: atomic
manifests, background writes, keep-last retention, resume, the SIGTERM
hook), Watchdog (over ``resilience.StepWatchdog``) and EarlyStopping. An
interrupt (Ctrl-C, SIGTERM with a CheckpointHandler) commits one
synchronous checkpoint and returns cleanly; an escaping error removes the
SIGTERM hook and stops the watchdog thread before it propagates.
"""
from __future__ import annotations

import logging
import time

from ... import metric as metric_mod
from ...base import MXNetError
from ...context import context_of, resolve_device
from .. import Trainer
from ..loss import Loss as BaseLoss
from ...ndarray.utils import split_and_load
from ... import autograd


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after max_epoch/max_batch (ref: event_handler.py StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.max_epoch = estimator.max_epoch
        self.max_batch = estimator.max_batch
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.current_batch == self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.current_epoch == self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.train_metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs['pred']
        label = kwargs['label']
        loss = kwargs['loss']
        for m in self.train_metrics:
            if isinstance(m, metric_mod.Loss):
                m.update(0, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Ref: event_handler.py LoggingHandler."""

    LOG_PER_EPOCH = 1
    LOG_PER_BATCH = 2

    def __init__(self, log_interval='epoch', metrics=None, priority=-10000):
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.log_interval = log_interval
        self.priority = priority
        self.logger = logging.getLogger('estimator')

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        train_time = time.time() - self.train_start
        msg = f'Train finished using total {train_time:.2f}s at epoch {self.current_epoch}. '
        for m in self.metrics:
            name, value = m.get()
            msg += f'{name}: {value:.4f}, '
        self.logger.info(msg.rstrip(', '))

    def batch_begin(self, estimator, *args, **kwargs):
        if self.log_interval == 'batch' or self.log_interval == self.LOG_PER_BATCH:
            self.batch_start = time.time()

    def batch_end(self, estimator, *args, **kwargs):
        if self.log_interval == 'batch' or self.log_interval == self.LOG_PER_BATCH:
            batch_time = time.time() - self.batch_start
            msg = f'[Epoch {self.current_epoch}][Batch {self.batch_index}]'
            cur_batches = kwargs.get('batch')
            if cur_batches is not None:
                self.processed_samples += cur_batches.data[0].shape[0] \
                    if hasattr(cur_batches, 'data') else 0
            msg += f' time/batch: {batch_time:.3f}s '
            for m in self.metrics:
                name, value = m.get()
                msg += f'{name}: {value:.4f}, '
            self.logger.info(msg.rstrip(', '))
        self.batch_index += 1

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        epoch_time = time.time() - self.epoch_start
        msg = f'[Epoch {self.current_epoch}] finished in {epoch_time:.3f}s: '
        for m in self.metrics:
            name, value = m.get()
            msg += f'{name}: {value:.4f}, '
        self.logger.info(msg.rstrip(', '))
        self.current_epoch += 1
        self.batch_index = 0


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd, TrainEnd):
    """Ref: event_handler.py CheckpointHandler — backed by
    ``checkpoint.CheckpointManager``: atomic manifests, async background
    writes, keep-last-``max_checkpoints`` retention, and optional
    preemption-safe resume (``resume_from_checkpoint=True`` restores the
    newest hash-verified checkpoint — params, optimizer state and RNG
    stream — before training starts)."""

    def __init__(self, model_dir, model_prefix='model', monitor=None,
                 verbose=0, save_best=False, mode='auto', epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        import os
        if monitor is not None or save_best:
            import warnings
            warnings.warn(
                "CheckpointHandler: monitor/save_best are not supported "
                "by the manager-backed handler yet — checkpoints are "
                "retained by recency (keep-last-max_checkpoints), not by "
                "metric. These arguments are ignored.", RuntimeWarning,
                stacklevel=2)
        # checkpoints land in CheckpointManager step_* dirs under
        # model_dir, not {model_prefix}-epochN.params files; model_prefix
        # is retained for signature compatibility only
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.current_batch = 0
        self.current_epoch = 0
        self.resumed_step = None
        self._last_saved_step = None
        self.manager = None
        os.makedirs(model_dir, exist_ok=True)

    def train_begin(self, estimator, *args, **kwargs):
        from ... import checkpoint as _checkpoint
        self.current_batch = 0
        self.current_epoch = 0
        self.manager = _checkpoint.CheckpointManager(
            self.model_dir, params=estimator.net, trainer=estimator.trainer,
            keep_last_n=max(1, self.max_checkpoints))
        # SIGTERM (preemption) commits a synchronous checkpoint at the
        # current step; the fit loop polls manager.preempted and exits
        # cleanly with a "resumable from step N" message
        self.manager.install_preemption_hook()
        if self.resume_from_checkpoint:
            self.resumed_step = self.manager.restore_latest()
            if self.resumed_step is not None:
                self.current_batch = self.resumed_step
                logging.getLogger('estimator').info(
                    'CheckpointHandler: resumed from step %d',
                    self.resumed_step)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(metadata={'epoch': self.current_epoch})

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(metadata={'epoch': self.current_epoch})

    def _save(self, metadata):
        # batch_period dividing the epoch's batch count makes epoch_end
        # land on the step batch_end just wrote — skip the duplicate
        # full serialize/hash/commit of a byte-identical checkpoint
        if self._last_saved_step == self.current_batch:
            return
        self._last_saved_step = self.current_batch
        self.manager.save(self.current_batch, metadata=metadata)

    def save_now(self):
        """Synchronously commit a checkpoint at the current step (the
        interrupt/preemption path). Returns the step saved, or None when
        train_begin has not run yet."""
        if self.manager is None:
            return None
        if self.manager.latest_step() != self.current_batch:
            self.manager.save_now(self.current_batch)
        self._last_saved_step = self.current_batch
        return self.current_batch

    def train_end(self, estimator, *args, **kwargs):
        if self.manager is not None:
            self.manager.close()


class WatchdogHandler(TrainBegin, BatchEnd, EpochBegin, EpochEnd,
                      TrainEnd):
    """Wires a ``resilience.StepWatchdog`` into the fit loop: one
    heartbeat per batch (plus epoch boundaries, so checkpoint saves
    between epochs don't read as stalls); when a step stalls past the
    deadline the watchdog dumps all-thread stacks + a telemetry
    snapshot to the log (and, with ``save_on_stall`` and a
    CheckpointHandler present, attempts an emergency checkpoint through
    its manager). Work that legitimately exceeds the deadline with no
    batch_end in between — a long validation pass, or the first step's
    kernel builds (nvcc, Triton) and cuDNN set-up — needs a larger
    ``deadline_seconds`` or its own ``watchdog.beat()`` calls: the
    watchdog cannot see inside it and will report a (false) stall."""

    def __init__(self, deadline_seconds=None, save_on_stall=False,
                 on_stall=None):
        self.deadline_seconds = deadline_seconds
        self.save_on_stall = save_on_stall
        self.on_stall = on_stall
        self.watchdog = None
        self._step = 0

    def train_begin(self, estimator, *args, **kwargs):
        from ...resilience import StepWatchdog
        self._step = 0
        self.watchdog = StepWatchdog(
            deadline_seconds=self.deadline_seconds, manager=None,
            save_on_stall=self.save_on_stall, on_stall=self.on_stall)
        self.watchdog.start()

    def _bind_manager(self, estimator):
        # called by Estimator.fit right after every train_begin has run
        # (a CheckpointHandler listed AFTER this handler creates its
        # manager there) and BEFORE the first data fetch — the canonical
        # stall — so save_on_stall works from the very first moment
        if self.watchdog is not None and self.watchdog.manager is None:
            for h in getattr(estimator, '_event_handlers', []):
                if isinstance(h, CheckpointHandler) and \
                        h.manager is not None:
                    self.watchdog.manager = h.manager
                    break

    def batch_end(self, estimator, *args, **kwargs):
        self._step += 1
        if self.watchdog is not None:
            self.watchdog.beat(self._step)

    def epoch_begin(self, estimator, *args, **kwargs):
        if self.watchdog is not None:
            self.watchdog.beat(self._step)

    def epoch_end(self, estimator, *args, **kwargs):
        if self.watchdog is not None:
            self.watchdog.beat(self._step)

    def train_end(self, estimator, *args, **kwargs):
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Ref: event_handler.py EarlyStoppingHandler."""

    def __init__(self, monitor, min_delta=0, patience=0, mode='auto',
                 baseline=None):
        import numpy as onp
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if mode == 'min' or (mode == 'auto' and 'acc' not in monitor.get()[0]):
            self.monitor_op = onp.less
            self.min_delta *= -1
        else:
            self.monitor_op = onp.greater

    def train_begin(self, estimator, *args, **kwargs):
        import numpy as onp
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        self.best = onp.inf if self.monitor_op == onp.less else -onp.inf

    def epoch_end(self, estimator, *args, **kwargs):
        monitor_name, monitor_value = self.monitor.get()
        if monitor_value is None or monitor_value != monitor_value:
            self.current_epoch += 1
            return
        if self.monitor_op(monitor_value - self.min_delta, self.best):
            self.best = monitor_value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            logging.getLogger('estimator').info(
                'Epoch %d: early stopping', self.stopped_epoch)


class Estimator:
    """The Gluon training loop (ref: estimator.py Estimator)."""

    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = loss if isinstance(loss, (list, tuple)) else [loss]
        self.train_metrics = metrics if isinstance(metrics, list) else \
            ([metrics] if metrics else [metric_mod.Accuracy()])
        self.context = context or self._check_context()
        self._initialize(initializer)
        self.trainer = trainer or Trainer(
            self.net.collect_params(), 'sgd', {'learning_rate': 0.001})
        self.stop_training = False
        self.max_epoch = None
        self.max_batch = None

    def _check_context(self):
        """The card, unless a ``with mx.cpu():`` scope asks for the host;
        with no card it raises (``resolve_device``)."""
        return [context_of(resolve_device(None))]

    def _initialize(self, initializer):
        # parameters already initialised keep their values
        self.net.initialize(init=initializer, ctx=self.context)

    def evaluate(self, val_data, val_metrics=None, batch_axis=0):
        val_metrics = val_metrics or self.train_metrics
        for m in val_metrics:
            m.reset()
        for batch in val_data:
            data, label = self._get_data_and_label(batch, self.context,
                                                   batch_axis)
            pred = [self.net(x) for x in data]
            for m in val_metrics:
                if isinstance(m, metric_mod.Loss):
                    losses = [self.loss[0](yhat, y)
                              for yhat, y in zip(pred, label)]
                    m.update(0, losses)
                else:
                    m.update(label, pred)
        return val_metrics

    def _get_data_and_label(self, batch, ctx, batch_axis=0):
        if hasattr(batch, 'data'):
            data, label = batch.data[0], batch.label[0]
        else:
            data, label = batch
        data = split_and_load(data, ctx, batch_axis=batch_axis)
        label = split_and_load(label, ctx, batch_axis=batch_axis)
        return data, label

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        """Ref: estimator.py fit."""
        self.max_epoch = epochs
        self.max_batch = batches
        if not self.max_epoch and not self.max_batch:
            raise MXNetError("Either epochs or batches must be specified")
        event_handlers = self._prepare_default_handlers(val_data,
                                                        event_handlers)
        self._event_handlers = event_handlers
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize_handlers(event_handlers)
        self.stop_training = False
        ckpt_handler = next((h for h in event_handlers
                             if isinstance(h, CheckpointHandler)), None)
        interrupted = None
        begun = set()
        try:
            # inside the try: a later handler's train_begin raising must
            # not leak what an earlier one installed (SIGTERM hook,
            # watchdog thread)
            for handler in train_begin:
                handler.train_begin(self)
                begun.add(id(handler))
            # all managers exist now: bind them into any watchdog BEFORE
            # the first data fetch (a hung first next(train_data) is the
            # canonical stall, and save_on_stall must work for it)
            for handler in event_handlers:
                if isinstance(handler, WatchdogHandler):
                    handler._bind_manager(self)
            while not self.stop_training:
                for handler in epoch_begin:
                    handler.epoch_begin(self)
                for batch in train_data:
                    data, label = self._get_data_and_label(
                        batch, self.context, batch_axis)
                    batch_size = data[0].shape[batch_axis] * len(data)
                    for handler in batch_begin:
                        handler.batch_begin(self, batch=batch)
                    with autograd.record():
                        pred = [self.net(x) for x in data]
                        losses = [self.loss[0](yhat, y)
                                  for yhat, y in zip(pred, label)]
                    for l in losses:
                        l.backward()
                    self.trainer.step(batch_size)
                    for handler in batch_end:
                        handler.batch_end(self, batch=batch, pred=pred,
                                          label=label, loss=losses)
                    if ckpt_handler is not None and \
                            ckpt_handler.manager is not None and \
                            ckpt_handler.manager.preempted:
                        # SIGTERM: the preemption hook already committed
                        # a synchronous checkpoint — exit the loop clean
                        interrupted = 'SIGTERM'
                        self.stop_training = True
                    if self.stop_training:
                        break
                if interrupted is not None:
                    # preemption: the grace window is for the final save,
                    # not for epoch-end work (a ValidationHandler would
                    # run a full eval pass here) — save first, exit clean
                    break
                for handler in epoch_end:
                    handler.epoch_end(self)
        except KeyboardInterrupt:
            # one final synchronous save + a clean, resumable exit —
            # never a raw traceback mid-epoch
            interrupted = 'KeyboardInterrupt'
        except BaseException:
            self._emergency_teardown(event_handlers, ckpt_handler)
            raise
        try:
            if interrupted is not None:
                self._report_interrupted(interrupted, ckpt_handler)
            for handler in train_end:
                # an interrupt during the train_begin phase leaves later
                # handlers un-begun: their train_end would read state
                # their train_begin never set
                if isinstance(handler, TrainBegin) and \
                        id(handler) not in begun:
                    continue
                handler.train_end(self)
            if any(isinstance(h, TrainBegin) and id(h) not in begun
                   for h in event_handlers):
                # the interrupt landed INSIDE some train_begin: its
                # train_end was skipped above, so whatever the partial
                # train_begin already installed (SIGTERM hook, watchdog
                # thread) must still be torn down
                self._emergency_teardown(event_handlers, ckpt_handler)
        except BaseException:
            # a SECOND Ctrl-C during the final save / teardown must not
            # leak either — same cleanup as an escaping training error
            self._emergency_teardown(event_handlers, ckpt_handler)
            raise

    def _emergency_teardown(self, event_handlers, ckpt_handler):
        """train_end never runs on an escaping error, so nothing
        process-global may outlive fit: the SIGTERM handler (a later
        signal would save stale state through the abandoned manager) and
        any watchdog thread (its heartbeats stopped — it would keep
        reporting false stalls forever)."""
        if ckpt_handler is not None and ckpt_handler.manager is not None:
            ckpt_handler.manager.uninstall_preemption_hook()
        for h in event_handlers:
            if isinstance(h, WatchdogHandler) and h.watchdog is not None:
                h.watchdog.stop()
                h.watchdog = None

    def _report_interrupted(self, why, ckpt_handler):
        log = logging.getLogger('estimator')
        if ckpt_handler is None or ckpt_handler.manager is None:
            log.warning(
                'training interrupted (%s); no CheckpointHandler bound, '
                'nothing saved — add one to make interrupts resumable',
                why)
            return
        try:
            step = ckpt_handler.save_now()
            log.warning(
                'training interrupted (%s); checkpoint committed — '
                'resumable from step %s', why, step)
        except Exception:
            log.exception(
                'training interrupted (%s) but the final checkpoint '
                'save failed', why)

    def _prepare_default_handlers(self, val_data, event_handlers):
        event_handlers = list(event_handlers or [])
        added_default = []
        if not any(isinstance(h, StoppingHandler) for h in event_handlers):
            event_handlers.append(StoppingHandler(self.max_epoch,
                                                  self.max_batch))
            added_default.append('StoppingHandler')
        if not any(isinstance(h, MetricHandler) for h in event_handlers):
            event_handlers.append(MetricHandler(self.train_metrics))
            added_default.append('MetricHandler')
        if not any(isinstance(h, LoggingHandler) for h in event_handlers):
            event_handlers.append(LoggingHandler(metrics=self.train_metrics))
            added_default.append('LoggingHandler')
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler) for h in event_handlers):
            event_handlers.append(ValidationHandler(val_data, self.evaluate))
        return event_handlers

    def _categorize_handlers(self, event_handlers):
        train_begin = [h for h in event_handlers if isinstance(h, TrainBegin)]
        epoch_begin = [h for h in event_handlers if isinstance(h, EpochBegin)]
        batch_begin = [h for h in event_handlers if isinstance(h, BatchBegin)]
        batch_end = [h for h in event_handlers if isinstance(h, BatchEnd)]
        epoch_end = [h for h in event_handlers if isinstance(h, EpochEnd)]
        train_end = [h for h in event_handlers if isinstance(h, TrainEnd)]
        return (train_begin, epoch_begin, batch_begin, batch_end, epoch_end,
                train_end)
