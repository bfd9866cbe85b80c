"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``, ref:
python/mxnet/callback.py): checkpoints at epoch ends (legacy prefix
files, or a ``checkpoint.CheckpointManager``), metric logging, the
Speedometer and a progress bar. ``Module.fit`` calls them."""
from __future__ import annotations

import logging
import time

from .base import telem_flags as _telem


def prefix_arg_aux_params(arg_params, aux_params):
    """The checkpoint key convention for symbolic-path params: one flat
    dict keyed ``arg:<name>`` / ``aux:<name>``. Every site that saves
    Module/symbolic params through a CheckpointManager (module_checkpoint,
    do_checkpoint, BaseModule.fit's interrupt save) uses this helper so
    the convention cannot drift between them."""
    params = {f'arg:{k}': v for k, v in (arg_params or {}).items()}
    params.update({f'aux:{k}': v for k, v in (aux_params or {}).items()})
    return params


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False,
                      manager=None):
    """Epoch-end checkpoint callback for Module.

    With a ``checkpoint.CheckpointManager`` the save routes through the
    fault-tolerant path instead of legacy prefix files: atomic manifest
    commit, async write, retention, and optimizer states riding along
    when ``save_optimizer_states`` is set."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            if manager is not None:
                arg_params, aux_params = mod.get_params()
                params = prefix_arg_aux_params(arg_params, aux_params)
                states = mod._updater.get_states(dump_optimizer=True) \
                    if save_optimizer_states and mod._updater is not None \
                    else None
                # the symbol rides along so the checkpoint alone can
                # reconstruct the network (legacy path's -symbol.json)
                extra = {}
                symbol = sym if sym is not None \
                    else getattr(mod, '_symbol', None)
                if symbol is not None:
                    extra['symbol'] = symbol.tojson().encode('utf-8')
                manager.save(iter_no + 1, params=params, states=states,
                             extra_blobs=extra)
            else:
                mod.save_checkpoint(prefix, iter_no + 1,
                                    save_optimizer_states)
    # surfaced so BaseModule.fit can route its KeyboardInterrupt/SIGTERM
    # final save through the same manager (resumable clean exit)
    _callback.manager = manager
    return _callback


def do_checkpoint(prefix, period=1, manager=None):
    """Epoch-end checkpoint callback for the symbolic fit path. With a
    ``checkpoint.CheckpointManager`` the arg/aux params go through the
    atomic async manager (keyed ``arg:``/``aux:`` like save_checkpoint)
    instead of a bare prefix-NNNN.params file."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            if manager is not None:
                params = prefix_arg_aux_params(arg, aux)
                extra = {'symbol': sym.tojson().encode('utf-8')} \
                    if sym is not None else None
                manager.save(iter_no + 1, params=params,
                             metadata={'prefix': prefix},
                             extra_blobs=extra)
            else:
                from .model import save_checkpoint
                save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    _callback.manager = manager
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info('Iter[%d] Batch[%d] Train-%s=%f',
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """Prints samples/sec periodically (ref: callback.py Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = None
                if _telem['on']:
                    # the trainer's step gauge is the sharper number when
                    # a Trainer is driving (true inter-step rate, not the
                    # callback's coarser window) — but only when fresh:
                    # a gauge left over from an earlier training phase
                    # must not override an eval loop's own measurement
                    from . import telemetry as _telemetry
                    speed = _telemetry.recent_samples_per_second(
                        max(time.time() - self.tic, 1e-3))
                    _telemetry.inc('mxnet_tpu_speedometer_logs_total')
                if speed is None:
                    try:
                        speed = self.frequent * self.batch_size / \
                            (time.time() - self.tic)
                    except ZeroDivisionError:
                        speed = float('inf')
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset_local()
                    msg = 'Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec'
                    msg += '\t%s=%f' * len(name_value)
                    logging.info(msg, param.epoch, count - self.frequent, count,
                                 speed, *sum(name_value, ()))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = (100.0 * count / float(self.total))
        prog_bar = '=' * filled_len + '-' * (self.bar_len - filled_len)
        logging.info('[%s] %s%s', prog_bar, round(percents, 2), '%')
