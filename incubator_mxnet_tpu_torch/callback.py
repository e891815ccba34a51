"""Training callbacks (counterpart of ``incubator_mxnet_tpu/callback.py``;
reference python/mxnet/callback.py): ``Speedometer``, ``ProgressBar``,
``do_checkpoint``, ``module_checkpoint``, ``log_train_metric`` and
``LogValidationMetricsCallback``, the port's own copy."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch callback checkpointing a Module (reference
    callback.py:module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch callback saving prefix-symbol.json + prefix-%04d.params
    (reference callback.py:do_checkpoint)."""
    from . import model
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch callback logging the metric every `period` batches
    (reference callback.py:log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/sec + metric every `frequent` batches (reference
    callback.py:Speedometer).  ``speeds`` keeps every logged rate."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        self.speeds = []

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                self.speeds.append(speed)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """ASCII progress bar batch callback (reference
    callback.py:ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Eval-end callback logging validation metrics (reference
    callback.py:LogValidationMetricsCallback)."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
