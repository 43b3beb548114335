"""Training callbacks: ``Speedometer``, ``do_checkpoint`` and
``log_train_metric``.

Batch-end callbacks receive a ``BatchEndParam`` (``epoch``, ``nbatch``,
``eval_metric``, ``locals``); epoch-end checkpointers receive ``(epoch,
symbol, arg_params, aux_params)``.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric"]

log = logging.getLogger(__name__)


def _metric_text(eval_metric, reset=False):
    """'name=val name2=val2' for a metric (possibly composite), or ''."""
    if eval_metric is None:
        return ""
    pairs = eval_metric.get_name_value()
    if reset:
        eval_metric.reset()
    return " ".join(f"{n}={v:f}" for n, v in pairs)


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving symbol + params every ``period``
    epochs."""
    from .model import save_checkpoint
    period = max(1, int(period))

    def _save(epoch, sym, arg_params, aux_params):
        if (epoch + 1) % period == 0:
            save_checkpoint(prefix, epoch + 1, sym, arg_params, aux_params)
    return _save


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the running train metric every
    ``period`` batches."""
    def _log(param):
        if param.nbatch % period == 0:
            text = _metric_text(param.eval_metric, reset=auto_reset)
            if text:
                log.info("epoch %d batch %d train: %s", param.epoch,
                         param.nbatch, text)
    return _log


class Speedometer:
    """Batch-end callback logging throughput (samples/s) and the train
    metric every ``frequent`` batches, over the window since the previous
    report (so the first report of each epoch is skipped). The reading
    stays in ``last_speed``."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.last_speed = None
        self._window_start = None
        self._prev_nbatch = 0

    def __call__(self, param):
        if param.nbatch < self._prev_nbatch:    # new epoch
            self._window_start = None
        self._prev_nbatch = param.nbatch
        if self._window_start is None:
            self._window_start = time.time()
            return
        if param.nbatch % self.frequent != 0:
            return
        elapsed = time.time() - self._window_start
        self.last_speed = self.frequent * self.batch_size / max(elapsed,
                                                                1e-12)
        text = _metric_text(param.eval_metric, reset=True)
        log.info("Epoch[%d] Batch[%d] speed=%.2f samples/s%s", param.epoch,
                 param.nbatch, self.last_speed, " " + text if text else "")
        self._window_start = time.time()
