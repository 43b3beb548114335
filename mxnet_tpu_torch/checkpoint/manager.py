"""CheckpointManager: async snapshots, atomic commits, retention.

The port's counterpart of ``mxnet_tpu/checkpoint/manager.py``, on the
same directory layout, so either package reads the other's commits:

* **Async by default** — ``save()`` captures device-side copies on the
  training thread (one grouped copy a device and dtype, see
  checkpoint/state.py) and hands the snapshot to ONE background writer
  thread that does the device-to-host transfer (a side stream, pinned
  buffers), serialization, fsync and commit. The training step never
  waits for disk; the exposed stall is the capture plus any
  back-pressure wait (the snapshot queue is bounded at 2, so a slow disk
  holds at most two snapshots in flight). ``MXNET_CKPT_ASYNC=0`` (or
  ``async_write=False``) writes inline.

* **Atomic commit** — each checkpoint is a directory
  ``ckpt-<seq:08d>/{state.pkl, manifest.json}`` renamed into place from
  a ``.tmp-`` staging directory after both files are fsynced; the
  manifest (with the pickle's sha256) is written last, and the rename
  is the commit point. A reader only ever sees complete directories; a
  crash mid-write leaves a ``.tmp-`` directory the next manager sweeps.

* **Retention** — after every commit the oldest committed checkpoints
  beyond ``keep_last`` are deleted.

* **Failure policy** — each commit retries under the shared
  ``faults.retry`` policy (``MXNET_RETRY_CKPT``) with the staging
  directory swept per attempt; a seq that exhausts its retries is
  *quarantined* (``quarantined`` list, ``ckpt.quarantined`` /
  ``ckpt.failures`` counters, a ``ckpt.quarantine`` ring record, and
  ``wait()`` raises the failure) and the writer keeps serving the queue.
  Reads are damage-tolerant: ``restore_module`` falls back commit by
  commit past unreadable checkpoints (``ckpt.damaged``) and never loads
  a partial state. The ``ckpt.write`` / ``ckpt.d2h`` fault points make
  both paths testable.

Telemetry, under the JAX package's names: ``ckpt.exposed_stall.seconds``
(training-thread cost of a save), ``ckpt.snapshot.seconds`` (background
transfer + write + commit, with the span tracer on), counters
``ckpt.snapshots`` / ``ckpt.commits`` / ``ckpt.failures``, gauge
``ckpt.last_seq``, and flight-ring records ``ckpt.snapshot`` /
``ckpt.commit`` / ``ckpt.quarantine`` / ``ckpt.damaged`` /
``ckpt.restore``.

Environment: ``MXNET_CKPT_DIR``, ``MXNET_CKPT_KEEP_LAST``,
``MXNET_CKPT_ASYNC``, ``MXNET_CKPT_EVERY``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import re
import shutil
import threading
import time

from ..base import MXNetError
from .. import faults as _faults
from .. import telemetry as _telemetry
from . import state as _state

__all__ = ["CheckpointManager", "latest_checkpoint", "restore_module",
           "read_committed_payload"]

_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")


def _committed(directory):
    """[(seq, path)] of complete checkpoints in ``directory``, oldest
    first. A directory counts only when its manifest says complete —
    the atomic-commit contract (rename-after-manifest) makes the
    manifest's presence inside a ``ckpt-*`` name sufficient, but the
    flag guards against foreign dirs that happen to match."""
    out = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return out
    for name in entries:
        m = _CKPT_RE.match(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        manifest = os.path.join(path, "manifest.json")
        try:
            with open(manifest) as f:
                if json.load(f).get("complete"):
                    out.append((int(m.group(1)), path))
        except (OSError, ValueError):
            continue
    out.sort()
    return out


def latest_checkpoint(directory):
    """(seq, path) of the newest committed checkpoint, or None."""
    committed = _committed(directory)
    return committed[-1] if committed else None


def read_committed_payload(directory, kind=None):
    """(seq, path, payload) of the newest committed checkpoint whose
    payload actually READS BACK (and, when ``kind`` is given, matches
    it), or None.

    The damage-tolerance half of the atomic-commit contract: a commit
    can rename cleanly and still be unreadable later (torn disk,
    truncation, bit rot). Reading falls back commit-by-commit — newest
    first — past any directory whose pickle fails to load, recording
    each fallback (``ckpt.damaged`` counter + flight-ring record +
    warning) and NEVER surfacing a partially-read state.
    """
    log_ = logging.getLogger(__name__)
    for seq, path in reversed(_committed(directory)):
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                sha = json.load(f).get("sha256")
            with open(os.path.join(path, "state.pkl"), "rb") as f:
                payload = _state.loads_payload(f.read(), sha256=sha)
        except Exception as exc:
            _telemetry.counter("ckpt.damaged").inc()
            _telemetry.flightrec.note(
                "ckpt.damaged", seq=seq,
                error=f"{type(exc).__name__}: {exc}")
            log_.warning(
                "checkpoint %s is damaged (%s: %s); falling back to "
                "the previous commit", path, type(exc).__name__, exc)
            continue
        if kind is not None and payload.get("kind", "train") != kind:
            continue
        return seq, path, payload
    return None


def restore_module(module, directory):
    """Restore a bound module from the newest *readable* committed
    checkpoint in ``directory``; returns the cursor dict or None when
    no committed checkpoint survives (a first run resuming over an
    empty — or wholly damaged — dir starts fresh, with a warning for
    the damaged case)."""
    found = read_committed_payload(directory, kind="train")
    if found is None:
        return None
    seq, path, payload = found
    cursor = _state.restore(module, payload)
    _telemetry.flightrec.note("ckpt.restore", seq=seq, **cursor)
    logging.getLogger(__name__).info(
        "resumed from checkpoint %s (epoch %d, batch %d)",
        path, cursor["epoch"], cursor["nbatch"])
    return cursor


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class CheckpointManager:
    """Versioned, atomically-committed training checkpoints.

    Parameters (each defaulting from its ``MXNET_CKPT_*`` env var):

    directory : str — checkpoint root (``MXNET_CKPT_DIR``; required
        one way or the other).
    keep_last : int — committed checkpoints retained
        (``MXNET_CKPT_KEEP_LAST``, default 3).
    async_write : bool — background writer on/off
        (``MXNET_CKPT_ASYNC``, default on).
    every_n_batches : int — ``Module.fit`` save cadence in retired
        batches (``MXNET_CKPT_EVERY``; 0 = epoch-end saves only).
    retry_policy : faults.RetryPolicy — per-commit retry behavior
        (default from ``MXNET_RETRY_CKPT``).
    """

    def __init__(self, directory=None, keep_last=None, async_write=None,
                 every_n_batches=None, logger=None, retry_policy=None):
        directory = directory or os.environ.get("MXNET_CKPT_DIR")
        if not directory:
            raise MXNetError("CheckpointManager needs a directory "
                             "(argument or MXNET_CKPT_DIR)")
        self.directory = directory
        self.keep_last = _env_int("MXNET_CKPT_KEEP_LAST", 3) \
            if keep_last is None else int(keep_last)
        self.async_write = (os.environ.get("MXNET_CKPT_ASYNC", "1")
                            not in ("0", "false", "no", "off")) \
            if async_write is None else bool(async_write)
        self.every_n_batches = _env_int("MXNET_CKPT_EVERY", 0) \
            if every_n_batches is None else int(every_n_batches)
        self.logger = logger or logging.getLogger(__name__)

        os.makedirs(self.directory, exist_ok=True)
        # sweep staging dirs a crashed writer left behind
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        committed = _committed(self.directory)
        self._seq = committed[-1][0] + 1 if committed else 1

        self._queue = queue.Queue(maxsize=2)
        self._thread = None
        # guards the writer thread's shared failure state (_error and
        # the quarantined list) against the caller-side wait()/readers
        self._state_lock = threading.Lock()
        self._error = None              # first writer failure, for wait()
        self._ticks = 0                 # fit-loop cadence counter
        self._closed = False
        # commit-failure policy: each write retries per MXNET_RETRY_CKPT
        # (transient full-disk/EIO survive); an exhausted seq is
        # QUARANTINED — recorded here, writer stays alive — instead of
        # killing the writer thread and silently backing up the queue
        self._retry_policy = retry_policy if retry_policy is not None \
            else _faults.RetryPolicy.from_env(
                "CKPT", attempts=3, base_s=0.05, max_s=1.0,
                deadline_s=30.0)
        self.quarantined = []           # seqs abandoned after retries

    # ------------------------------------------------------------- saving
    def tick(self, module, epoch, nbatch):
        """Per-retired-batch cadence hook (called by ``Module.fit``);
        ``nbatch`` is the NEXT batch index. Saves when
        ``every_n_batches`` divides the tick count."""
        self._ticks += 1
        if self.every_n_batches and \
                self._ticks % self.every_n_batches == 0:
            self.save(module, epoch, nbatch)

    def save(self, module, epoch=0, nbatch=0, block=False):
        """Snapshot now; commit in the background (or inline when
        ``async_write`` is off or ``block=True`` — block additionally
        waits for every previously queued snapshot)."""
        if self._closed:
            raise MXNetError("CheckpointManager is closed")
        t0 = time.perf_counter()
        snap = _state.capture(module, epoch, nbatch)
        seq = self._seq
        self._seq += 1
        if self.async_write:
            self._ensure_writer()
            self._queue.put((seq, snap))    # bounded: back-pressure
        else:
            self._write(seq, snap)
        stall = time.perf_counter() - t0
        _telemetry.counter("ckpt.snapshots").inc()
        if _telemetry.enabled():
            _telemetry.histogram("ckpt.exposed_stall.seconds").observe(
                stall)
        _telemetry.flightrec.note("ckpt.snapshot", seq=seq, epoch=epoch,
                                  nbatch=nbatch,
                                  exposed_us=int(stall * 1e6))
        if block and self.async_write:
            self.wait()
        return seq

    def save_payload(self, payload, block=False):
        """Queue one arbitrary host-side payload dict for an atomic
        commit through the same writer/retry/quarantine machinery —
        the serve warm-restart path (serve/warm.py). The payload should
        carry ``version`` (:data:`state.FORMAT_VERSION`) so readers
        accept it, and a ``kind`` distinguishing it from training state
        (``restore_module`` skips non-train kinds)."""
        if self._closed:
            raise MXNetError("CheckpointManager is closed")
        seq = self._seq
        self._seq += 1
        item = (seq, {"__host_payload__": payload})
        if self.async_write:
            self._ensure_writer()
            self._queue.put(item)
        else:
            self._write(*item)
        _telemetry.counter("ckpt.snapshots").inc()
        _telemetry.flightrec.note("ckpt.snapshot", seq=seq,
                                  payload=payload.get("kind", "payload"))
        if block and self.async_write:
            self.wait()
        return seq

    def _ensure_writer(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="mxnet-ckpt-writer")
            self._thread.start()

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as exc:
                # quarantine the seq: the writer thread SURVIVES (the
                # next queued snapshot still commits), the failure is
                # loud — counter + ring record + wait()'s deferred
                # raise — and nothing partial is left on disk (_write
                # sweeps its staging dir per attempt)
                try:
                    seq = item[0]
                    with self._state_lock:
                        if self._error is None:
                            self._error = exc
                        self.quarantined.append(seq)
                    _telemetry.counter("ckpt.failures").inc()
                    _telemetry.counter("ckpt.quarantined").inc()
                    _telemetry.flightrec.note(
                        "ckpt.quarantine", seq=seq,
                        error=f"{type(exc).__name__}: {exc}")
                    self.logger.warning(
                        "checkpoint %d failed after retries, "
                        "quarantined: %s", seq, exc)
                except Exception:       # bookkeeping must never kill
                    pass                # the writer thread either
            finally:
                self._queue.task_done()

    def _write(self, seq, snap):
        t0 = time.perf_counter()
        with _telemetry.span("ckpt.snapshot",
                             _hist="ckpt.snapshot.seconds", seq=seq):
            payload = _faults.retry_call(
                lambda: self._commit_once(seq, snap),
                self._retry_policy, site="ckpt.write",
                logger=self.logger)
        dur = time.perf_counter() - t0
        cursor = payload.get("cursor") or {}
        _telemetry.counter("ckpt.commits").inc()
        _telemetry.gauge("ckpt.last_seq").set(seq)
        _telemetry.flightrec.note("ckpt.commit", seq=seq,
                                  dur_us=int(dur * 1e6), **cursor)
        self._retain()

    def _commit_once(self, seq, snap):
        """One commit attempt: D2H (already-host payloads skip it),
        serialize, fsync, rename. Every failure path removes the
        staging dir before re-raising, so a retried or quarantined seq
        never leaves a partial ``.tmp-`` dir for the init sweep."""
        if isinstance(snap, dict) and "__host_payload__" in snap:
            payload = snap["__host_payload__"]
        else:
            payload = _state.to_host(snap)
        tmp = os.path.join(self.directory,
                           f".tmp-ckpt-{seq:08d}-{os.getpid()}")
        final = os.path.join(self.directory, f"ckpt-{seq:08d}")
        try:
            _faults.point("ckpt.write", seq=seq)
            os.makedirs(tmp, exist_ok=True)
            state_path = os.path.join(tmp, "state.pkl")
            buf = _state.dumps_payload(payload)
            with open(state_path, "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            manifest = {
                "complete": True, "seq": seq,
                "version": payload.get("version",
                                       _state.FORMAT_VERSION),
                "kind": payload.get("kind", "train"),
                "sha256": hashlib.sha256(buf).hexdigest(),
                "cursor": payload.get("cursor") or {},
                "opt": {k: v for k, v in (payload.get("opt") or
                                          {}).items() if k != "counts"},
                "time": time.time(),
                "n_params": len((payload.get("device") or
                                 {}).get("arg_params") or ()),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                # an UNCOMMITTED leftover squatting on this seq (e.g. a
                # damaged dir that lost its manifest) is garbage this
                # commit supersedes; a COMMITTED one must never be
                # silently replaced
                if any(s == seq for s, _ in _committed(self.directory)):
                    raise MXNetError(
                        f"checkpoint seq {seq} already committed at "
                        f"{final}; refusing to overwrite")
                shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)           # the commit point
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        try:
            dirfd = os.open(self.directory, os.O_RDONLY)
            os.fsync(dirfd)
            os.close(dirfd)
        except OSError:
            pass                            # platform without dir fsync
        return payload

    def _retain(self):
        committed = _committed(self.directory)
        for _seq, path in committed[:max(0, len(committed) -
                                         self.keep_last)]:
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------ reading
    def list_committed(self):
        return _committed(self.directory)

    def latest(self):
        return latest_checkpoint(self.directory)

    def restore(self, module):
        """Restore ``module`` from the newest committed checkpoint;
        returns the cursor dict or None when the directory is empty."""
        return restore_module(module, self.directory)

    # ----------------------------------------------------------- lifecycle
    def wait(self):
        """Block until every queued snapshot is committed; raises the
        first writer failure (once)."""
        if self._thread is not None:
            self._queue.join()
        with self._state_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self):
        """Drain pending writes and stop the writer. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=120)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
