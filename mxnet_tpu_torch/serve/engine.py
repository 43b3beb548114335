"""Serving engine: a batch-size bucket ladder behind one ``forward()``.

``BucketEngine`` (symbol + params) is the port of the JAX package's
engine of that name: a ``BucketingModule`` whose bucket key IS the batch
size, every rung a Module bound ``for_training=False`` over the leader,
so all rungs alias ONE set of parameter cells. ``forward(bucket,
values)`` runs one rung over an assembled (already padded) batch and
returns the output NDArrays, on the card unless the engine was given
``mx.cpu()``.

``compute_dtype="int8"`` / ``"fp8"`` (``"float8_e4m3fn"``) selects a
quantized inference tier: the symbol is rewritten onto the Quantized*
ops and every dense/conv weight splits into a narrow storage cell plus
per-channel float32 scales (``ops/quant.py``) before binding. Any other
``compute_dtype`` raises: mixed precision is a later slice.

``warmup(clock)`` runs two forwards per rung (the first builds anything
still unbuilt, the second measures steady-state execution on the given
clock — 0 on a FakeClock). Eager PyTorch compiles no programs, so the
count the JAX package reads from its program cache is, here, the number
of CUDA kernel libraries the process has built or loaded
(``compile_count()``); after warmup, ``compiles_since_warmup()`` must stay
0. There are no program-cache keys to pin: ``program_keys()`` is empty
and ``programs_resident()`` is True.

``PredictorEngine`` serves ``.mxp`` artifacts, which hold StableHLO
programs; it raises until ``predict.py`` is ported in a later slice.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..io import DataBatch, DataDesc
from ..ndarray import NDArray
from ..ops import cuda_kernels as _ck
from .batching import BucketLadder, default_ladder

__all__ = ["BucketEngine", "PredictorEngine", "compile_count"]

log = logging.getLogger(__name__)

#: compute_dtype spellings that select a quantized tier
_QUANT_TIERS = ("int8", "fp8", "float8_e4m3fn")


def compile_count():
    """Kernel libraries this process has built or loaded: what can still
    be compiled on an eager serving path."""
    return _ck.libraries_loaded()


class _EngineBase:
    """Shared ladder/shape validation + warmup accounting."""

    def __init__(self, name, ladder):
        self.name = name
        if ladder is None:
            ladder = default_ladder()
        self.ladder = ladder if isinstance(ladder, BucketLadder) \
            else BucketLadder(ladder)
        self.exec_est = {}            # bucket -> measured seconds (EMA'd
        self._warm_mark = None        # by the scheduler via note_exec)
        self.warmup_compiles = None

    # -- contract pieces subclasses fill in
    data_names = ()
    example_shapes = {}               # name -> per-row shape
    input_dtypes = {}                 # name -> numpy dtype

    def validate(self, inputs):
        """(rows, canonical dict) for one request's inputs; raises on a
        shape/name mismatch so bad requests fail at submit, not in the
        dispatch thread."""
        rows = None
        vals = {}
        for nm in self.data_names:
            if nm not in inputs:
                raise MXNetError(f"model {self.name!r}: missing input "
                                 f"{nm!r} (needs {list(self.data_names)})")
            arr = np.asarray(inputs[nm], dtype=self.input_dtypes[nm])
            want = self.example_shapes[nm]
            if arr.ndim != len(want) + 1 or tuple(arr.shape[1:]) != want:
                raise MXNetError(
                    f"model {self.name!r} input {nm!r}: shape "
                    f"{tuple(arr.shape)} != (rows,)+{want}")
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise MXNetError(
                    f"model {self.name!r}: inputs disagree on rows "
                    f"({rows} vs {arr.shape[0]} for {nm!r})")
            vals[nm] = arr
        if rows is None or rows < 1:
            raise MXNetError(f"model {self.name!r}: empty request")
        if rows > self.ladder.max:
            raise MXNetError(
                f"model {self.name!r}: {rows} rows exceed the largest "
                f"bucket {self.ladder.max} (extend the ladder or split "
                "the request)")
        return rows, vals

    def note_exec(self, bucket, seconds):
        """EMA the measured execution time into the flush estimate."""
        prev = self.exec_est.get(bucket)
        self.exec_est[bucket] = seconds if prev is None else \
            0.7 * prev + 0.3 * seconds

    def exec_estimate(self, bucket):
        """Execution-seconds estimate for a rung (0 until measured)."""
        if bucket in self.exec_est:
            return self.exec_est[bucket]
        known = list(self.exec_est.values())
        return max(known) if known else 0.0

    def warmup(self, clock):
        """Run every rung twice (build, then steady state), measure."""
        mark = compile_count()
        for bucket in self.ladder:
            zeros = {nm: np.zeros((bucket,) + self.example_shapes[nm],
                                  dtype=self.input_dtypes[nm])
                     for nm in self.data_names}
            self.forward(bucket, zeros)          # builds what is unbuilt
            t0 = clock.now()
            outs = self.forward(bucket, zeros)   # steady state
            for o in outs:
                o.asnumpy()                      # waits for the device
            self.exec_est[bucket] = max(0.0, clock.now() - t0)
        self._warm_mark = compile_count()
        self.warmup_compiles = self._warm_mark - mark
        return dict(self.exec_est)

    def compiles_since_warmup(self):
        """Kernel libraries built or loaded since warmup finished (must
        be 0 in steady state), or None before warmup."""
        if self._warm_mark is None:
            return None
        return compile_count() - self._warm_mark

    def program_keys(self):
        """Program-cache keys of the rungs: none, eager PyTorch has no
        program cache."""
        return []

    def programs_resident(self):
        return True


class BucketEngine(_EngineBase):
    """Symbol + params serving over a batch-size bucket ladder."""

    def __init__(self, name, symbol, arg_params, aux_params, data_shapes,
                 label_names=("softmax_label",), ladder=None, context=None,
                 compute_dtype=None, logger=None):
        """``data_shapes``: dict input name -> per-ROW shape (no batch
        dim) or list of ``(name, per_row_shape)``; the ladder supplies
        the batch dims. ``label_names`` are the loss-head inputs, bound
        zero-filled per rung and ignored by inference."""
        super().__init__(name, ladder)
        from ..context import current_context
        from ..module import BucketingModule

        self.quantized = None
        if compute_dtype is not None:
            if str(compute_dtype) not in _QUANT_TIERS:
                raise MXNetError(
                    f"model {name!r}: compute_dtype={compute_dtype!r} — "
                    "mixed precision is not ported yet (a later slice); "
                    f"the port serves float32 or a quantized tier "
                    f"{_QUANT_TIERS}")
            from ..ops import quant as _quant
            symbol, arg_params = _quant.quantize_symbol(
                symbol, dict(arg_params or {}), dtype=str(compute_dtype))
            self.quantized = str(compute_dtype)

        if isinstance(data_shapes, dict):
            data_shapes = list(data_shapes.items())
        self.data_names = tuple(nm for nm, _ in data_shapes)
        self.example_shapes = {nm: tuple(s) for nm, s in data_shapes}
        self._symbol = symbol
        self._label_names = [nm for nm in (label_names or [])
                             if nm in symbol.list_arguments()]
        self._label_shape_cache = {}
        self._context = context if context is not None else current_context()

        # bucket key == batch size; every rung shares the leader's
        # parameter cells
        self._bm = BucketingModule(
            sym_gen=lambda bucket: (symbol, list(self.data_names),
                                    list(self._label_names)),
            default_bucket_key=self.ladder.max,
            logger=logger or log, context=self._context)
        self._bm.bind(self._provide_data(self.ladder.max),
                      label_shapes=self._provide_label(self.ladder.max),
                      for_training=False)
        self._bm.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params)
        self._bm.warm_buckets(
            [(b, self._provide_data(b), self._provide_label(b))
             for b in self.ladder])

        # input dtypes as bound (what the rung modules take)
        leader = self._bm._buckets[self.ladder.max]
        arg_dict = leader._exec_group.executor.arg_dict
        self.input_dtypes = {
            nm: np.dtype(arg_dict[nm].dtype) if nm in arg_dict
            else np.float32
            for nm in self.data_names}

    def _provide_data(self, bucket):
        return [DataDesc(nm, (bucket,) + self.example_shapes[nm],
                         dtype=self.input_dtypes.get(nm, np.float32))
                for nm in self.data_names]

    def _provide_label(self, bucket):
        """Label shapes for one rung, inferred from the symbol against
        the rung's data shapes (None when the head has no label)."""
        if not self._label_names:
            return None
        if bucket not in self._label_shape_cache:
            known = {nm: (bucket,) + self.example_shapes[nm]
                     for nm in self.data_names}
            inferred, _, _ = self._symbol.infer_shape(**known)
            by_name = dict(zip(self._symbol.list_arguments(), inferred))
            self._label_shape_cache[bucket] = [
                DataDesc(nm, by_name[nm]) for nm in self._label_names
                if by_name.get(nm) is not None]
        return self._label_shape_cache[bucket] or None

    def forward(self, bucket, values):
        """Run one rung over an assembled batch (``values``: name ->
        array with exactly ``bucket`` rows)."""
        if bucket not in self.ladder.sizes:
            raise MXNetError(f"model {self.name!r}: {bucket} is not a "
                             f"ladder rung {self.ladder.sizes}")
        batch = DataBatch(
            data=[NDArray(np.ascontiguousarray(values[nm]),
                          ctx=self._context)
                  for nm in self.data_names],
            label=None, bucket_key=bucket,
            provide_data=self._provide_data(bucket),
            provide_label=self._provide_label(bucket))
        self._bm.forward(batch, is_train=False)
        return self._bm.get_outputs()


class PredictorEngine(_EngineBase):
    """Serving an exported ``.mxp`` artifact: not ported yet."""

    def __init__(self, name, predictor, ladder=None):
        raise MXNetError(
            f"model {name!r}: .mxp artifacts hold StableHLO programs, and "
            "predict.py (Predictor, export_model) is not ported yet (a "
            "later slice); register the Module or symbol + params instead")
