"""Deployment surface: export a trained graph, run it standalone.

The port's counterpart of ``mxnet_tpu/predict.py`` (reference: the C
predict API, ``MXPredCreate`` / ``MXPredForward`` / ``MXPredGetOutput``):
``export_model`` writes one artifact holding the inference graph, its
trained weights and a manifest, and ``Predictor`` loads it and runs it
with no Module and no initializer — load, bind, call. Shapes are fixed at
export time (re-export to reshape, like ``MXPredReshape``).

The artifact is the port's own. The JAX package's ``.mxp`` holds a
StableHLO program (``program.stablehlo``), which PyTorch cannot run; the
port's zip holds in its place the symbol:

* ``manifest.json`` — the JAX manifest's fields (``format_version``,
  ``inputs``, ``input_dtypes``, ``param_names``, ``aux_names``,
  ``output_names``, ``compute_dtype``, ``quantize``,
  ``quantized_weights``, ``stateful``) plus ``"program": "symbol"``;
* ``symbol.json`` — the graph (already quantized under ``quantize=``);
* ``weights.params`` — ``arg:`` / ``aux:`` entries in the reference
  format ``mx.nd.save`` writes.

``Predictor`` binds one ``Executor`` over them on the card (or the
context given), so the path runs the same CUDA kernels as a bound Module:
the quantized tiers' ``qfc_matmul`` and ``dequant_rows_multi``, the
decode graph's embedding, LayerNorm, bias-GeLU and decode-read kernels.
A forward runs under the random key ``(0, 0)``, as the JAX package's
exported program does, and leaves ``mx.random``'s chain alone. A JAX
``.mxp`` given to ``Predictor`` raises naming its format.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["export_model", "Predictor"]

_FORMAT_VERSION = 1
_PROGRAM = "symbol"
_MANIFEST = "manifest.json"
_SYMBOL = "symbol.json"
_PARAMS = "weights.params"
_JAX_PROGRAM = "program.stablehlo"


def _dtype_name(dtype):
    """A dtype spelling (numpy, torch or a string) -> its name."""
    from .ndarray import to_torch_dtype
    return str(to_torch_dtype(dtype)).replace("torch.", "")


def _host_dtype(name):
    """The numpy dtype a host input of a recorded dtype is given in
    (numpy has no bfloat16: such an input is given in float32 and cast
    by the forward)."""
    return np.dtype("float32") if name == "bfloat16" else np.dtype(name)


def _value(p):
    """A parameter (NDArray, tensor or array) as a CPU tensor."""
    from .ndarray import NDArray
    if isinstance(p, NDArray):
        return p.astorch().detach().cpu()
    if isinstance(p, torch.Tensor):
        return p.detach().cpu()
    return torch.from_numpy(np.array(p))


def export_model(path, symbol, arg_params, aux_params, data_shapes,
                 compute_dtype=None, data_dtypes=None, quantize=None):
    """Write the inference artifact of ``symbol`` to ``path``.

    ``data_shapes``: dict input name -> shape (the non-parameter inputs,
    like MXPredCreate's input_shapes). ``arg_params`` / ``aux_params``:
    trained parameters (NDArray, tensor or array). ``compute_dtype``:
    ``"bfloat16"`` / ``"float16"`` mixed precision, recorded and bound by
    ``Predictor``. ``data_dtypes``: dict input name -> dtype (default
    float32), recorded per input: integer ids (embedding models, token
    streams) round-trip through the artifact. ``quantize="int8"`` /
    ``"fp8"``: per-channel weight quantization at export
    (``ops/quant.py``); the artifact holds the quantized graph and the
    narrow weights with their float32 scales, and outputs stay within
    ``quant.INT8_TOL`` / ``quant.FP8_TOL`` of the float export. Inputs
    that are neither data nor trained (loss-head labels) are zero-filled
    at their inferred shapes, and aux states without a trained value (a
    decoder's KV caches and cursors) at their inferred shapes and
    declared dtypes: the empty cache is the exported snapshot."""
    from .executor import parse_compute_dtype
    from .ndarray import NDArray, save as nd_save
    from .context import cpu

    quantized_weights = []
    if quantize is not None:
        from .ops import quant as _quant
        before = set(arg_params)
        symbol, arg_params = _quant.quantize_symbol(
            symbol, dict(arg_params), dtype=quantize)
        quantized_weights = sorted(before - set(arg_params))
    cdt = parse_compute_dtype(compute_dtype)

    data_shapes = {k: tuple(v) for k, v in data_shapes.items()}
    data_dtypes = {k: _dtype_name((data_dtypes or {}).get(k, "float32"))
                   for k in data_shapes}
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    param_names = [n for n in arg_names
                   if n not in data_shapes and n in arg_params]
    zero_names = [n for n in arg_names
                  if n not in data_shapes and n not in arg_params]
    arg_shapes, _, aux_shapes = symbol.infer_shape(**data_shapes)
    arg_shape = dict(zip(arg_names, arg_shapes))
    params = {n: _value(arg_params[n]) for n in param_names}
    for n in zero_names:
        if arg_shape.get(n) is None:
            raise MXNetError(f"export_model: no params and no inferable "
                             f"shape for input {n!r}")
        params[n] = torch.zeros(arg_shape[n], dtype=torch.float32)
    aux_params = aux_params or {}
    aux_shape = dict(zip(aux_names, aux_shapes))
    from .executor import aux_dtypes
    declared = aux_dtypes(symbol)
    aux = {}
    for n in aux_names:
        if n in aux_params:
            aux[n] = _value(aux_params[n])
        elif aux_shape.get(n) is not None:
            aux[n] = torch.zeros(aux_shape[n], dtype=declared[n])
        else:
            raise MXNetError(f"export_model: no value and no inferable "
                             f"shape for aux state {n!r}")
    stateful = any(not n.is_variable and n.opdef().stateful_infer
                   for n in symbol._topo_nodes())

    manifest = {
        "format_version": _FORMAT_VERSION,
        "program": _PROGRAM,
        "inputs": {n: list(s) for n, s in data_shapes.items()},
        "input_dtypes": data_dtypes,
        "param_names": param_names + zero_names,
        "aux_names": aux_names,
        "output_names": symbol.list_outputs(),
        "compute_dtype": None if cdt is None else _dtype_name(cdt),
        "quantize": quantize,
        "quantized_weights": quantized_weights,
        "stateful": stateful,
    }
    host = cpu()
    with tempfile.TemporaryDirectory() as td:
        pfile = os.path.join(td, "w.params")
        nd_save(pfile, {**{f"arg:{n}": NDArray(v, ctx=host)
                           for n, v in params.items()},
                        **{f"aux:{n}": NDArray(v, ctx=host)
                           for n, v in aux.items()}})
        with zipfile.ZipFile(path, "w") as z:
            z.writestr(_MANIFEST, json.dumps(manifest, indent=1))
            z.writestr(_SYMBOL, symbol.tojson())
            z.write(pfile, _PARAMS)
    return path


class Predictor:
    """Load and run an artifact of ``export_model`` (the reference predict
    API's create / forward / get_output cycle) on ``device`` (a Context;
    default the current context, ``gpu(0)`` unless a ``with mx.cpu():``
    scope says otherwise — without CUDA that raises)."""

    def __init__(self, path, device=None):
        from .context import current_context
        from .executor import Executor
        from .ndarray import NDArray, load as nd_load
        from .symbol import load_json

        self._path = path       # serve/warm.py re-registers from it
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            if _JAX_PROGRAM in names or _SYMBOL not in names:
                raise MXNetError(
                    f"{path}: a .mxp artifact of the JAX package (a "
                    "StableHLO program, program.stablehlo), which the "
                    "PyTorch port cannot run; export the model with "
                    "mxnet_tpu_torch.export_model (its artifact holds "
                    "the symbol)")
            self._manifest = json.loads(z.read(_MANIFEST))
            if self._manifest.get("format_version") != _FORMAT_VERSION or \
                    self._manifest.get("program") != _PROGRAM:
                raise MXNetError(
                    f"{path}: unsupported artifact (format_version "
                    f"{self._manifest.get('format_version')!r}, program "
                    f"{self._manifest.get('program')!r})")
            symbol = load_json(z.read(_SYMBOL).decode())
            with tempfile.TemporaryDirectory() as td:
                pfile = os.path.join(td, "w.params")
                with open(pfile, "wb") as f:
                    f.write(z.read(_PARAMS))
                loaded = nd_load(pfile)
        self._ctx = device if device is not None else current_context()
        dev = self._ctx.torch_device()

        def cell(t):
            return NDArray(t.astorch().to(dev), ctx=self._ctx)

        from .ndarray import to_torch_dtype
        args = {n: cell(loaded[f"arg:{n}"])
                for n in self._manifest["param_names"]}
        for n, shape in self._manifest["inputs"].items():
            args[n] = NDArray(torch.zeros(
                shape, dtype=to_torch_dtype(
                    self._manifest["input_dtypes"][n]), device=dev),
                ctx=self._ctx)
        aux = {n: cell(loaded[f"aux:{n}"])
               for n in self._manifest["aux_names"]}
        self._exe = Executor(symbol, self._ctx, args, None, "null", aux,
                             compute_dtype=self._manifest.get(
                                 "compute_dtype"))
        # stateful artifacts (KV-cache decoders) advance their aux each
        # forward; keep the exported snapshot for reset_state()
        self._aux0 = {n: a.astorch().clone() for n, a in aux.items()} \
            if self.stateful else None
        self._key = _random.prng_key(0)
        self._outputs = None

    @property
    def context(self):
        return self._ctx

    @property
    def output_names(self):
        return list(self._manifest["output_names"])

    @property
    def input_shapes(self):
        return {n: tuple(s) for n, s in self._manifest["inputs"].items()}

    @property
    def quantize(self):
        """The artifact's quantization (``"int8"`` / ``"fp8"``) or None."""
        return self._manifest.get("quantize")

    @property
    def stateful(self):
        """True for stateful-inference artifacts (KV-cache decoders):
        each ``forward`` advances the carried aux state (the cache);
        ``reset_state()`` rewinds it to the exported snapshot."""
        return bool(self._manifest.get("stateful"))

    @property
    def input_dtypes(self):
        """Per-input host dtypes (numpy) of the recorded input dtypes."""
        recorded = self._manifest.get("input_dtypes") or {}
        return {n: _host_dtype(recorded.get(n, "float32"))
                for n in self._manifest["inputs"]}

    def reset_state(self):
        """Rewind a stateful artifact's carried aux (the KV cache) to its
        exported snapshot. No-op for stateless artifacts."""
        if self._aux0 is None:
            return
        for n, snap in self._aux0.items():
            self._exe.aux_dict[n]._set(snap.clone())

    def reset_slot(self, slot):
        """Slot-pooled decode artifacts (``get_decode_symbol(
        per_slot=True)`` exports): rewind ONE slot's cache cursors (the
        two-dimensional ``*cache_pos`` aux cells) to the exported
        snapshot, leaving every other slot's state untouched — the join
        seam of continuous batching. The cache rows need no reset:
        positions past a slot's cursor get exactly zero attention weight.
        No-op for stateless artifacts."""
        if self._aux0 is None:
            return
        s = int(slot)
        for n, snap in self._aux0.items():
            if n.endswith("cache_pos") and snap.ndim == 2:
                cur = self._exe.aux_dict[n]
                t = cur.astorch().clone()
                t[s] = snap[s].to(t.device)
                cur._set(t)

    def forward(self, **inputs):
        """Run the graph once; returns the output list. Inputs (NDArray
        or array-like) are cast to the recorded per-input dtype and must
        have the exported shape."""
        from .ndarray import NDArray
        data = {}
        for n, shape in self.input_shapes.items():
            if n not in inputs:
                raise MXNetError(f"missing input {n!r}")
            v = inputs[n]
            got = tuple(v.shape) if hasattr(v, "shape") else \
                np.shape(v)
            if tuple(got) != shape:
                raise MXNetError(
                    f"input {n!r}: shape {tuple(got)} != exported {shape} "
                    "(re-export to reshape, like MXPredReshape)")
            data[n] = v if isinstance(v, NDArray) else np.asarray(v)
        self._outputs = list(self._exe.forward_with_key(self._key, False,
                                                        **data))
        return self._outputs

    def batch_forward(self, **inputs):
        """Forward with a DYNAMIC leading batch dim: any number of rows
        run through the exported batch in windows, the tail window
        zero-padded (``serve.batching.pad_rows``) and sliced back
        (``slice_rows``); returns outputs with the caller's row count."""
        from .ndarray import NDArray
        from .serve.batching import pad_rows, slice_rows

        shapes = self.input_shapes
        dtypes = self.input_dtypes
        batch = next(iter(shapes.values()))[0]
        vals, rows = {}, None
        for n, shape in shapes.items():
            if n not in inputs:
                raise MXNetError(f"missing input {n!r}")
            if shape[0] != batch:
                raise MXNetError(
                    "batch_forward needs a common exported batch dim; "
                    f"input {n!r} has {shape[0]} != {batch}")
            v = inputs[n]
            v = np.asarray(v.asnumpy() if isinstance(v, NDArray) else v,
                           dtype=dtypes[n])
            if tuple(v.shape[1:]) != shape[1:]:
                raise MXNetError(
                    f"input {n!r}: rows of shape {tuple(v.shape[1:])} != "
                    f"exported {shape[1:]}")
            if rows is None:
                rows = v.shape[0]
            elif v.shape[0] != rows:
                raise MXNetError("inputs disagree on the row count")
            vals[n] = v
        if not rows:
            raise MXNetError("batch_forward needs at least one row")
        per_window = []
        for off in range(0, rows, batch):
            n_valid = min(batch, rows - off)
            outs = self.forward(**{n: pad_rows(v[off:off + n_valid], batch)
                                   for n, v in vals.items()})
            per_window.append(slice_rows(outs, 0, n_valid))
        merged = [per_window[0][i] if len(per_window) == 1 else
                  NDArray(torch.cat([w[i].astorch() for w in per_window]),
                          ctx=self._ctx)
                  for i in range(len(per_window[0]))]
        self._outputs = merged
        return merged

    def get_output(self, index=0):
        """reference: MXPredGetOutput — output of the last forward."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index]
