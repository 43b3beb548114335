"""The single operator registry.

Every op is a plain PyTorch function plus declarative metadata; the same
definition serves imperative ``mx.nd.*`` calls and the executor's graph
interpreter. The forward contract is the JAX package's, verbatim:

    forward(attrs, inputs, aux, is_train, rng) -> (outputs, new_aux)

where ``attrs`` is the typed param dict and ``inputs``/``aux`` are lists of
``torch.Tensor``. Most ops register a *simple* forward
``fn(attrs, *inputs) -> tensor|tuple`` and are wrapped.

Kernels: an op whose computation has a hand-written CUDA kernel carries it
as its ``"cuda"`` variant. ``dispatch`` picks by device and nothing else:
inputs on a CUDA device run the variant (which launches the kernel or
raises), inputs on the CPU run ``forward``, the plain version. There is
no shape gate, no autotuner and no fallback from a kernel to the plain
version.

Gradients: a plain forward is differentiable through PyTorch's autograd
(the loss heads are ``torch.autograd.Function``s with the JAX package's
custom backward). A ``"cuda"`` variant is differentiable when it is an
``autograd.Function`` whose backward is a kernel too; one whose backward
kernel is not ported yet is registered with ``backward_pending`` naming
that kernel, and ``dispatch`` refuses to run it on inputs that require
grad — its output would carry no autograd history, and the gradient
would be lost without a word.
"""
from __future__ import annotations

import inspect

import torch

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "OP_REGISTRY",
           "dispatch", "refuse_without_backward"]

OP_REGISTRY = {}


class OpDef:
    """Metadata + implementations for one operator.

    Parameters
    ----------
    name : canonical op name (the public API surface name).
    forward : full-signature plain forward (attrs, inputs, aux, is_train,
        rng) — the version CPU tensors run.
    inputs : list of input names, or callable(attrs)->list.
    aux : auxiliary-state names.
    num_outputs : int or callable(attrs)->int.
    output_names : list or callable(attrs)->list.
    attr_spec : dict name -> (parser, default). Unknown kwargs are kept
        verbatim (JSON round-trips tolerate extra attrs).
    infer_shape : optional fn(attrs, in_shapes[, out_known]) ->
        (in_shapes, out_shapes, aux_shapes). When absent, shapes come from
        running the plain forward on meta tensors.
    shape_passthrough : the op is shape-identity on its first input.
    variants : ``{"cuda": forward}`` — the kernel-backed forward CUDA
        tensors run.
    is_loss : the op is a loss head: its backward ignores the incoming
        head gradient, and ``Executor.backward`` seeds ones for it.
    mutate_inputs : names of inputs the op updates (the optimizer ops):
        output k is the new value of input ``mutate_inputs[k]``, and
        ``imperative_invoke`` writes it into that input's handle.
    stateful_infer : the op's aux states are read AND written during
        inference forwards (the KV-cache decode contract) — the executor
        writes ``new_aux`` back even when ``is_train=False``.
    aux_dtypes : dict aux name -> dtype (or callable(attrs) -> dtype|None)
        for aux cells that must not bind as float32 (a KV cache's int32
        cursor).
    """

    def __init__(self, name, forward, inputs=("data",), aux=(),
                 num_outputs=1, output_names=None, attr_spec=None,
                 infer_shape=None, num_visible=None, shape_passthrough=False,
                 variants=None, stateful_infer=False, aux_dtypes=None,
                 is_loss=False, mutate_inputs=()):
        self.name = name
        self.is_loss = bool(is_loss)
        self.mutate_inputs = tuple(mutate_inputs)
        self.forward = forward
        self.variants = {}
        for vname, vfn in (variants or {}).items():
            self.add_variant(vname, vfn)
        self._inputs = inputs
        self._aux = aux
        self._num_outputs = num_outputs
        self._num_visible = num_visible
        self._output_names = output_names
        self.attr_spec = attr_spec or {}
        self.infer_shape = infer_shape
        self.stateful_infer = bool(stateful_infer)
        self.aux_dtypes = dict(aux_dtypes or {})
        self.shape_passthrough = bool(shape_passthrough)
        self._infer_accepts_out = _validate_infer_signature(
            name, "infer_shape", infer_shape)

    # --- variadic-aware accessors ---------------------------------------
    def input_names(self, attrs=None):
        if callable(self._inputs):
            return list(self._inputs(attrs or {}))
        return list(self._inputs)

    def aux_names(self, attrs=None):
        if callable(self._aux):
            return list(self._aux(attrs or {}))
        return list(self._aux)

    def num_outputs(self, attrs=None):
        if callable(self._num_outputs):
            return self._num_outputs(attrs or {})
        return self._num_outputs

    def num_visible_outputs(self, attrs=None):
        """Outputs exposed to composition (LayerNorm hides mean/std)."""
        if self._num_visible is None:
            return self.num_outputs(attrs)
        if callable(self._num_visible):
            return self._num_visible(attrs or {})
        return self._num_visible

    def output_names(self, attrs=None):
        if self._output_names is None:
            n = self.num_outputs(attrs)
            return ["output"] if n == 1 else [f"output{i}" for i in range(n)]
        if callable(self._output_names):
            return list(self._output_names(attrs or {}))
        return list(self._output_names)

    # --- kernel variants --------------------------------------------------
    def add_variant(self, name, forward, backward_pending=None):
        """Attach the kernel-backed forward for one device (``"cuda"``).
        ``backward_pending`` names the backward kernel that is still to
        be ported when the variant has none: ``dispatch`` then raises on
        inputs that require grad."""
        if name != "cuda":
            raise MXNetError(
                f"op {self.name!r}: variant {name!r} — the port keys "
                "kernel variants by device, and only 'cuda' exists")
        self.variants[name] = {"fn": forward,
                               "backward_pending": backward_pending}
        return self

    def normalize_attrs(self, kwargs):
        """Parse raw kwargs/JSON strings into the typed attr dict."""
        attrs = {}
        for key, val in kwargs.items():
            if val is None:
                continue
            spec = self.attr_spec.get(key)
            if spec is not None:
                parser = spec[0]
                attrs[key] = parser(val) if parser else val
            else:
                attrs[key] = val
        for key, spec in self.attr_spec.items():
            if key not in attrs and len(spec) > 1 and spec[1] is not None:
                attrs[key] = spec[1]
        return attrs

    def __repr__(self):
        return f"OpDef({self.name})"


def dispatch(opdef, attrs, inputs, aux, is_train, rng):
    """Run one op: the ``"cuda"`` variant when its tensors lie on a CUDA
    device and the op has one, the plain ``forward`` otherwise. The
    device of the first tensor input (else the first aux) decides."""
    lead = next((t for t in list(inputs) + list(aux) if t is not None),
                None)
    if lead is not None and lead.device.type == "cuda" and \
            "cuda" in opdef.variants:
        variant = opdef.variants["cuda"]
        refuse_without_backward(opdef, variant, inputs)
        return variant["fn"](attrs, inputs, aux, is_train, rng)
    return opdef.forward(attrs, inputs, aux, is_train, rng)


def refuse_without_backward(opdef, variant, inputs):
    """Raise when ``variant`` has no backward kernel yet and would run,
    with autograd recording, on an input that requires grad: its output
    would carry no history and the gradient would be lost."""
    pending = variant["backward_pending"]
    if pending and torch.is_grad_enabled() and \
            any(t is not None and t.requires_grad for t in inputs):
        raise MXNetError(
            f"op {opdef.name!r}: its CUDA kernel has no backward yet "
            f"({pending} is still to be ported), so it cannot run on "
            "inputs that require grad")


def _validate_infer_signature(op_name, what, fn):
    """Registration-time arity check for infer_shape/infer_type; returns
    whether the fn accepts the optional third ``out_known`` argument."""
    if fn is None:
        return False
    if not callable(fn):
        raise MXNetError(
            f"op {op_name!r}: {what} must be callable, got "
            f"{type(fn).__name__}")
    try:
        sig = inspect.signature(fn)
    except (ValueError, TypeError):
        return False
    required = 0
    max_positional = 0
    has_varargs = False
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            max_positional += 1
            if p.default is p.empty:
                required += 1
        elif p.kind == p.VAR_POSITIONAL:
            has_varargs = True
    if not has_varargs and (max_positional < 2 or required > 3):
        raise MXNetError(
            f"op {op_name!r}: {what} must accept (attrs, in_shapes"
            f"[, out_known]), got signature {sig}")
    return has_varargs or max_positional >= 3


def _wrap_simple(fn):
    """Lift fn(attrs, *inputs) -> tensor|tuple into the full signature."""
    def forward(attrs, inputs, aux, is_train, rng):
        out = fn(attrs, *inputs)
        if isinstance(out, (tuple, list)):
            return list(out), []
        return [out], []
    return forward


def register(name, inputs=("data",), simple=None, full=None, **kw):
    """Register an op: ``simple=fn`` takes fn(attrs, *inputs), ``full=fn``
    the 5-arg signature; as a decorator it wraps a simple fn."""

    def do_register(fn, is_full):
        forward = fn if is_full else _wrap_simple(fn)
        if name in OP_REGISTRY:
            raise MXNetError(f"op {name!r} registered twice")
        OP_REGISTRY[name] = OpDef(name, forward, inputs=inputs, **kw)
        return fn

    if simple is not None:
        do_register(simple, False)
        return OP_REGISTRY[name]
    if full is not None:
        do_register(full, True)
        return OP_REGISTRY[name]

    def decorator(fn):
        do_register(fn, False)
        return fn

    return decorator


def alias(new_name, existing):
    """Register an alternative public name for an existing op."""
    opdef = get_op(existing)
    if new_name not in OP_REGISTRY:
        OP_REGISTRY[new_name] = opdef
    return opdef


def get_op(name):
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} is not registered") from None


def list_ops():
    return sorted(OP_REGISTRY)
