"""CustomOp: Python-defined operators inside nd and sym graphs.

MXNet's extension point for a layer written in Python: a
``CustomOpProp`` subclass registered under a name, and the graph node
``Custom(op_type=name)`` that calls its ``CustomOp``'s ``forward`` and
``backward``. The JAX package runs the body on the host through
``jax.pure_callback`` under a ``jax.custom_vjp``; here it runs inside a
``torch.autograd.Function``, whose ``forward`` and ``backward`` call the
user's on NDArrays over the tensors of the graph's own device (detached,
so nothing the body computes records autograd). A body that calls
``asnumpy()`` pays the host round trip the JAX package pays through its
callback; a body written with NDArray arithmetic and ``mx.nd`` ops stays
on the device. ``create_operator`` is called for every forward and every
backward, as the JAX package calls it. Aux states get zero gradients,
and whatever the body writes into them is dropped, as in the JAX
package. An op whose prop says ``need_top_grad=False`` sees the head
gradient the executor seeds for a non-loss output: zeros, the JAX
executor's (``Custom`` is no loss head), which its ``backward`` ignores.

Usage is MXNet's::

    @mx.operator.register("mysigmoid")
    class MySigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return MySigmoid()

    y = mx.nd.Custom(x, op_type="mysigmoid")
    s = mx.sym.Custom(data, op_type="mysigmoid", name="sig")

The legacy ``PythonOp`` / ``NumpyOp`` / ``NDArrayOp`` family is a thin
adapter over the same ``Custom`` op.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import context_of
from .ndarray import NDArray, _np_dtype, to_torch_dtype
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "PythonOp", "NumpyOp", "NDArrayOp"]

_CUSTOM_PROPS: dict = {}


class CustomOp:
    """Base class of a Python operator body."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute the outputs; write them with ``self.assign(out_data[i],
        req[i], value)``."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute the input gradients into ``in_grad`` (default: zero)."""
        for i, g in enumerate(in_grad):
            self.assign(g, req[i] if i < len(req) else "write",
                        np.zeros(g.shape, np.float32))

    @staticmethod
    def assign(dst, req, src):
        """Write ``src`` (an NDArray, numpy array or scalar) into the
        NDArray ``dst`` under ``req``; an NDArray stays on its device."""
        if req == "null":
            return
        t = dst.astorch()
        val = src.astorch() if isinstance(src, NDArray) \
            else torch.as_tensor(np.asarray(src))
        val = val.to(device=t.device, dtype=t.dtype).reshape(t.shape)
        if req in ("write", "inplace"):
            dst._set(val)
        elif req == "add":
            dst._set(t + val)
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Declarative metadata of a CustomOp (names, shapes, factory)."""

    def __init__(self, need_top_grad=False):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes=None):
        return CustomOp()


def register(reg_name):
    """Class decorator registering a CustomOpProp under ``reg_name``."""
    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() expects a CustomOpProp subclass")
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls
    return deco


def get_all_registered():
    return dict(_CUSTOM_PROPS)


# ---------------------------------------------------------------- plumbing
def _prop_for(attrs):
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    try:
        cls = _CUSTOM_PROPS[op_type]
    except KeyError:
        raise MXNetError(
            f"no CustomOpProp registered as {op_type!r} "
            f"(registered: {sorted(_CUSTOM_PROPS)})") from None
    kwargs = {k: str(v) for k, v in attrs.items()
              if k != "op_type" and not k.startswith("__")}
    return cls(**kwargs)


def _cells(tensors):
    """Detached NDArray cells over ``tensors``, for the user's body."""
    return [NDArray(t.detach(), ctx=context_of(t.device)) for t in tensors]


def _operator(prop, tensors):
    """A fresh CustomOp for inputs ``tensors``, as the JAX package makes
    one per call."""
    ctx = context_of(tensors[0].device) if tensors else None
    return prop.create_operator(ctx, [list(t.shape) for t in tensors],
                                [_np_dtype(t.dtype) for t in tensors])


class _CustomFn(torch.autograd.Function):
    """The user's forward as the autograd node's forward, the user's
    backward as its backward; aux states get zero gradients."""

    @staticmethod
    def forward(ctx, prop, is_train, n_in, *tensors):
        inputs, aux = tensors[:n_in], tensors[n_in:]
        in_data, aux_data = _cells(inputs), _cells(aux)
        in_shapes = [list(t.shape) for t in inputs]
        _, out_shapes, _ = prop.infer_shape(in_shapes)
        _, out_types, _ = prop.infer_type(
            [_np_dtype(t.dtype) for t in inputs] or [np.dtype(np.float32)])
        dev = inputs[0].device if inputs else torch.device("cpu")
        out_data = [NDArray(torch.zeros(tuple(s), dtype=to_torch_dtype(dt),
                                        device=dev))
                    for s, dt in zip(out_shapes, out_types)]
        _operator(prop, inputs).forward(bool(is_train),
                                        ["write"] * len(out_data), in_data,
                                        out_data, aux_data)
        # an output that aliases an input (a body that assigned an input
        # cell as it is) is copied: autograd wants outputs of their own
        given = {t.data_ptr() for t in tensors}
        outs = [o.astorch() for o in out_data]
        outs = [o.clone() if o.data_ptr() in given else o for o in outs]
        ctx.prop, ctx.n_in = prop, n_in
        ctx.save_for_backward(*tensors, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *out_grads):
        saved = ctx.saved_tensors
        n_in, n_out = ctx.n_in, len(out_grads)
        tensors, outs = saved[:len(saved) - n_out], saved[len(saved) - n_out:]
        inputs, aux = tensors[:n_in], tensors[n_in:]
        in_grad = [NDArray(torch.zeros_like(t)) for t in inputs]
        _operator(ctx.prop, inputs).backward(
            ["write"] * len(in_grad), _cells(out_grads), _cells(inputs),
            _cells(outs), in_grad, _cells(aux))
        grads = [g.astorch() for g in in_grad]
        return (None, None, None, *grads,
                *[torch.zeros_like(t) for t in aux])


def _custom_forward(attrs, inputs, aux, is_train, rng):
    prop = _prop_for(attrs)
    n_in = len(prop.list_arguments())
    outs = _CustomFn.apply(prop, bool(is_train), n_in, *inputs, *aux)
    return list(outs), list(aux)


def _custom_infer_shape(attrs, in_shapes):
    prop = _prop_for(attrs)
    n_in = len(prop.list_arguments())
    ins = [list(s) if s is not None else None for s in in_shapes[:n_in]]
    if any(s is None or 0 in s for s in ins):
        n_aux = len(prop.list_auxiliary_states())
        return (list(in_shapes), [None] * len(prop.list_outputs()),
                [None] * n_aux)
    new_in, out_shapes, aux_shapes = prop.infer_shape(ins)
    return ([tuple(s) for s in new_in],
            [tuple(s) for s in out_shapes],
            [tuple(s) for s in (aux_shapes or [])])


def _custom_bytes(attrs, in_shapes):
    """Each input read once and each output written once (the body's
    operations are unknown: 0 FLOPs). The accounting sees shapes alone:
    inputs count at its 4 B an element (``ops/cost.py``), outputs at the
    width ``infer_type`` gives them from float32 inputs."""
    prop = _prop_for(attrs)
    _, outs, _ = _custom_infer_shape(attrs, in_shapes)
    _, out_types, _ = prop.infer_type(
        [np.dtype(np.float32)] * len(prop.list_arguments()))
    return 4.0 * sum(int(np.prod(s)) for s in in_shapes) + sum(
        int(np.prod(s)) * to_torch_dtype(dt).itemsize
        for s, dt in zip(outs, out_types))


_register_op("Custom",
             inputs=lambda attrs: _prop_for(attrs).list_arguments(),
             aux=lambda attrs: _prop_for(attrs).list_auxiliary_states(),
             num_outputs=lambda attrs: len(_prop_for(attrs).list_outputs()),
             output_names=lambda attrs: _prop_for(attrs).list_outputs(),
             infer_shape=_custom_infer_shape,
             full=_custom_forward).set_cost(
    flops=lambda attrs, in_shapes: 0.0, bytes_moved=_custom_bytes)


# ------------------------------------------------- legacy PythonOp family
class PythonOp:
    """MXNet's deprecated operator API, kept so pre-CustomOp scripts run:
    subclass, override forward / backward / infer_shape / list_*, call
    the instance on input symbols. An adapter over ``Custom``."""

    _counter = [0]

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError("Must override this")

    def forward(self, in_data, out_data):
        out_data[0][:] = in_data[0]

    def backward(self, out_grad, in_data, out_data, in_grad):
        in_grad[0][:] = 1.0

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def _register(self):
        """Register this instance as a CustomOpProp under a unique name,
        once (``info_``, MXNet's slot for it)."""
        if self.info_ is not None:
            return self.info_
        outer = self
        PythonOp._counter[0] += 1
        op_type = f"_python_op_{type(self).__name__}_{self._counter[0]}"

        class _LegacyAdapter(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                ins, outs = outer._adapt(in_data), outer._adapt(out_data)
                outer.forward(in_data=ins, out_data=outs)
                for dst, r, val in zip(out_data, req, outs):
                    self.assign(dst, r or "write", val)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                og, ind, outd, ing = (outer._adapt(out_grad),
                                      outer._adapt(in_data),
                                      outer._adapt(out_data),
                                      outer._adapt(in_grad))
                outer.backward(out_grad=og, in_data=ind, out_data=outd,
                               in_grad=ing)
                for dst, r, val in zip(in_grad, req, ing):
                    self.assign(dst, r or "write", val)

        class _LegacyProp(CustomOpProp):
            def __init__(self, **_ignored):
                super().__init__(need_top_grad=outer.need_top_grad())

            def list_arguments(self):
                return outer.list_arguments()

            def list_outputs(self):
                return outer.list_outputs()

            def infer_shape(self, in_shape):
                res = outer.infer_shape(in_shape)
                aux = res[2] if len(res) > 2 else []
                return res[0], res[1], aux

            def create_operator(self, ctx, in_shapes, in_dtypes=None):
                return _LegacyAdapter()

        register(op_type)(_LegacyProp)
        self.info_ = op_type
        return op_type


class NumpyOp(PythonOp):
    """Deprecated: a PythonOp whose forward / backward see numpy arrays,
    to mutate in place (``out_data[i][:] = ...``); the adapter copies
    them back."""

    def _adapt(self, arrays):
        return [np.array(a.asnumpy() if isinstance(a, NDArray) else a)
                for a in arrays]

    def get_symbol(self, *args, **kwargs):
        from . import symbol
        return symbol.Custom(*args, op_type=self._register(), **kwargs)


class NDArrayOp(PythonOp):
    """Deprecated: a PythonOp whose forward / backward see NDArrays."""

    def _adapt(self, arrays):
        return list(arrays)

    def get_symbol(self, *args, **kwargs):
        from . import symbol
        return symbol.Custom(*args, op_type=self._register(), **kwargs)
