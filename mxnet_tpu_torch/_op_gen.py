"""Auto-generation of the ``mx.nd.*`` imperative functions from the op
registry: one closure over ``imperative_invoke`` per registered op."""
from __future__ import annotations

from .ndarray import NDArray, imperative_invoke
from .ops.registry import OP_REGISTRY, get_op


def _make_ndarray_function(op_name):
    opdef = get_op(op_name)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        # split kwargs into tensor inputs vs attrs
        tensor_kwargs = {k: v for k, v in kwargs.items()
                         if isinstance(v, NDArray)}
        params = {k: v for k, v in kwargs.items()
                  if not isinstance(v, NDArray)}
        inputs = list(args)
        if tensor_kwargs:
            attrs = opdef.normalize_attrs(params)
            names = opdef.input_names(attrs) + opdef.aux_names(attrs)
            by_name = [None] * len(names)
            for i, a in enumerate(inputs):
                by_name[i] = a
            for k, v in tensor_kwargs.items():
                if k not in names:
                    raise TypeError(f"{op_name}: no input named {k!r}")
                by_name[names.index(k)] = v
            inputs = [a for a in by_name if a is not None]
        if callable(opdef._inputs) and "num_args" in opdef.attr_spec \
                and "num_args" not in params:
            params["num_args"] = len(inputs)
        return imperative_invoke(op_name, *inputs, out=out, **params)

    fn.__name__ = op_name
    fn.__doc__ = f"imperative {op_name}"
    return fn


def init_ndarray_module(namespace):
    for op_name in list(OP_REGISTRY):
        if op_name in namespace:
            continue  # keep hand-written factories (zeros, load, ...)
        namespace[op_name] = _make_ndarray_function(op_name)
