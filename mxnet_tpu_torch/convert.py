"""Carrying weights and training state across from the JAX package.

Both packages build the same symbols, so parameter names are shared: a
``{name: numpy array}`` dict taken from ``mxnet_tpu``
(``{k: v.asnumpy() for k, v in arg_params.items()}``, and the same for
the aux states — BatchNorm's moving mean and variance) becomes the
port's parameter dict as it is. ``nd.load`` of a ``.params`` file written
by ``mxnet_tpu`` gives the same arrays.

Quantized parameters (``ops/quant.py``) cross too: int8 arrays as they
are, and the JAX package's ``float8_e4m3fn`` / ``float8_e5m2`` numpy
arrays (an extension dtype the port does not import) through a uint8
view of their bytes, into torch's fp8 dtypes.

Optimizer states travel as ``{param name: numpy array}`` (SGD's
momentum) or ``{param name: [mean, var]}`` (Adam), the layout of the JAX
package's exported fused states; ``set_optimizer_states`` loads such a
dict into a module's updater and ``optimizer_states_to_numpy`` reads one
back.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import current_context
from .ndarray import NDArray, array

#: numpy extension dtype names of fp8 arrays -> torch dtypes
_FP8_BY_NAME = {"float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}

__all__ = ["params_from_numpy", "set_optimizer_states",
           "optimizer_states_to_numpy"]


def params_from_numpy(arg_params, ctx=None):
    """``{name: np.ndarray}`` -> ``{name: NDArray}`` on ``ctx`` (default:
    the current context). dtypes are kept (float64 narrows to float32).
    Serves arguments and aux states alike."""
    ctx = ctx or current_context()
    return {k: _fp8_array(v, ctx) if _fp8_dtype(v) is not None
            else array(v, ctx=ctx) for k, v in arg_params.items()}


def _fp8_dtype(v):
    return _FP8_BY_NAME.get(getattr(getattr(v, "dtype", None), "name", None))


def _fp8_array(v, ctx):
    """A numpy fp8 array -> NDArray of the same bytes in torch's dtype."""
    a = np.ascontiguousarray(v)
    raw = bytearray(a.view(np.uint8).tobytes())
    t = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
        torch.zeros(0, dtype=torch.uint8)
    return NDArray(t.view(_fp8_dtype(v)).reshape(a.shape), ctx=ctx)


def set_optimizer_states(module, states):
    """Load ``{param name: array | [array, ...]}`` into the updater of a
    module whose optimizer is initialized; each state lands on its
    weight's device."""
    idx = {n: i for i, n in enumerate(module._param_names)}
    weights = module._exec_group.param_arrays
    for name, st in states.items():
        i = idx[name]
        ctx = weights[i].context
        if isinstance(st, (list, tuple)):
            module._updater.states[i] = tuple(
                NDArray(np.asarray(s), ctx=ctx) for s in st)
        else:
            module._updater.states[i] = NDArray(np.asarray(st), ctx=ctx)


def optimizer_states_to_numpy(module):
    """The updater's states as ``{param name: array | [array, ...]}``."""
    out = {}
    for i, st in module._updater.states.items():
        name = module._param_names[i]
        if isinstance(st, (list, tuple)):
            out[name] = [s.asnumpy() for s in st]
        elif st is not None:
            out[name] = st.asnumpy()
    return out
