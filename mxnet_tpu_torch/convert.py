"""Carrying weights across from the JAX package.

Both packages build the same symbols, so parameter names are shared: a
``{name: numpy array}`` dict taken from ``mxnet_tpu``
(``{k: v.asnumpy() for k, v in arg_params.items()}``) becomes the port's
parameter dict as it is. ``nd.load`` of a ``.params`` file written by
``mxnet_tpu`` gives the same arrays.
"""
from __future__ import annotations

from .context import current_context
from .ndarray import array

__all__ = ["params_from_numpy"]


def params_from_numpy(arg_params, ctx=None):
    """``{name: np.ndarray}`` -> ``{name: NDArray}`` on ``ctx`` (default:
    the current context). dtypes are kept (float64 narrows to float32)."""
    ctx = ctx or current_context()
    return {k: array(v, ctx=ctx) for k, v in arg_params.items()}
