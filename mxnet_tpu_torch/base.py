"""Base utilities: the framework error and the attribute codecs.

The port's own copy of ``mxnet_tpu.base`` (it imports nothing of the JAX
package): the shared error type plus the string<->typed-attr codecs that
Symbol JSON serialization uses, so a graph written by either package
reads back in the other.
"""
from __future__ import annotations

import ast

import numpy as _np

__all__ = ["MXNetError"]


class MXNetError(Exception):
    """Framework-level error."""


def attr_to_str(value):
    """Serialize a typed attr value to the string form used in symbol JSON:
    tuples as ``(2, 2)``, bools as ``True``/``False``, numbers via repr."""
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return str(value)
    if isinstance(value, (tuple, list)):
        return "(" + ", ".join(attr_to_str(v) for v in value) + ")"
    if value is None:
        return "None"
    if isinstance(value, _np.dtype):
        return _np.dtype(value).name
    if isinstance(value, type):  # e.g. np.float32 class
        return _np.dtype(value).name
    return repr(value)


def str_to_attr(s):
    """Parse a string attr back into a typed python value (best effort)."""
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def merge_shape(a, b):
    """Merge two partial shapes (None = unknown, 0 = unknown dim): dims
    merge pointwise, 0 yields to a known dim, conflicting dims raise."""
    if a is None:
        return tuple(b) if b is not None else None
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        raise MXNetError(f"incompatible shapes {a} vs {b}")
    out = []
    for x, y in zip(a, b):
        if x == 0:
            out.append(y)
        elif y == 0 or x == y:
            out.append(x)
        else:
            raise MXNetError(f"incompatible shapes {a} vs {b}")
    return tuple(out)


def shape_is_known(s):
    return s is not None and 0 not in s


def parse_tuple(val, length=None, name="param"):
    """Coerce ints / strings / sequences into an int tuple."""
    if val is None:
        return None
    if isinstance(val, str):
        val = str_to_attr(val)
    if isinstance(val, (int, _np.integer)):
        val = (int(val),) * (length or 1)
    val = tuple(int(v) for v in val)
    if length is not None and len(val) != length:
        raise ValueError(f"{name} expected length-{length} tuple, got {val}")
    return val


def parse_bool(val):
    if isinstance(val, str):
        return val.lower() in ("true", "1")
    return bool(val)


def parse_int(val):
    return int(val)


def parse_float(val):
    return float(val)
