"""Data descriptors: ``DataDesc`` and ``DataBatch``."""
from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["DataDesc", "DataBatch"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """(name, shape) plus dtype/layout attributes."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One batch: data/label lists of NDArrays plus bucketing metadata."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label
