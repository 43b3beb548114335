"""Optimizer update ops: ``sgd_update``, ``sgd_mom_update``, ``adam_update``.

The reference registers weight updates as graph ops so a whole update is
one fused kernel, and the Python optimizers call them imperatively. Each
op declares ``mutate_inputs``: output k is the new value of input
``mutate_inputs[k]``, which ``imperative_invoke`` writes into that
input's handle. The plain forwards below (what CPU tensors run) return
new tensors; ``sgd_mom_update`` and ``adam_update`` carry CUDA kernels as
their ``"cuda"`` variants (``cuda_kernels.py``), which update the weight
and state tensors in place. ``sgd_update`` has no TPU kernel and stays
plain on both devices.

``clip_gradient`` <= 0 (the default -1) means no clip. ``sgd_mom_step``
and ``adam_step`` are also the kernels' plain versions: they round as the
TPU kernels do (``(1 - b2) * g * g`` left to right).
"""
from __future__ import annotations

import torch

from ..base import parse_float
from .registry import register

__all__ = ["sgd_mom_step", "adam_step"]

_COMMON = {
    "lr": (parse_float, None), "wd": (parse_float, 0.0),
    "rescale_grad": (parse_float, 1.0), "clip_gradient": (parse_float, -1.0),
}


def _prep_grad(grad, weight, wd, rescale, clip):
    g = grad * rescale
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g + wd * weight


def sgd_mom_step(weight, grad, mom, lr, momentum=0.0, wd=0.0, rescale=1.0,
                 clip=-1.0):
    """``m = momentum * m - lr * (clip(rescale * g) + wd * w)``,
    ``w = w + m``; returns new (w, m)."""
    g = _prep_grad(grad, weight, wd, rescale, clip)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def adam_step(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
              epsilon=1e-8, wd=0.0, rescale=1.0, clip=-1.0):
    """Adam moments and weight, epsilon outside the square root; returns
    new (w, mean, var). The bias correction is folded into ``lr`` by the
    optimizer."""
    g = _prep_grad(grad, weight, wd, rescale, clip)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * g * g
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


def _hyper(attrs):
    return dict(lr=attrs["lr"], wd=attrs.get("wd", 0.0),
                rescale=attrs.get("rescale_grad", 1.0),
                clip=attrs.get("clip_gradient", -1.0))


@register("sgd_update", inputs=("weight", "grad"), attr_spec=dict(_COMMON),
          mutate_inputs=("weight",))
def _sgd_update(attrs, weight, grad):
    h = _hyper(attrs)
    return weight - h["lr"] * _prep_grad(grad, weight, h["wd"],
                                         h["rescale"], h["clip"])


@register("sgd_mom_update", inputs=("weight", "grad", "mom"),
          attr_spec={**_COMMON, "momentum": (parse_float, 0.0)},
          mutate_inputs=("weight", "mom"), num_outputs=2,
          output_names=["weight", "mom"])
def _sgd_mom_update(attrs, weight, grad, mom):
    return sgd_mom_step(weight, grad, mom,
                        momentum=attrs.get("momentum", 0.0), **_hyper(attrs))


@register("adam_update", inputs=("weight", "grad", "mean", "var"),
          attr_spec={**_COMMON, "beta1": (parse_float, 0.9),
                     "beta2": (parse_float, 0.999),
                     "epsilon": (parse_float, 1e-8)},
          mutate_inputs=("weight", "mean", "var"), num_outputs=3,
          output_names=["weight", "mean", "var"])
def _adam_update(attrs, weight, grad, mean, var):
    return adam_step(weight, grad, mean, var,
                     beta1=attrs.get("beta1", 0.9),
                     beta2=attrs.get("beta2", 0.999),
                     epsilon=attrs.get("epsilon", 1e-8), **_hyper(attrs))
