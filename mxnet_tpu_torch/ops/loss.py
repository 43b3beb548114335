"""Loss heads: ``SoftmaxOutput``.

A loss head is at once a predict head (its forward output is the class
probabilities) and a loss head: its backward IGNORES the incoming head
gradient and emits the cross-entropy gradient ``(p - onehot(label)) *
keep * grad_scale`` directly, as the JAX package's ``custom_vjp`` does
(``mxnet_tpu/ops/loss.py``). Here that contract is a
``torch.autograd.Function`` whose forward and backward are two row
functions: on the CPU the plain versions below, on the card the CUDA
kernels ``cuda_kernels.softmax`` / ``cuda_kernels.softmax_ce_bwd`` (the
op's ``"cuda"`` variant, attached in ``cuda_kernels.py``).

Data of more than two dimensions without ``multi_output`` is softmaxed
over all but the batch axis, reshaped to (N, -1) as the composition does.
``multi_output`` (softmax over axis 1 with a label per position) is the
plain composition only; its CUDA variant raises until a kernel takes it.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, parse_bool, parse_float
from .registry import register, alias

__all__ = ["softmax_rows", "softmax_ce_grad", "softmax_output"]


def softmax_rows(x2):
    """Row softmax of x2 (N, C) in float32, as the TPU kernel computes
    it: ``e = exp(x - max)``, ``e / sum(e)``."""
    x = x2.to(torch.float32)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x2.dtype)


def softmax_ce_grad(prob2, label, scale, use_ignore=False,
                    ignore_label=-1.0):
    """``(p - onehot(int(label))) * keep * scale`` over prob2 (N, C) with
    label (N,): a label outside [0, C) matches no column, and under
    ``use_ignore`` a row whose label equals ``ignore_label`` is zero."""
    p = prob2.to(torch.float32)
    lab = label.to(torch.float32)
    classes = torch.arange(p.shape[1], device=p.device, dtype=torch.int32)
    onehot = (classes[None, :] == lab.to(torch.int32)[:, None]).to(p.dtype)
    g = p - onehot
    if use_ignore:
        g = g * (lab != ignore_label).to(p.dtype)[:, None]
    return (g * scale).to(prob2.dtype)


def _head_attrs(attrs):
    return (parse_float(attrs.get("grad_scale", 1.0)),
            parse_bool(attrs.get("use_ignore", False)),
            parse_float(attrs.get("ignore_label", -1.0)),
            attrs.get("normalization", "null"))


def _multi_output_grad(prob, label, attrs):
    """The composition's gradient for ``multi_output``: data (N, C, ...)
    and label (N, ...)."""
    grad_scale, use_ignore, ignore_label, norm = _head_attrs(attrs)
    lab = label.to(torch.float32)
    classes = torch.arange(prob.shape[1], device=prob.device)
    classes = classes.reshape((1, -1) + (1,) * (prob.ndim - 2))
    onehot = (classes == lab.to(torch.int64).unsqueeze(1)).to(prob.dtype)
    mask = (lab != ignore_label).to(prob.dtype) if use_ignore \
        else torch.ones_like(lab, dtype=prob.dtype)
    grad = (prob - onehot) * mask.unsqueeze(1)
    if norm == "batch":
        grad = grad / prob.shape[0]
    elif norm == "valid":
        grad = grad / torch.clamp(mask.sum(), min=1.0)
    return grad * grad_scale


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward: ``softmax`` over the rows of data reshaped (N, -1).
    Backward: ``ce_grad`` over the saved probabilities, the head
    gradient ignored; ``normalization="valid"`` divides afterwards by the
    count of kept rows (at least 1), as the TPU path does."""

    @staticmethod
    def forward(ctx, data, label, attrs, softmax, ce_grad):
        multi = parse_bool(attrs.get("multi_output", False))
        if multi:
            prob = torch.softmax(data.to(torch.float32), dim=1).to(
                data.dtype)
        else:
            prob = softmax(data.reshape(data.shape[0], -1).contiguous()
                           ).reshape(data.shape)
        ctx.save_for_backward(prob, label)
        ctx.attrs, ctx.ce_grad, ctx.multi = attrs, ce_grad, multi
        return prob

    @staticmethod
    def backward(ctx, _head_grad):
        prob, label = ctx.saved_tensors
        if ctx.multi:
            return _multi_output_grad(prob, label, ctx.attrs), None, None, \
                None, None
        grad_scale, use_ignore, ignore_label, norm = _head_attrs(ctx.attrs)
        n = prob.shape[0]
        lab = label.reshape(-1)
        scale = grad_scale / (n if norm == "batch" else 1.0)
        grad = ctx.ce_grad(prob.reshape(n, -1), lab, scale, use_ignore,
                           ignore_label)
        if norm == "valid":
            valid = (lab != ignore_label).to(torch.float32).sum() \
                if use_ignore else torch.tensor(float(n), device=grad.device)
            grad = grad / torch.clamp(valid, min=1.0).to(grad.dtype)
        return grad.reshape(prob.shape), None, None, None, None


def softmax_output(data, label, attrs, softmax=softmax_rows,
                   ce_grad=softmax_ce_grad):
    """The SoftmaxOutput contract over ``data`` (N, ...) and ``label``,
    with the row functions given (plain versions by default)."""
    if data.ndim < 2:
        raise MXNetError(f"SoftmaxOutput: data must be (N, ...), got "
                         f"{tuple(data.shape)}")
    return _SoftmaxOutputFn.apply(data, label, attrs, softmax, ce_grad)


_SOFTMAX_ATTRS = {
    "grad_scale": (parse_float, 1.0), "ignore_label": (parse_float, -1.0),
    "multi_output": (parse_bool, False), "use_ignore": (parse_bool, False),
    "preserve_shape": (parse_bool, False), "normalization": (None, "null"),
    "out_grad": (parse_bool, False),
}


def _softmax_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    label_s = in_shapes[1] if len(in_shapes) > 1 else None
    if data_s is not None:
        if parse_bool(attrs.get("multi_output", False)):
            label_s = (data_s[0],) + tuple(data_s[2:])
        else:
            label_s = (data_s[0],)
    return [data_s, label_s], [data_s], []


register("SoftmaxOutput", inputs=("data", "label"), is_loss=True,
         attr_spec=dict(_SOFTMAX_ATTRS), infer_shape=_softmax_infer,
         simple=lambda attrs, data, label: softmax_output(data, label,
                                                          attrs))
alias("Softmax", "SoftmaxOutput")
