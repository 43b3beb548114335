"""Loss heads: ``SoftmaxOutput``, ``MakeLoss``, the regression outputs,
``SVMOutput``, and ``IdentityAttachKLSparseReg``.

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
``multi_output`` (softmax over axis 1 with a label per position) moves
axis 1 last and takes the same two row functions over the rows (N * d...,
C), one label a row, then moves it back.

``MakeLoss`` turns any symbol into a loss head: its forward is the
identity and its backward ``grad_scale`` times ones under its
``normalization``, as the JAX package's ``custom_vjp``; a loss written in
the tensor ops (``mean(-pick(log_softmax(x), label))``) trains through it.

The regression outputs (``LinearRegressionOutput``,
``LogisticRegressionOutput``, ``MAERegressionOutput``) and ``SVMOutput``
are loss heads of the same contract, plain PyTorch on both devices (the
JAX package's are XLA's ``custom_vjp``s: no Pallas kernel);
``IdentityAttachKLSparseReg`` is the identity with a sparsity penalty in
its gradient, no loss head.
"""
from __future__ import annotations

import math

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


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward: ``softmax`` over the rows of data reshaped (N, -1), or with
    ``multi_output`` over the rows of data with axis 1 moved last, (N *
    d..., C). Backward: ``ce_grad`` over the saved probabilities' rows,
    the head gradient ignored, scaled by 1/N for
    ``normalization="batch"``; ``"valid"`` divides afterwards by the count
    of kept rows (at least 1) on the device, as the TPU path does."""

    @staticmethod
    def forward(ctx, data, label, attrs, softmax, ce_grad):
        multi = parse_bool(attrs.get("multi_output", False))
        x = data.movedim(1, -1) if multi else data
        rows = x.reshape(-1, x.shape[-1]) if multi else \
            x.reshape(x.shape[0], -1)
        prob = softmax(rows.contiguous())
        ctx.save_for_backward(prob, label)
        ctx.attrs, ctx.ce_grad, ctx.multi = attrs, ce_grad, multi
        ctx.batch, ctx.shape = data.shape[0], x.shape
        prob = prob.reshape(x.shape)
        return prob.movedim(-1, 1).contiguous() if multi else prob

    @staticmethod
    def backward(ctx, _head_grad):
        prob, label = ctx.saved_tensors
        grad_scale, use_ignore, ignore_label, norm = _head_attrs(ctx.attrs)
        lab = label.reshape(-1)
        scale = grad_scale / (ctx.batch if norm == "batch" else 1.0)
        grad = ctx.ce_grad(prob, lab, scale, use_ignore, ignore_label)
        if norm == "valid":
            valid = (lab != ignore_label).to(torch.float32).sum() \
                if use_ignore else torch.tensor(float(prob.shape[0]),
                                                device=grad.device)
            grad = grad / torch.clamp(valid, min=1.0).to(grad.dtype)
        grad = grad.reshape(ctx.shape)
        if ctx.multi:
            grad = grad.movedim(-1, 1).contiguous()
        return grad, None, None, None, None


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


class _MakeLossFn(torch.autograd.Function):
    """Forward: the identity. Backward: ``grad_scale`` times ones, the head
    gradient ignored, divided by the batch (``normalization="batch"``:
    the first axis) or by every element (``"valid"``; the JAX package
    reads no ``valid_thresh``)."""

    @staticmethod
    def forward(ctx, data, grad_scale, norm):
        ctx.shape, ctx.dtype, ctx.device = data.shape, data.dtype, \
            data.device
        ctx.grad_scale, ctx.norm = grad_scale, norm
        return data.clone()

    @staticmethod
    def backward(ctx, _head_grad):
        grad = torch.full(ctx.shape, ctx.grad_scale, dtype=ctx.dtype,
                          device=ctx.device)
        if ctx.norm == "batch":
            grad = grad / ctx.shape[0]
        elif ctx.norm == "valid":
            grad = grad / float(math.prod(ctx.shape))
        return grad, None, None


register("MakeLoss", inputs=("data",), is_loss=True,
         attr_spec={"grad_scale": (parse_float, 1.0),
                    "valid_thresh": (parse_float, 0.0),
                    "normalization": (None, "null")},
         infer_shape=lambda attrs, s: (s, [s[0]], []),
         simple=lambda attrs, data: _MakeLossFn.apply(
             data, parse_float(attrs.get("grad_scale", 1.0)),
             attrs.get("normalization", "null")))


# --------------------------------------------------------------------------
# Regression outputs: the forward is the identity or the sigmoid, the
# backward ``(out - label)`` (MAE: its sign) times ``grad_scale`` over the
# number of outputs a sample, the head gradient ignored
# --------------------------------------------------------------------------
_REG_TRANSFORMS = {"LinearRegressionOutput": None,
                   "LogisticRegressionOutput": torch.sigmoid,
                   "MAERegressionOutput": None}


class _RegressionFn(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` of a regression head: the gradient
    is ``grad(out, label) * grad_scale / (out.size / N)`` (1 for 1-D
    output) in out's dtype; the label gets none."""

    @staticmethod
    def forward(ctx, data, label, name, grad_scale):
        transform = _REG_TRANSFORMS[name]
        out = data.clone() if transform is None else transform(data)
        ctx.save_for_backward(out, label)
        ctx.mae, ctx.grad_scale = name == "MAERegressionOutput", grad_scale
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        denom = out.numel() // out.shape[0] if out.ndim > 1 else 1
        diff = out - label.reshape(out.shape)
        if ctx.mae:
            # jnp.sign keeps NaN (torch.sign gives 0)
            diff = torch.where(torch.isnan(diff), diff, torch.sign(diff))
        return (diff * ctx.grad_scale / denom).to(out.dtype), None, None, \
            None


def _reg_infer(attrs, in_shapes):
    data_s = in_shapes[0]
    return [data_s, data_s], [data_s], []


for _name in _REG_TRANSFORMS:
    register(_name, inputs=("data", "label"), is_loss=True,
             attr_spec={"grad_scale": (parse_float, 1.0)},
             infer_shape=_reg_infer,
             simple=(lambda attrs, data, label, _n=_name: _RegressionFn.apply(
                 data, label, _n, parse_float(attrs.get("grad_scale", 1.0)))))


# --------------------------------------------------------------------------
# SVMOutput
# --------------------------------------------------------------------------
class _SVMFn(torch.autograd.Function):
    """Forward: the identity on data (N, C). Backward, the head gradient
    ignored: with ``viol = x - x[label] + margin`` off the label's column,
    ``use_linear``: ``[viol > 0]`` there and minus their count at the
    label; squared: ``2 max(viol, 0)`` there and minus their sum twice at
    the label; times ``regularization_coefficient``. A label outside [0,
    C) marks no column."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.hyper = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, _head_grad):
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.hyper
        classes = torch.arange(data.shape[1], device=data.device)
        onehot = (classes[None] == label.to(torch.int32)[:, None]).to(
            data.dtype)
        correct = torch.sum(data * onehot, dim=1, keepdim=True)
        viol = data - correct + margin
        if use_linear:
            mask = (viol > 0).to(data.dtype) * (1 - onehot)
            grad = mask - onehot * torch.sum(mask, dim=1, keepdim=True)
        else:
            maskv = torch.maximum(viol, torch.zeros((), dtype=viol.dtype,
                                                    device=viol.device)) * \
                (1 - onehot)
            grad = 2 * maskv - 2 * onehot * torch.sum(maskv, dim=1,
                                                      keepdim=True)
        return (grad * reg_coef).to(data.dtype), None, None, None, None


register("SVMOutput", inputs=("data", "label"), is_loss=True,
         attr_spec={"margin": (parse_float, 1.0),
                    "regularization_coefficient": (parse_float, 1.0),
                    "use_linear": (parse_bool, False)},
         infer_shape=lambda attrs, s: ([s[0], (s[0][0],) if s[0] else None],
                                       [s[0]], []),
         simple=lambda attrs, data, label: _SVMFn.apply(
             data, label, parse_float(attrs.get("margin", 1.0)),
             parse_float(attrs.get("regularization_coefficient", 1.0)),
             parse_bool(attrs.get("use_linear", False))))


# --------------------------------------------------------------------------
# IdentityAttachKLSparseReg: the JAX package's, which takes the penalty from
# this batch's mean activation and reads no ``momentum`` (MXNet keeps a
# moving average of it; the port copies the JAX package)
# --------------------------------------------------------------------------
@register("IdentityAttachKLSparseReg", inputs=("data",),
          attr_spec={"sparseness_target": (parse_float, 0.1),
                     "penalty": (parse_float, 0.001),
                     "momentum": (parse_float, 0.9)},
          infer_shape=lambda attrs, s: (s, [s[0]], []))
def _identity_kl(attrs, data):
    """The identity forward; the gradient gains the KL-sparsity penalty's,
    ``penalty * sum(KL(target || mean_batch(data)))`` entering as ``kl -
    kl.detach()`` (value 0)."""
    target = parse_float(attrs.get("sparseness_target", 0.1))
    penalty = parse_float(attrs.get("penalty", 0.001))
    rho_hat = torch.mean(data, dim=0, keepdim=True)
    kl = penalty * torch.sum(
        target * torch.log(target / (rho_hat + 1e-12)) +
        (1 - target) * torch.log((1 - target) / (1 - rho_hat + 1e-12)))
    return data + (kl - kl.detach())
