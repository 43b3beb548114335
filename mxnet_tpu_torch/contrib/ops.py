"""The contrib operators: ``quantize`` / ``dequantize``, ``fft`` / ``ifft``,
``count_sketch``, the CTC loss, the SSD MultiBox trio (``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``) and ``MultiProposal``, the
port of ``mxnet_tpu/contrib/ops.py`` (same names, aliases, attributes and
outputs).

None of them has a Pallas kernel behind it: the JAX package leaves them to
XLA, and the port writes them in plain PyTorch, the same code on the CPU
and the card. ``fft`` / ``ifft`` are ``torch.fft`` (cuFFT on the card).
Every op takes the whole batch at once where the JAX package ``vmap``s
over it, and keeps its tensors on their device: no ``.item()``, no host
loop over images.

What the port copies from the JAX package on purpose, byte for byte
where it can:

* ``MultiBoxPrior``'s widths and heights come from ``np.sqrt`` in float64
  cast to float32, its centres from float32 arithmetic; the RPN base
  anchors of ``MultiProposal`` are float64 numpy with ``np.round``, cast
  once.
* Sorts are stable (``jnp.argsort``) and ``lax.top_k`` puts the lower
  index first among ties: ``torch.sort(..., stable=True)`` everywhere,
  never ``torch.topk`` or an unstable ``argsort``. ``argmax`` takes the
  first maximum (``_first_argmax``), as ``jnp.argmax`` does.
* ``MultiBoxTarget``'s forced match is the JAX package's
  ``forced.at[best_anchor].set(valid)`` on the CPU, where the last write
  wins: for each anchor the last label row that picked it decides, so a
  padding row (cls -1, whose IoU column is all 0 and picks anchor 0)
  clears the forced match of a valid box whose best anchor is 0. The
  port computes that rule without a scatter, so it is deterministic on
  the card (``index_put_`` with repeated indices is not).
* Greedy NMS is a loop over the sorted anchors of device ops on the whole
  batch's (N, A) masks. Anchors below ``threshold`` still suppress others
  (``keep`` is applied after NMS; MXNet drops them first), and
  ``nms_topk`` is parsed and never read.
* CTC's log-space alpha recursion uses -1e10, not -inf, as its sentinel,
  and ``jax.numpy.logaddexp``'s formula and derivative (``_LogAddExp``);
  ``blank_label`` is parsed and ignored (blank is 0); without
  ``use_label_lengths`` a label of 0 is padding, and with it alone the
  label lengths are read as data lengths (the inputs bind by position).
  Its gradient is the vector-Jacobian product of the loss with the head
  gradient, as the JAX package's ``custom_vjp`` computes it.
* The MultiBox ops and ``MultiProposal`` run detached: their outputs
  carry no gradient. ``MultiBoxTarget`` only ranks by ``cls_pred``, so
  the JAX package's gradient into it is zero too; its outputs do depend
  on ``anchor`` and ``label`` in the JAX package, whose gradients no
  graph of the repo reads (``MultiBoxPrior``'s anchors depend on the
  data's shape alone).
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from ..base import parse_bool, parse_float, parse_int
from ..ops import cost as _cost
from ..ops.registry import alias, register

__all__ = ["ctc_loss_batch"]


def _torch_dtype(name):
    """The torch dtype of a numpy dtype name (``"uint8"`` ->
    ``torch.uint8``)."""
    return getattr(torch, np.dtype(name).name)


def _numpy_dtype(t):
    return np.dtype(str(t.dtype).replace("torch.", ""))


# --------------------------------------------------------------------------
# quantize / dequantize
# --------------------------------------------------------------------------
@register("_contrib_quantize", inputs=("data", "min_range", "max_range"),
          attr_spec={"out_type": (None, "uint8")}, num_outputs=3,
          output_names=["output", "min_output", "max_output"],
          infer_shape=lambda attrs, s: (s, [s[0], s[1], s[2]], []))
def _quantize(attrs, data, min_range, max_range):
    """``clip(round((data - min) * scale) + lo, lo, hi)`` in the integer
    type, ``scale = (hi - lo) / (max - min)`` in float32, half to even."""
    out_type = attrs.get("out_type", "uint8")
    info = np.iinfo(np.dtype(out_type))
    # one float32 division (``int / tensor`` would take the reciprocal
    # and multiply: two roundings)
    span = torch.tensor(float(info.max - info.min), dtype=torch.float32,
                        device=data.device)
    scale = span / (max_range - min_range)
    q = torch.clamp(torch.round((data - min_range) * scale) + info.min,
                    info.min, info.max).to(_torch_dtype(out_type))
    return q, min_range.clone(), max_range.clone()


alias("quantize", "_contrib_quantize")


@register("_contrib_dequantize", inputs=("data", "min_range", "max_range"),
          attr_spec={"out_type": (None, "float32")}, num_outputs=1,
          infer_shape=lambda attrs, s: (s, [s[0]], []))
def _dequantize(attrs, data, min_range, max_range):
    """``(data - lo) * (max - min) / (hi - lo) + min`` from the integer
    data's range."""
    info = np.iinfo(_numpy_dtype(data))
    scale = (max_range - min_range) / (info.max - info.min)
    return ((data.to(torch.float32) - info.min) * scale + min_range).to(
        _torch_dtype(attrs.get("out_type", "float32")))


alias("dequantize", "_contrib_dequantize")


# --------------------------------------------------------------------------
# fft / ifft: real and imaginary parts interleaved along the last axis;
# compute_size is parsed and ignored
# --------------------------------------------------------------------------
def _fft_infer(attrs, s):
    return s, [tuple(s[0][:-1]) + (2 * s[0][-1],)], []


@register("_contrib_fft", inputs=("data",),
          attr_spec={"compute_size": (parse_int, 128)},
          infer_shape=_fft_infer)
def _fft(attrs, data):
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    ri = torch.view_as_real(out)
    return ri.reshape(data.shape[:-1] + (2 * data.shape[-1],)).to(
        torch.float32)


alias("fft", "_contrib_fft")


def _ifft_infer(attrs, s):
    return s, [tuple(s[0][:-1]) + (s[0][-1] // 2,)], []


@register("_contrib_ifft", inputs=("data",),
          attr_spec={"compute_size": (parse_int, 128)},
          infer_shape=_ifft_infer)
def _ifft(attrs, data):
    """The inverse transform scaled by n (the reference's convention)."""
    n = data.shape[-1] // 2
    ri = data.reshape(data.shape[:-1] + (n, 2))
    cplx = torch.complex(ri[..., 0], ri[..., 1])
    out = torch.fft.ifft(cplx, dim=-1) * n
    return out.real.to(torch.float32)


alias("ifft", "_contrib_ifft")


# --------------------------------------------------------------------------
# count_sketch
# --------------------------------------------------------------------------
def _cs_infer(attrs, s):
    n = s[0][0] if s[0] is not None else None
    return s, [(n, parse_int(attrs["out_dim"])) if n is not None else None], []


@register("_contrib_count_sketch", inputs=("data", "h", "s"),
          attr_spec={"out_dim": (parse_int, None),
                     "processing_batch_size": (parse_int, 32)},
          infer_shape=_cs_infer)
def _count_sketch(attrs, data, h, s):
    """out[:, h[j] mod out_dim] += s[j] * data[:, j]: the hash truncated to
    int32 and taken modulo ``out_dim`` with the divisor's sign (a floor
    modulo, as ``jnp``'s ``%``)."""
    out_dim = attrs["out_dim"]
    hh = torch.remainder(h.reshape(-1).to(torch.int32), out_dim).long()
    signed = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, signed)


alias("count_sketch", "_contrib_count_sketch")


# --------------------------------------------------------------------------
# CTC loss: the log-space alpha recursion over time, the whole batch a step
# --------------------------------------------------------------------------
_CTC_NEG = -1e10


def _replace_inf(x):
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


class _LogAddExp(torch.autograd.Function):
    """``jax.numpy.logaddexp``: ``max + log1p(exp(-|x1 - x2|))`` (``x1 +
    x2`` where the difference is NaN), and its derivative ``exp(x - out)``
    with +inf read as 0, where PyTorch's ``logaddexp`` differentiates as
    ``1 / (1 + exp(other - self))``: the two part where both inputs sit
    at the -1e10 sentinel."""

    @staticmethod
    def forward(ctx, x1, x2):
        delta = x1 - x2
        out = torch.where(torch.isnan(delta), x1 + x2,
                          torch.maximum(x1, x2) +
                          torch.log1p(torch.exp(-torch.abs(delta))))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        o = _replace_inf(out)
        return (g * torch.exp(_replace_inf(x1) - o),
                g * torch.exp(_replace_inf(x2) - o))


def _index(i, n):
    """``jnp`` indexing of an axis of n by the traced index i: negative
    counted from the end, then clamped into [0, n)."""
    i = torch.where(i < 0, i + n, i)
    return torch.clamp(i, 0, n - 1)


def _shifted(x, k, fill):
    """x (N, S) moved k places right along S, ``fill`` in front."""
    S = x.shape[1]
    k = min(k, S)
    return torch.cat([fill[:, :k], x[:, :S - k]], dim=1)


def ctc_loss_batch(data, label, data_lengths, label_lengths):
    """-log p(label | data) of each sequence: data (T, N, C) activations,
    label (N, L) int64 class ids (0 is blank), lengths (N,) int64 -> (N,).
    The JAX package's ``_ctc_forward`` for the whole batch at once: the
    extended label ``[blank, l1, blank, l2, ..., blank]`` (S = 2 L + 1),
    alpha over S per sequence, one batched step a time step, all T steps
    run and the one at ``data_lengths - 1`` read."""
    T, N, _ = data.shape
    L = label.shape[1]
    S = 2 * L + 1
    log_probs = torch.log_softmax(data, dim=-1)
    dev = data.device
    ext = torch.zeros((N, S), dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    can_skip = torch.zeros((N, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != 0) & (ext[:, 2:] != ext[:, :-2])
    neg = torch.full((N, S), _CTC_NEG, dtype=log_probs.dtype, device=dev)
    first = [log_probs[0, :, :1]]
    if S > 1:
        first.append(log_probs[0].gather(1, ext[:, 1:2]))
        first.append(neg[:, 2:])
    alpha = torch.cat(first, dim=1)
    alphas = [alpha]
    for t in range(1, T):
        prev1 = _shifted(alpha, 1, neg)
        prev2 = torch.where(can_skip, _shifted(alpha, 2, neg), neg)
        merged = _LogAddExp.apply(_LogAddExp.apply(alpha, prev1), prev2)
        alpha = merged + log_probs[t].gather(1, ext)
        alphas.append(alpha)
    all_alphas = torch.stack(alphas)                          # (T, N, S)
    rows = torch.arange(N, device=dev)
    final = all_alphas[_index(data_lengths - 1, T), rows]     # (N, S)
    s_last = 2 * label_lengths
    last = final.gather(1, _index(s_last, S)[:, None])[:, 0]
    before = final.gather(1, _index(s_last - 1, S)[:, None])[:, 0]
    ll = _LogAddExp.apply(last, torch.where(label_lengths > 0, before,
                                            torch.full_like(before,
                                                            _CTC_NEG)))
    return -ll


def _ctc_inputs(attrs):
    names = ["data", "label"]
    if parse_bool(attrs.get("use_data_lengths", False)):
        names.append("data_lengths")
    if parse_bool(attrs.get("use_label_lengths", False)):
        names.append("label_lengths")
    return names


def _ctc_infer(attrs, s):
    n = s[0][1] if s[0] is not None else None
    return s, [(n,) if n is not None else None], []


@register("_contrib_ctc_loss", inputs=_ctc_inputs, is_loss=True,
          attr_spec={"use_data_lengths": (parse_bool, False),
                     "use_label_lengths": (parse_bool, False),
                     "blank_label": (None, "first")},
          infer_shape=_ctc_infer)
def _ctc_loss(attrs, data, label, data_lengths=None, label_lengths=None):
    """The inputs bind by position, as in the JAX package: with
    ``use_label_lengths`` alone the label lengths arrive as
    ``data_lengths`` (a fault of the reference, copied and pinned), and
    the label lengths are then the count of non-zero labels."""
    T, N, _ = data.shape
    dlen, llen = data_lengths, label_lengths
    if dlen is None:
        dlen = torch.full((N,), T, dtype=torch.int32, device=data.device)
    if llen is None:
        # 0-padded labels: the length is the count of non-zero entries
        llen = torch.sum((label != 0).to(torch.int32), dim=-1)
    return ctc_loss_batch(data, label.to(torch.int32).long(),
                          dlen.to(torch.int32).long(),
                          llen.to(torch.int32).long())


alias("ctc_loss", "_contrib_ctc_loss")
alias("CTCLoss", "_contrib_ctc_loss")


# --------------------------------------------------------------------------
# the SSD MultiBox trio
# --------------------------------------------------------------------------
def _parse_floats(val, default):
    if val is None:
        return default
    if isinstance(val, str):
        val = ast.literal_eval(val)
    if isinstance(val, (int, float)):
        return (float(val),)
    return tuple(float(v) for v in val)


def _first_argmax(x, dim):
    """(max, index of its first occurrence) along ``dim``, as
    ``jnp.max`` / ``jnp.argmax`` give them, on every device."""
    top = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    hit = (x == top) | (torch.isnan(x) & torch.isnan(top))
    idx = torch.where(hit, pos, n).amin(dim=dim)
    return top.squeeze(dim), idx


def _prior_count(attrs):
    return len(attrs.get("sizes", (1.0,))) + \
        len(attrs.get("ratios", (1.0,))) - 1


@register("MultiBoxPrior", inputs=("data",),
          attr_spec={"sizes": (lambda v: _parse_floats(v, (1.0,)), (1.0,)),
                     "ratios": (lambda v: _parse_floats(v, (1.0,)), (1.0,)),
                     "clip": (parse_bool, False),
                     "steps": (lambda v: _parse_floats(v, (-1.0, -1.0)),
                               (-1.0, -1.0)),
                     "offsets": (lambda v: _parse_floats(v, (0.5, 0.5)),
                                 (0.5, 0.5))},
          infer_shape=lambda attrs, s: (s, [
              (1, s[0][2] * s[0][3] * _prior_count(attrs), 4)
              if s[0] is not None else None], []))
def _multibox_prior(attrs, data):
    """Anchors (1, h w A, 4) in corner form over the (h, w) feature map:
    per pixel the sizes at the first ratio, then the other ratios at the
    first size, centred at ``(i + offset) * step``."""
    h, w = data.shape[2], data.shape[3]
    sizes = attrs.get("sizes", (1.0,))
    ratios = attrs.get("ratios", (1.0,))
    steps = attrs.get("steps", (-1.0, -1.0))
    offsets = attrs.get("offsets", (0.5, 0.5))
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w

    def f32(v):
        return torch.tensor(np.float32(v), device=data.device)

    cy = (torch.arange(h, dtype=torch.float32, device=data.device) +
          f32(offsets[0])) * f32(step_y)
    cx = (torch.arange(w, dtype=torch.float32, device=data.device) +
          f32(offsets[1])) * f32(step_x)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxg.reshape(-1), cyg.reshape(-1)], dim=-1)
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    half = torch.from_numpy(np.asarray(whs, np.float32)).to(
        data.device)[None] / 2.0
    cxy = centers[:, None, :]
    boxes = torch.cat([cxy - half, cxy + half], dim=-1).reshape(1, -1, 4)
    if parse_bool(attrs.get("clip", False)):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


alias("_contrib_MultiBoxPrior", "MultiBoxPrior")


def _iou(a, b):
    """IoU of corner boxes a (..., A, 4) against b (..., G, 4) ->
    (..., A, G); 0 where the union is not positive."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    a_area = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    b_area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = a_area[..., :, None] + b_area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _centre_form(anchors):
    return ((anchors[:, 0] + anchors[:, 2]) / 2,
            (anchors[:, 1] + anchors[:, 3]) / 2,
            anchors[:, 2] - anchors[:, 0], anchors[:, 3] - anchors[:, 1])


def forced_matches(best_anchor, valid, n_anchors):
    """``zeros(A).at[best_anchor].set(valid)`` per image as XLA runs it on
    the CPU, the last write winning, without a scatter: best_anchor,
    valid (N, G) -> (N, A) bool."""
    G = best_anchor.shape[1]
    hit = best_anchor[:, :, None] == torch.arange(
        n_anchors, device=best_anchor.device)[None, None, :]
    rows = torch.arange(G, device=best_anchor.device)[None, :, None]
    last = torch.where(hit, rows, -1).amax(dim=1)             # (N, A)
    return (last >= 0) & valid.gather(1, last.clamp(min=0))


def _target_infer(attrs, s):
    if s[0] is None or s[1] is None:
        return s, [None, None, None], []
    n, a = s[1][0], int(np.prod(s[0])) // 4
    return s, [(n, 4 * a), (n, 4 * a), (n, a)], []


@register("MultiBoxTarget", inputs=("anchor", "label", "cls_pred"),
          attr_spec={"overlap_threshold": (parse_float, 0.5),
                     "ignore_label": (parse_float, -1.0),
                     "negative_mining_ratio": (parse_float, -1.0),
                     "negative_mining_thresh": (parse_float, 0.5),
                     "minimum_negative_samples": (parse_int, 0),
                     "variances": (lambda v: _parse_floats(
                         v, (0.1, 0.1, 0.2, 0.2)), (0.1, 0.1, 0.2, 0.2))},
          num_outputs=3,
          output_names=["loc_target", "loc_mask", "cls_target"],
          infer_shape=_target_infer)
def _multibox_target(attrs, anchor, label, cls_pred):
    """Anchor matching and target encoding for the whole batch: label (N,
    G, 5+) rows [cls, x1, y1, x2, y2] (cls -1 pads), cls_pred (N, C + 1,
    A) -> loc_target (N, 4 A), loc_mask (N, 4 A), cls_target (N, A)."""
    with torch.no_grad():
        return _multibox_target_batch(attrs, anchor, label, cls_pred)


def _multibox_target_batch(attrs, anchor, label, cls_pred):
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    thresh = attrs.get("overlap_threshold", 0.5)
    v = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    neg_ratio = parse_float(attrs.get("negative_mining_ratio", -1.0))
    ignore_label = parse_float(attrs.get("ignore_label", -1.0))
    min_neg = parse_int(attrs.get("minimum_negative_samples", 0))
    acx, acy, aw, ah = _centre_form(anchors)

    valid = label[..., 0] >= 0                                # (N, G)
    gt = label[..., 1:5]
    ious = _iou(anchors[None], gt) * valid[:, None, :].to(anchors.dtype)
    best_iou, best_gt = _first_argmax(ious, 2)                # (N, A)
    _, best_anchor = _first_argmax(ious, 1)                   # (N, G)
    pos = (best_iou >= thresh) | forced_matches(best_anchor, valid, A)
    matched = gt.gather(1, best_gt[..., None].expand(-1, -1, 4))
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    gw = torch.clamp(matched[..., 2] - matched[..., 0], min=1e-8)
    gh = torch.clamp(matched[..., 3] - matched[..., 1], min=1e-8)
    aw8, ah8 = torch.clamp(aw, min=1e-8), torch.clamp(ah, min=1e-8)
    tx = (gcx - acx) / aw8 / v[0]
    ty = (gcy - acy) / ah8 / v[1]
    tw = torch.log(gw / aw8) / v[2]
    th = torch.log(gh / ah8) / v[3]
    posf = pos.to(anchors.dtype)
    loc_t = torch.stack([tx, ty, tw, th], dim=-1) * posf[..., None]
    loc_m = posf[..., None].expand(-1, -1, 4)
    matched_cls = label[..., 0].gather(1, best_gt) + 1.0
    if neg_ratio > 0:
        # hard-negative mining: the candidates (no positive, best IoU
        # under negative_mining_thresh) ranked by -log p(background),
        # hardest first, ties by index; the first ratio * |pos| of them
        # are negatives, the other anchors take ignore_label
        neg_thresh = parse_float(attrs.get("negative_mining_thresh", 0.5))
        neg_cand = (~pos) & (best_iou < neg_thresh)
        p = torch.softmax(cls_pred, dim=1)
        hardness = torch.where(neg_cand, -torch.log(p[:, 0] + 1e-12),
                               torch.full_like(best_iou, float("-inf")))
        order = torch.sort(-hardness, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=order.device).expand_as(order))
        n_neg = torch.clamp((neg_ratio * pos.sum(dim=1)).to(torch.int32),
                            min=min_neg)
        neg_sel = neg_cand & (rank < n_neg[:, None])
        cls_t = torch.where(pos, matched_cls, torch.where(
            neg_sel, torch.zeros_like(matched_cls),
            torch.full_like(matched_cls, ignore_label)))
    else:
        cls_t = torch.where(pos, matched_cls, torch.zeros_like(matched_cls))
    N = label.shape[0]
    return (loc_t.reshape(N, -1), loc_m.reshape(N, -1).contiguous(), cls_t)


alias("_contrib_MultiBoxTarget", "MultiBoxTarget")


def greedy_nms(supp):
    """Greedy suppression over sorted boxes: supp (N, K, K) bool, row i
    the boxes box i suppresses (only later ones) -> alive (N, K). The
    JAX package's ``fori_loop`` over i, every box in order, the batch
    at once: two device ops a box."""
    N, K = supp.shape[0], supp.shape[1]
    alive = torch.ones((N, K), dtype=torch.bool, device=supp.device)
    for i in range(K):
        alive.masked_fill_(supp[:, i] & alive[:, i:i + 1], False)
    return alive


def _detection_infer(attrs, s):
    if s[0] is None or s[2] is None:
        return s, [None], []
    return s, [(s[0][0], int(np.prod(s[2])) // 4, 6)], []


@register("MultiBoxDetection", inputs=("cls_prob", "loc_pred", "anchor"),
          attr_spec={"clip": (parse_bool, True),
                     "threshold": (parse_float, 0.01),
                     "background_id": (parse_int, 0),
                     "nms_threshold": (parse_float, 0.5),
                     "force_suppress": (parse_bool, False),
                     "variances": (lambda v: _parse_floats(
                         v, (0.1, 0.1, 0.2, 0.2)), (0.1, 0.1, 0.2, 0.2)),
                     "nms_topk": (parse_int, -1)},
          infer_shape=_detection_infer)
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode and per-class NMS: cls_prob (N, C, A), loc_pred (N, 4 A) ->
    (N, A, 6) rows [cls_id, score, x1, y1, x2, y2] in descending score
    order (ties by anchor), cls_id -1 where pruned."""
    with torch.no_grad():
        return _multibox_detection_batch(attrs, cls_prob, loc_pred, anchor)


def _multibox_detection_batch(attrs, cls_prob, loc_pred, anchor):
    v = attrs.get("variances", (0.1, 0.1, 0.2, 0.2))
    threshold = attrs.get("threshold", 0.01)
    nms_t = attrs.get("nms_threshold", 0.5)
    bg = attrs.get("background_id", 0)
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N = cls_prob.shape[0]
    acx, acy, aw, ah = _centre_form(anchors)
    lp = loc_pred.reshape(N, -1, 4)
    cx = lp[..., 0] * v[0] * aw + acx
    cy = lp[..., 1] * v[1] * ah + acy
    w = torch.exp(lp[..., 2] * v[2]) * aw / 2
    h = torch.exp(lp[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if parse_bool(attrs.get("clip", True)):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    classes = torch.arange(cls_prob.shape[1], device=cls_prob.device)
    scores_nb = torch.where((classes != bg)[None, :, None], cls_prob,
                            torch.full_like(cls_prob, -1.0))
    score, cls_id = _first_argmax(scores_nb, 1)               # (N, A)
    keep = score > threshold
    order = torch.sort(-score, dim=1, stable=True).indices
    boxes_o = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    cls_o = cls_id.gather(1, order)
    supp = (_iou(boxes_o, boxes_o) > nms_t) & torch.ones(
        (A, A), dtype=torch.bool, device=order.device).triu(1)
    if not parse_bool(attrs.get("force_suppress", False)):
        supp &= cls_o[:, :, None] == cls_o[:, None, :]
    kept = keep.gather(1, order) & greedy_nms(supp)
    report = cls_o.to(boxes.dtype) - (cls_o > bg).to(boxes.dtype)
    return torch.cat([
        torch.where(kept, report, torch.full_like(report, -1.0))[..., None],
        (score.gather(1, order) * kept.to(score.dtype))[..., None],
        boxes_o], dim=-1)


alias("_contrib_MultiBoxDetection", "MultiBoxDetection")


# --------------------------------------------------------------------------
# MultiProposal: RPN proposals for Faster R-CNN, the whole batch at once
# --------------------------------------------------------------------------
def base_anchors(stride, scales, ratios):
    """The RPN base anchors around the stride-sized cell at (0, 0), in
    float64 with ``np.round``, cast once to float32 (A, 4)."""
    base = np.array([0, 0, stride - 1, stride - 1], dtype=np.float64)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            anchors.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1),
                            cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
    return np.array(anchors, dtype=np.float32)


def _iou_pixel(a, b):
    """IoU with the pixel-inclusive (+1) areas of the RPN: a (..., K, 4),
    b (..., M, 4) -> (..., K, M)."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = torch.clamp(x2 - x1 + 1.0, min=0.0)
    ih = torch.clamp(y2 - y1 + 1.0, min=0.0)
    inter = iw * ih
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _mp_infer(attrs, in_shapes):
    cls_s = in_shapes[0]
    post = parse_int(attrs.get("rpn_post_nms_top_n", 300))
    n = cls_s[0] if cls_s is not None else None
    out = [(n * post, 5) if n is not None else None]
    if parse_bool(attrs.get("output_score", False)):
        out.append((n * post, 1) if n is not None else None)
    return list(in_shapes), out, []


def _clip(x, lo, hi):
    """``jnp.clip`` with per-image bounds (N, 1): max first, then min."""
    return torch.minimum(torch.maximum(x, lo), hi)


@register("MultiProposal", inputs=("cls_prob", "bbox_pred", "im_info"),
          infer_shape=_mp_infer,
          num_outputs=lambda a: 2 if parse_bool(
              a.get("output_score", False)) else 1,
          attr_spec={
              "rpn_pre_nms_top_n": (parse_int, 6000),
              "rpn_post_nms_top_n": (parse_int, 300),
              "threshold": (parse_float, 0.7),
              "rpn_min_size": (parse_int, 16),
              "scales": (lambda v: _parse_floats(v, (4., 8., 16., 32.)),
                         (4., 8., 16., 32.)),
              "ratios": (lambda v: _parse_floats(v, (0.5, 1., 2.)),
                         (0.5, 1., 2.)),
              "feature_stride": (parse_int, 16),
              "output_score": (parse_bool, False),
              "iou_loss": (parse_bool, False)})
def _multi_proposal(attrs, cls_prob, bbox_pred, im_info):
    """Anchors plus deltas, clipped to the image, boxes under the scaled
    minimum size dropped, the ``pre`` best by foreground score (ties to
    the lower index), NMS, the first ``post`` survivors in score order
    (box 0 repeated as padding) -> rois (N post, 5) [batch, x1, y1, x2,
    y2], with ``output_score`` also their scores (N post, 1)."""
    with torch.no_grad():
        return _multi_proposal_batch(attrs, cls_prob, bbox_pred, im_info)


def _multi_proposal_batch(attrs, cls_prob, bbox_pred, im_info):
    stride = attrs.get("feature_stride", 16)
    nms_t = attrs.get("threshold", 0.7)
    min_size = attrs.get("rpn_min_size", 16)
    N, _, H, W = cls_prob.shape
    dev = cls_prob.device
    base = torch.from_numpy(base_anchors(
        stride, attrs.get("scales", (4., 8., 16., 32.)),
        attrs.get("ratios", (0.5, 1., 2.)))).to(dev)
    A = base.shape[0]
    sx = (torch.arange(W, device=dev) * stride).to(torch.float32)
    sy = (torch.arange(H, device=dev) * stride).to(torch.float32)
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([sxg, syg, sxg, syg], dim=-1)
    anchors = (shifts[:, :, None, :] + base).reshape(-1, 4)   # (HWA, 4)
    total = H * W * A
    pre = min(parse_int(attrs.get("rpn_pre_nms_top_n", 6000)), total)
    post = parse_int(attrs.get("rpn_post_nms_top_n", 300))

    # foreground scores: channels [A, 2A), (A, H, W) -> (H, W, A)
    score = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    deltas = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    if parse_bool(attrs.get("iou_loss", False)):
        boxes = anchors + deltas
    else:
        aw = anchors[:, 2] - anchors[:, 0] + 1.0
        ah = anchors[:, 3] - anchors[:, 1] + 1.0
        acx = anchors[:, 0] + 0.5 * (aw - 1.0)
        acy = anchors[:, 1] + 0.5 * (ah - 1.0)
        cx = deltas[..., 0] * aw + acx
        cy = deltas[..., 1] * ah + acy
        w = torch.exp(deltas[..., 2]) * aw
        h = torch.exp(deltas[..., 3]) * ah
        boxes = torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                             cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)],
                            dim=-1)
    im_h, im_w, im_scale = (im_info[:, i:i + 1] for i in range(3))
    zero = torch.zeros((), dtype=boxes.dtype, device=dev)
    boxes = torch.stack([_clip(boxes[..., 0], zero, im_w - 1.0),
                         _clip(boxes[..., 1], zero, im_h - 1.0),
                         _clip(boxes[..., 2], zero, im_w - 1.0),
                         _clip(boxes[..., 3], zero, im_h - 1.0)], dim=-1)
    ms = min_size * im_scale
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    valid = (bw >= ms) & (bh >= ms)
    score_m = torch.where(valid, score, torch.full_like(score,
                                                        float("-inf")))
    top = torch.sort(score_m, dim=1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :pre], top.indices[:, :pre]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    supp = (_iou_pixel(top_boxes, top_boxes) > nms_t) & torch.ones(
        (pre, pre), dtype=torch.bool, device=dev).triu(1)
    alive = greedy_nms(supp) & torch.isfinite(top_scores)
    # the survivors first, in order; the first index repeated as padding
    key = torch.where(alive, torch.arange(pre, device=dev), pre)
    order = torch.sort(key, dim=1, stable=True).indices
    first = order[:, :1]
    idx = order[:, :post] if pre >= post else torch.cat(
        [order, first.expand(-1, post - pre)], dim=1)
    n_alive = alive.sum(dim=1, keepdim=True)
    slots = torch.arange(post, device=dev)[None, :]
    gather = torch.where(slots < torch.clamp(n_alive, min=1), idx, first)
    out_boxes = top_boxes.gather(1, gather[..., None].expand(-1, -1, 4))
    gathered = top_scores.gather(1, gather)
    out_scores = torch.where((slots < n_alive) & torch.isfinite(gathered),
                             gathered, torch.zeros_like(gathered))
    batch_idx = torch.arange(N, device=dev, dtype=boxes.dtype) \
        .repeat_interleave(post)
    rois = torch.cat([batch_idx[:, None], out_boxes.reshape(N * post, 4)],
                     dim=-1)
    if parse_bool(attrs.get("output_score", False)):
        return rois, out_scores.reshape(N * post, 1)
    return rois


alias("_contrib_MultiProposal", "MultiProposal")
alias("_contrib_Proposal", "MultiProposal")
alias("Proposal", "MultiProposal")

_cost.seed_costs()
