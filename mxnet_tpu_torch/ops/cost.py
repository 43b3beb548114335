"""Cost metadata seeding: FLOPs/bytes per op for MFU accounting.

The port's copy of ``mxnet_tpu/ops/cost.py`` (which imports no JAX):
every ``OpDef`` may carry ``flops(attrs, in_shapes)`` and
``bytes_moved(attrs, in_shapes)`` estimators for ONE forward execution,
which ``telemetry/mfu.py`` folds over a bound graph into per-op roofline
positions and a model-level MFU figure. This module attaches estimators
to every op that matters for the flagship workloads — the
convolution/dense/batchnorm/softmax/optimizer set that dominates ResNet-50
and the LM's step time — plus blanket estimators for the
elementwise/reduction/movement families, so coverage is the rule, not the
exception. The table names ops the port does not register yet; they are
seeded when they arrive. ``uncovered_ops()`` lists the registered ops
still without metadata instead of silently under-counting.

``seed_costs()`` runs when this module is imported (by ``ops``) and again
at the end of ``rtc.py``, whose ops register later, as in the JAX
package.

Conventions (kept deliberately simple and auditable):

* one fused multiply-add = 2 FLOPs (XLA cost_analysis convention, kept so
  the port's counts equal the JAX package's op for op);
* bytes assume 4 B/element (master-param width);
* data-movement ops (reshape/transpose/concat/slice/...) are 0 FLOPs
  but real bytes — they still occupy roofline positions.
"""
from __future__ import annotations

from ..base import parse_bool, parse_int, parse_tuple
from .registry import OP_REGISTRY

__all__ = ["seed_costs", "uncovered_ops", "partial_cost_ops",
           "optimizer_flops"]

_B = 4.0                                   # accounting bytes / element


def _prod(s):
    out = 1
    for d in s:
        out *= int(d)
    return out


def _elems(in_shapes, i=0):
    if i >= len(in_shapes) or in_shapes[i] is None:
        raise ValueError("unknown shape")
    return _prod(in_shapes[i])


def _sum_elems(in_shapes):
    return sum(_prod(s) for s in in_shapes if s is not None)


def _ntuple(v, n, default):
    t = parse_tuple(v) if v is not None else None
    if t is None:
        return (default,) * n
    if len(t) != n:
        t = tuple(t) + (default,) * (n - len(t))
    return t


# ---------------------------------------------------------------- shapes
def _conv_out_spatial(attrs, data_s):
    kernel = parse_tuple(attrs["kernel"])
    nd = len(kernel)
    stride = _ntuple(attrs.get("stride"), nd, 1)
    pad = _ntuple(attrs.get("pad"), nd, 0)
    dilate = _ntuple(attrs.get("dilate"), nd, 1)
    return tuple(
        (data_s[2 + i] + 2 * pad[i] - (dilate[i] * (kernel[i] - 1) + 1))
        // stride[i] + 1 for i in range(nd))


def _conv_flops(attrs, in_shapes):
    data_s = in_shapes[0]
    kernel = parse_tuple(attrs["kernel"])
    nf = parse_int(attrs["num_filter"])
    ng = parse_int(attrs.get("num_group", 1))
    out_sp = _conv_out_spatial(attrs, data_s)
    macs = _prod(out_sp) * data_s[0] * nf * (data_s[1] // ng) * \
        _prod(kernel)
    flops = 2.0 * macs
    if not parse_bool(attrs.get("no_bias", False)):
        flops += data_s[0] * nf * _prod(out_sp)
    return flops


def _conv_bytes(attrs, in_shapes):
    data_s = in_shapes[0]
    nf = parse_int(attrs["num_filter"])
    out = data_s[0] * nf * _prod(_conv_out_spatial(attrs, data_s))
    return _B * (_sum_elems(in_shapes) + out)


def _deconv_flops(attrs, in_shapes):
    # transposed conv: MACs = in_spatial * N * C_in * (nf/g) * kernel
    data_s = in_shapes[0]
    kernel = parse_tuple(attrs["kernel"])
    nf = parse_int(attrs["num_filter"])
    ng = parse_int(attrs.get("num_group", 1))
    return 2.0 * _prod(data_s) * (nf // ng) * _prod(kernel)


def _deconv_bytes(attrs, in_shapes):
    data_s = in_shapes[0]
    kernel = parse_tuple(attrs["kernel"])
    nd = len(kernel)
    stride = _ntuple(attrs.get("stride"), nd, 1)
    pad = _ntuple(attrs.get("pad"), nd, 0)
    adj = _ntuple(attrs.get("adj"), nd, 0)
    nf = parse_int(attrs["num_filter"])
    sp = tuple(stride[i] * (data_s[2 + i] - 1) + kernel[i] - 2 * pad[i]
               + adj[i] for i in range(nd))
    return _B * (_sum_elems(in_shapes) + data_s[0] * nf * _prod(sp))


def _fc_flops(attrs, in_shapes):
    data_s = in_shapes[0]
    num_hidden = parse_int(attrs["num_hidden"])
    n = data_s[0]
    in_dim = _prod(data_s[1:])
    flops = 2.0 * n * in_dim * num_hidden
    if not parse_bool(attrs.get("no_bias", False)):
        flops += n * num_hidden
    return flops


def _fc_bytes(attrs, in_shapes):
    data_s = in_shapes[0]
    num_hidden = parse_int(attrs["num_hidden"])
    return _B * (_sum_elems(in_shapes) + data_s[0] * num_hidden)


def _cbr_flops(attrs, in_shapes):
    # conv + ~11 FLOPs/element of BN-normalize + ReLU epilogue
    data_s = in_shapes[0]
    nf = parse_int(attrs["num_filter"])
    out = data_s[0] * nf * _prod(_conv_out_spatial(attrs, data_s))
    return _conv_flops(dict(attrs, no_bias=True), in_shapes) + 11.0 * out


def _cbr_bytes(attrs, in_shapes):
    # the fusion's point: the epilogue adds no extra HBM round trip
    data_s = in_shapes[0]
    nf = parse_int(attrs["num_filter"])
    out = data_s[0] * nf * _prod(_conv_out_spatial(attrs, data_s))
    return _B * (_sum_elems(in_shapes) + out)


def _rnn_flops(attrs, in_shapes):
    # gates * 2 matmuls (i2h + h2h) * 2 FLOPs/MAC, per layer per step
    data_s = in_shapes[0]                   # (T, N, I)
    t, n, i = data_s[0], data_s[1], _prod(data_s[2:])
    h = parse_int(attrs["state_size"])
    layers = parse_int(attrs.get("num_layers", 1))
    gates = {"lstm": 4, "gru": 3}.get(
        str(attrs.get("mode", "lstm")).lower(), 1)
    d = 2 if parse_bool(attrs.get("bidirectional", False)) else 1
    per_layer = 2.0 * t * n * gates * h * (i + h)
    deeper = 2.0 * t * n * gates * h * (d * h + h) * max(0, layers - 1)
    return d * (per_layer + deeper)


def _rnn_bytes(attrs, in_shapes):
    data_s = in_shapes[0]
    h = parse_int(attrs["state_size"])
    d = 2 if parse_bool(attrs.get("bidirectional", False)) else 1
    out = data_s[0] * data_s[1] * d * h
    return _B * (_sum_elems(in_shapes) + out)


def _qfc_flops(attrs, in_shapes):
    # dense matmul + per-element weight dequant; bias add when present
    data_s = in_shapes[0]
    num_hidden = parse_int(attrs["num_hidden"])
    n = data_s[0]
    in_dim = _prod(data_s[1:])
    flops = 2.0 * n * in_dim * num_hidden + num_hidden * in_dim
    if not parse_bool(attrs.get("no_bias", False)):
        flops += n * num_hidden
    return flops


def _qfc_bytes(attrs, in_shapes):
    # quantized weights (int8 or fp8 storage) move at 1 B/element —
    # the tier's whole point; data, scales, bias and output stay at
    # the 4 B accounting width
    data_s, w_s = in_shapes[0], in_shapes[1]
    num_hidden = parse_int(attrs["num_hidden"])
    float_elems = _prod(data_s) + data_s[0] * num_hidden + \
        sum(_prod(s) for s in in_shapes[2:] if s is not None)
    return _B * float_elems + 1.0 * _prod(w_s)


def _qconv_flops(attrs, in_shapes):
    w_s = in_shapes[1]
    return _conv_flops(attrs, in_shapes) + float(_prod(w_s))


def _qconv_bytes(attrs, in_shapes):
    # 1 B/elem weights (int8 or fp8 storage), float everything else
    data_s, w_s = in_shapes[0], in_shapes[1]
    nf = parse_int(attrs["num_filter"])
    out = data_s[0] * nf * _prod(_conv_out_spatial(attrs, data_s))
    float_elems = _prod(data_s) + out + \
        sum(_prod(s) for s in in_shapes[2:] if s is not None)
    return _B * float_elems + 1.0 * _prod(w_s)


def _embedding_cost():
    # gather: ids + the N looked-up rows move; the untouched vocabulary
    # rows do not (one-pass gather, fused or not)
    def flops(attrs, in_shapes):
        return 0.0

    def nbytes(attrs, in_shapes):
        ids = _prod(in_shapes[0])
        d = in_shapes[1][1]
        return _B * (ids + 2.0 * ids * d)

    return flops, nbytes


def _attention_flops(attrs, in_shapes):
    b, h, t, d = in_shapes[0]
    return 4.0 * b * h * t * t * d


def _attention_bytes(attrs, in_shapes):
    return _B * 2.0 * _sum_elems(in_shapes)


def _attention_decode_flops(attrs, in_shapes):
    # S query tokens against the full C-capacity cache: qk^T + pv
    b, h, s, d = in_shapes[0]
    c = parse_int(attrs.get("capacity", 256))
    return 4.0 * b * h * s * c * d


def _attention_decode_bytes(attrs, in_shapes):
    # q/k/v/out move once at compute width; the K/V cache READ is
    # cursor-bounded — only the live prefix [0, cursor + S) streams
    # from HBM (the pallas variant's index-map clamp; a session's
    # cursor averages C/2) — and the write lands S rows per cache.
    # Both charge at the declared cache_dtype width: fp8 storage moves
    # 1 B/elem, the default compute-width cells 4 B
    b, h, s, d = in_shapes[0]
    c = parse_int(attrs.get("capacity", 256))
    itm = 1.0 if str(attrs.get("cache_dtype", "")).startswith(
        ("fp8", "float8", "e4m3", "e5m2")) else _B
    live = c / 2.0 + s
    return _B * 4.0 * b * h * s * d + \
        itm * 2.0 * b * h * (live + s) * d


def _rope_cost():
    # per element: 2 muls + 1 add on each half plus the trig tables
    def flops(attrs, in_shapes):
        return 8.0 * _elems(in_shapes)

    def nbytes(attrs, in_shapes):
        return _B * 2.0 * _elems(in_shapes)

    return flops, nbytes


def _dot_flops(attrs, in_shapes):
    a, b = in_shapes[0], in_shapes[1]
    ta = parse_bool(attrs.get("transpose_a", False))
    tb = parse_bool(attrs.get("transpose_b", False))
    m = a[-1 if ta else 0] if len(a) > 1 else 1
    k = a[0 if ta else -1]
    n = b[-1 if not tb else 0] if len(b) > 1 else 1
    batch = _prod(a[:-2]) if len(a) > 2 else 1
    return 2.0 * batch * m * k * n


def _dot_bytes(attrs, in_shapes):
    return _B * 2.0 * _sum_elems(in_shapes)


# ------------------------------------------------------ family estimators
def _ew(flops_per_elem, reads=1, writes=1):
    """Elementwise family: k FLOPs/element of the largest operand."""
    def flops(attrs, in_shapes):
        return flops_per_elem * max(_prod(s) for s in in_shapes
                                    if s is not None)

    def nbytes(attrs, in_shapes):
        biggest = max(_prod(s) for s in in_shapes if s is not None)
        return _B * (_sum_elems(in_shapes) + writes * biggest)

    return flops, nbytes


def _move():
    """Pure data movement: 0 FLOPs, in+out bytes."""
    def flops(attrs, in_shapes):
        return 0.0

    def nbytes(attrs, in_shapes):
        return _B * 2.0 * _sum_elems(in_shapes)

    return flops, nbytes


def _reduce_cost():
    def flops(attrs, in_shapes):
        return float(_elems(in_shapes))

    def nbytes(attrs, in_shapes):
        return _B * _elems(in_shapes)

    return flops, nbytes


def _pool_cost():
    def flops(attrs, in_shapes):
        return float(_elems(in_shapes))

    def nbytes(attrs, in_shapes):
        return _B * 1.5 * _elems(in_shapes)   # out is ~stride^2 smaller

    return flops, nbytes


def _opt_cost(flops_per_elem, n_arrays):
    def flops(attrs, in_shapes):
        return flops_per_elem * _elems(in_shapes)

    def nbytes(attrs, in_shapes):
        return _B * n_arrays * _elems(in_shapes)

    return flops, nbytes


#: per-weight-element FLOPs of each optimizer update (mfu.optimizer_flops
#: reads this for fused-path updates that never appear as graph nodes)
OPTIMIZER_FLOPS_PER_ELEM = {
    "sgd": 4.0, "sgd_update": 4.0,
    "sgd_mom": 6.0, "sgd_mom_update": 6.0, "nag": 8.0, "ccsgd": 6.0,
    "adam": 12.0, "adam_update": 12.0,
    "rmsprop": 8.0, "rmsprop_update": 8.0,
    "rmspropalex_update": 12.0, "adagrad": 6.0, "adadelta": 10.0,
}


def optimizer_flops(name, n_params):
    """FLOPs of one full optimizer step over n_params weight elements."""
    per = OPTIMIZER_FLOPS_PER_ELEM.get(str(name).lower(), 6.0)
    return per * float(n_params)


# ----------------------------------------------------------------- tables
# dominant ops get dedicated estimators
_SPECIFIC = {
    "Convolution": (_conv_flops, _conv_bytes),
    "Deconvolution": (_deconv_flops, _deconv_bytes),
    "FullyConnected": (_fc_flops, _fc_bytes),
    "FusedConvBNReLU": (_cbr_flops, _cbr_bytes),
    "RNN": (_rnn_flops, _rnn_bytes),
    "dot": (_dot_flops, _dot_bytes),
    "batch_dot": (_dot_flops, _dot_bytes),
    "BatchNorm": _ew(10.0, writes=1),
    "LayerNorm": _ew(8.0),
    "FusedBiasGeLU": _ew(10.0),          # erf ≈ several vector ops
    "QuantizedFullyConnected": (_qfc_flops, _qfc_bytes),
    "QuantizedConvolution": (_qconv_flops, _qconv_bytes),
    "attention": (_attention_flops, _attention_bytes),
    "attention_decode": (_attention_decode_flops, _attention_decode_bytes),
    "RoPE": _rope_cost(),
    "InstanceNorm": _ew(10.0),
    "L2Normalization": _ew(4.0),
    "LRN": _ew(8.0),
    "SoftmaxOutput": _ew(5.0),
    "SoftmaxActivation": _ew(5.0),
    "softmax_cross_entropy": _ew(5.0),
    "softmax": _ew(5.0),
    "log_softmax": _ew(5.0),
    "Pooling": _pool_cost(),
    "Dropout": _ew(2.0),
    "Activation": _ew(1.0),
    "LeakyReLU": _ew(2.0),
    "Embedding": _embedding_cost(),
    "sgd_update": _opt_cost(4.0, 3),
    "sgd_mom_update": _opt_cost(6.0, 5),
    "adam_update": _opt_cost(12.0, 7),
    "rmsprop_update": _opt_cost(8.0, 5),
    "rmspropalex_update": _opt_cost(12.0, 9),
    "pallas_sgd_mom_update": _opt_cost(6.0, 5),
    "pallas_flash_attention": (_attention_flops, _attention_bytes),
    "LinearRegressionOutput": _ew(2.0),
    "LogisticRegressionOutput": _ew(4.0),
    "MAERegressionOutput": _ew(2.0),
    "SVMOutput": _ew(4.0),
    "MakeLoss": _ew(1.0),
    "IdentityAttachKLSparseReg": _ew(6.0),
    "add_n": (lambda attrs, s: float(max(0, len(s) - 1)) * _elems(s),
              lambda attrs, s: _B * (_sum_elems(s) + _elems(s))),
}

_UNARY_1FLOP = {
    "abs", "ceil", "fix", "floor", "negative", "relu", "rint", "round",
    "sign", "square", "clip",
}
_UNARY_XCENDENTAL = {
    "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh", "cos",
    "cosh", "degrees", "exp", "expm1", "gamma", "gammaln", "log", "log10",
    "log1p", "log2", "radians", "rsqrt", "sigmoid", "sin", "sinh", "sqrt",
    "tan", "tanh", "smooth_l1",
}
_MOVEMENT = {
    "Reshape", "reshape", "Flatten", "flatten", "transpose", "Cast",
    "cast", "_copy", "identity", "BlockGrad", "stop_gradient",
    "make_loss", "Concat", "concat", "SliceChannel", "split", "slice",
    "slice_axis", "Crop", "expand_dims", "repeat", "tile", "reverse",
    "flip", "take", "pick", "one_hot", "SequenceLast", "SequenceMask",
    "SequenceReverse", "UpSampling", "Pad", "pad", "swapaxes",
    "SwapAxis", "broadcast_axis", "broadcast_to", "zeros_like",
    "ones_like", "_zeros", "_ones", "_arange", "where", "gather_nd",
    "batch_take", "stack",
}
_REDUCTIONS = {
    "sum", "mean", "prod", "nansum", "nanprod", "max", "min", "norm",
    "argmax", "argmin", "argmax_channel", "topk", "sort", "argsort",
}
_BINARY_NAMES = ("add", "sub", "mul", "div", "power", "hypot", "maximum",
                 "minimum", "equal", "not_equal", "greater",
                 "greater_equal", "lesser", "lesser_equal", "mod")


def _family_table():
    table = {}
    for name in _UNARY_1FLOP:
        table[name] = _ew(1.0)
    for name in _UNARY_XCENDENTAL:
        table[name] = _ew(4.0)          # transcendental ~ a few vector ops
    for name in _MOVEMENT:
        table[name] = _move()
    for name in _REDUCTIONS:
        table[name] = _reduce_cost()
    for b in _BINARY_NAMES:
        k = 1.0
        for name in (f"elemwise_{b}" if b in ("add", "sub", "mul", "div")
                     else f"_{b}", f"broadcast_{b}", f"_{b}_scalar"):
            table[name] = _ew(k)
    for name in ("_rsub_scalar", "_rdiv_scalar", "_rpower_scalar",
                 "_rmod_scalar"):
        table[name] = _ew(1.0)
    return table


def seed_costs():
    """Attach estimators to every covered registry op (idempotent;
    specific estimators win over family blankets, and ops that already
    carry metadata keep their own)."""
    table = dict(_family_table())
    table.update(_SPECIFIC)
    for name, (flops, nbytes) in table.items():
        opdef = OP_REGISTRY.get(name)
        if opdef is not None and not opdef.has_cost():
            opdef.set_cost(flops=flops, bytes_moved=nbytes)


def uncovered_ops():
    """Registry ops still missing cost metadata. Aliases resolve to one
    OpDef, so each opdef reports once under its canonical name."""
    seen = {}
    for name, opdef in OP_REGISTRY.items():
        if not opdef.has_cost():
            seen.setdefault(id(opdef), opdef.name)
    return sorted(seen.values())


def partial_cost_ops():
    """Ops carrying exactly ONE of flops/bytes_moved — a half-seeded
    estimator under-counts one roofline axis while looking covered."""
    seen = {}
    for name, opdef in OP_REGISTRY.items():
        if (opdef.flops is None) != (opdef.bytes_moved is None):
            seen.setdefault(id(opdef), opdef.name)
    return sorted(seen.values())


seed_costs()
