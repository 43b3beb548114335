"""Inception-v3 symbol (299x299 input).

Architecture per Szegedy et al., "Rethinking the Inception Architecture
for Computer Vision" (2015), as configured in the reference's example
zoo (reference: example/image-classification/symbols/inception-v3.py:1
— BASELINE's "ResNet-50 / Inception-v3 on ImageNet" config). Layer
names follow the reference's checkpoint naming so `.params` files line
up. The builders below are table-driven: every tower is a conv chain
spec run by `_chain`, the five mixed-block shapes (A grid, B reduce,
C factorized-7, D reduce, E expanded-3) differ only in their tower
tables.

Node for node the JAX package's mxnet_tpu/models/inception_v3.py, so both
packages give the same symbol JSON.
"""
from .. import symbol as sym

# conv spec: (num_filter, kernel, stride, pad)
_1x1 = lambda nf: (nf, (1, 1), (1, 1), (0, 0))


def _conv(data, nf, kernel=(1, 1), stride=(1, 1), pad=(0, 0), name=None,
          suffix=""):
    """conv -> BN(fix_gamma) -> relu, the v3 building block."""
    net = sym.Convolution(data=data, num_filter=nf, kernel=kernel,
                          stride=stride, pad=pad, no_bias=True,
                          name=f"{name}{suffix}_conv2d")
    net = sym.BatchNorm(data=net, fix_gamma=True,
                        name=f"{name}{suffix}_batchnorm")
    return sym.Activation(data=net, act_type="relu",
                          name=f"{name}{suffix}_relu")


def _chain(data, specs, name):
    """Run one tower: consecutive convs with reference suffix numbering
    (_conv, _conv_1, _conv_2, ...)."""
    out = data
    for i, (nf, kernel, stride, pad) in enumerate(specs):
        out = _conv(out, nf, kernel, stride, pad, name=name,
                    suffix="_conv" if i == 0 else f"_conv_{i}")
    return out


def _pool(data, pool_type, name):
    """Grid-preserving 3x3 stride-1 pool feeding a projection conv."""
    return sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                       pad=(1, 1), pool_type=pool_type,
                       name=f"{pool_type}_pool_{name}_pool")


def _block_a(data, n1, r3, n3a, n3b, r5, n5, pool, proj, name):
    """Grid-size-preserving block: 1x1 / 5x5 / double-3x3 / pool-proj."""
    t1 = _conv(data, n1, name=f"{name}_conv")
    t5 = _chain(data, [_1x1(r5), (n5, (5, 5), (1, 1), (2, 2))],
                f"{name}_tower")
    t3 = _chain(data, [_1x1(r3), (n3a, (3, 3), (1, 1), (1, 1)),
                       (n3b, (3, 3), (1, 1), (1, 1))], f"{name}_tower_1")
    p = _pool(data, pool, name)
    cp = _conv(p, proj, name=f"{name}_tower_2", suffix="_conv")
    return sym.Concat(t1, t5, t3, cp, name=f"ch_concat_{name}_chconcat")


def _block_b(data, n3, r, d1, d2, name):
    """First grid reduction: strided 3x3 / strided double-3x3 / max-pool."""
    t3 = _conv(data, n3, kernel=(3, 3), stride=(2, 2), name=f"{name}_conv")
    td = _chain(data, [_1x1(r), (d1, (3, 3), (1, 1), (1, 1)),
                       (d2, (3, 3), (2, 2), (0, 0))], f"{name}_tower")
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(0, 0),
                    pool_type="max", name=f"max_pool_{name}_pool")
    return sym.Concat(t3, td, p, name=f"ch_concat_{name}_chconcat")


def _block_c(data, n1, rd, d1, d2, rq, q1, q2, q3, q4, pool, proj, name):
    """Factorized-7x7 block: 1x1 / 1x7-7x1 / 7x1-1x7-7x1-1x7 / pool-proj."""
    t1 = _conv(data, n1, name=f"{name}_conv")
    td = _chain(data, [_1x1(rd), (d1, (1, 7), (1, 1), (0, 3)),
                       (d2, (7, 1), (1, 1), (3, 0))], f"{name}_tower")
    tq = _chain(data, [_1x1(rq), (q1, (7, 1), (1, 1), (3, 0)),
                       (q2, (1, 7), (1, 1), (0, 3)),
                       (q3, (7, 1), (1, 1), (3, 0)),
                       (q4, (1, 7), (1, 1), (0, 3))], f"{name}_tower_1")
    p = _pool(data, pool, name)
    cp = _conv(p, proj, name=f"{name}_tower_2", suffix="_conv")
    return sym.Concat(t1, td, tq, cp, name=f"ch_concat_{name}_chconcat")


def _block_d(data, r3, n3, rd, d1, d2, d3, pool, name):
    """Second grid reduction: 1x1-3x3s2 / 1x1-1x7-7x1-3x3s2 / pool."""
    t3 = _chain(data, [_1x1(r3), (n3, (3, 3), (2, 2), (0, 0))],
                f"{name}_tower")
    td = _chain(data, [_1x1(rd), (d1, (1, 7), (1, 1), (0, 3)),
                       (d2, (7, 1), (1, 1), (3, 0)),
                       (d3, (3, 3), (2, 2), (0, 0))], f"{name}_tower_1")
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(0, 0),
                    pool_type=pool, name=f"{pool}_pool_{name}_pool")
    return sym.Concat(t3, td, p, name=f"ch_concat_{name}_chconcat")


def _block_e(data, n1, rd3, d3a, d3b, r33, n33, d33a, d33b, pool, proj,
             name):
    """Expanded-filter-bank block: the 3x3s split into parallel 1x3/3x1
    outputs that concat (coarsest-grid stage)."""
    t1 = _conv(data, n1, name=f"{name}_conv")
    stem = _conv(data, rd3, name=f"{name}_tower", suffix="_conv")
    ta = _conv(stem, d3a, kernel=(1, 3), pad=(0, 1), name=f"{name}_tower",
               suffix="_mixed_conv")
    tb = _conv(stem, d3b, kernel=(3, 1), pad=(1, 0), name=f"{name}_tower",
               suffix="_mixed_conv_1")
    stem2 = _chain(data, [_1x1(r33), (n33, (3, 3), (1, 1), (1, 1))],
                   f"{name}_tower_1")
    t2a = _conv(stem2, d33a, kernel=(1, 3), pad=(0, 1),
                name=f"{name}_tower_1", suffix="_mixed_conv")
    t2b = _conv(stem2, d33b, kernel=(3, 1), pad=(1, 0),
                name=f"{name}_tower_1", suffix="_mixed_conv_1")
    p = _pool(data, pool, name)
    cp = _conv(p, proj, name=f"{name}_tower_2", suffix="_conv")
    return sym.Concat(t1, ta, tb, t2a, t2b, cp,
                      name=f"ch_concat_{name}_chconcat")


# stage tables: per-block tower widths (the published v3 configuration)
_STAGE_A = [(64, 64, 96, 96, 48, 64, "avg", 32, "mixed"),
            (64, 64, 96, 96, 48, 64, "avg", 64, "mixed_1"),
            (64, 64, 96, 96, 48, 64, "avg", 64, "mixed_2")]
_STAGE_C = [(192, 128, 128, 192, 128, 128, 128, 128, 192, "avg", 192,
             "mixed_4"),
            (192, 160, 160, 192, 160, 160, 160, 160, 192, "avg", 192,
             "mixed_5"),
            (192, 160, 160, 192, 160, 160, 160, 160, 192, "avg", 192,
             "mixed_6"),
            (192, 192, 192, 192, 192, 192, 192, 192, 192, "avg", 192,
             "mixed_7")]
_STAGE_E = [(320, 384, 384, 384, 448, 384, 384, 384, "avg", 192,
             "mixed_9"),
            (320, 384, 384, 384, 448, 384, 384, 384, "max", 192,
             "mixed_10")]


def get_symbol(num_classes=1000, **kwargs):
    data = sym.var("data")
    # stem: 299 -> 35 spatial
    net = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name="conv")
    net = _conv(net, 32, kernel=(3, 3), name="conv_1")
    net = _conv(net, 64, kernel=(3, 3), pad=(1, 1), name="conv_2")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max", name="pool")
    net = _conv(net, 80, kernel=(1, 1), name="conv_3")
    net = _conv(net, 192, kernel=(3, 3), name="conv_4")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max", name="pool1")
    for cfg in _STAGE_A:
        net = _block_a(net, *cfg)
    net = _block_b(net, 384, 64, 96, 96, "mixed_3")
    for cfg in _STAGE_C:
        net = _block_c(net, *cfg)
    net = _block_d(net, 192, 320, 192, 192, 192, 192, "max", "mixed_8")
    for cfg in _STAGE_E:
        net = _block_e(net, *cfg)
    net = sym.Pooling(data=net, kernel=(8, 8), stride=(1, 1),
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(data=net, name="flatten")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
