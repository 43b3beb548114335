"""AlexNet symbol.

Architecture per Krizhevsky et al. 2012 as configured in the reference's
example zoo (example/image-classification/symbols/alexnet.py): five conv
layers (the first two followed by local response normalization), three
max-pools, and three fully-connected layers with dropout. The layer
hyperparameters (kernel/stride/pad/filter counts) are the fixed AlexNet
spec; the graph construction below is ours.

Node for node the JAX package's mxnet_tpu/models/alexnet.py, so both
packages give the same symbol JSON.
"""
from .. import symbol as sym

# (num_filter, kernel, stride, pad, lrn?, pool?) for the conv trunk
_TRUNK = [
    (96, (11, 11), (4, 4), (0, 0), True, True),
    (256, (5, 5), (1, 1), (2, 2), True, True),
    (384, (3, 3), (1, 1), (1, 1), False, False),
    (384, (3, 3), (1, 1), (1, 1), False, False),
    (256, (3, 3), (1, 1), (1, 1), False, True),
]


def get_symbol(num_classes=1000, **kwargs):
    net = sym.var("data")
    for i, (nf, kernel, stride, pad, lrn, pool) in enumerate(_TRUNK, 1):
        net = sym.Convolution(data=net, num_filter=nf, kernel=kernel,
                              stride=stride, pad=pad, name=f"conv{i}")
        net = sym.Activation(data=net, act_type="relu")
        if lrn:
            net = sym.LRN(data=net, alpha=0.0001, beta=0.75, knorm=2,
                          nsize=5)
        if pool:
            net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3),
                              stride=(2, 2))
    net = sym.Flatten(data=net)
    for i, width in enumerate([4096, 4096], 1):
        net = sym.FullyConnected(data=net, num_hidden=width, name=f"fc{i}")
        net = sym.Activation(data=net, act_type="relu")
        net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(data=net, name="softmax")
