"""VGG symbol (reference: example/image-classification/symbols/vgg.py).

Node for node the JAX package's mxnet_tpu/models/vgg.py, so both
packages give the same symbol JSON.
"""
from .. import symbol as sym


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
                13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
                16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
                19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}
    if num_layers not in vgg_spec:
        raise ValueError(f"no experiments done on num_layers {num_layers}")
    layers, filters = vgg_spec[num_layers]
    body = sym.var("data")
    for i, num in enumerate(layers):
        for j in range(num):
            body = sym.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=filters[i],
                                   name=f"conv{i + 1}_{j + 1}")
            if batch_norm:
                body = sym.BatchNorm(data=body, name=f"bn{i + 1}_{j + 1}")
            body = sym.Activation(data=body, act_type="relu",
                                  name=f"relu{i + 1}_{j + 1}")
        body = sym.Pooling(data=body, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), name=f"pool{i + 1}")
    flatten = sym.Flatten(data=body, name="flatten")
    fc6 = sym.FullyConnected(data=flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(data=relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(data=drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(data=fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(data=relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(data=drop7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=fc8, name="softmax")
