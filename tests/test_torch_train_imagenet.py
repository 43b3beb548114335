"""One training step of the ImageNet branch of ResNet — the 7x7 stride-2
stem, max pooling, four stages, global average pooling, the 1000-way
head's kind — in ``mxnet_tpu_torch`` against ``mxnet_tpu``'s fused fit,
on the CPU at 3x40x40 and batch 2.

ResNet-50 itself is NOT the network compared here: one SGD step of it at
this size is chaotic in float32. Measured with the port alone, scaling
its weights by (1 + 1e-7 * noise) moves conv0's gradient by 4.5 (the
largest gradients are of order 10) — BatchNorm over the few positions of
a small image, sixteen bottleneck units deep, amplifies rounding until a
ReLU mask flips. Two networks that keep every part of ResNet-50's
ImageNet branch and stay well conditioned (the same perturbation moves
no gradient by more than 4e-5) are compared instead:

* ResNet-18 (basic units, the ImageNet branch's smallest depth);
* the bottleneck ResNet at ResNet-50's full widths (64, 256, 512, 1024,
  2048) with one unit per stage: every unit kind of ResNet-50, the
  projection shortcut and the stride-2 bottleneck included.

Both start from the JAX package's Xavier parameters, carried across as
numpy. Compared after the step: every argument, BatchNorm moving
statistic and momentum. Tolerance 1e-4 absolute and relative: the two
frameworks sum the convolutions and BatchNorms in other orders (float32).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jresnet

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import resnet as tresnet

TOL = 1e-4
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
IMAGE = (3, 40, 40)


def _resnet18(lib):
    return lib.get_symbol(10, 18, IMAGE)


def _bottleneck_1111(lib):
    return lib.resnet(units=[1, 1, 1, 1], num_stages=4,
                      filter_list=[64, 256, 512, 1024, 2048],
                      num_classes=10, image_shape=list(IMAGE),
                      bottle_neck=True)


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL, err_msg=name)


@pytest.mark.parametrize("build", [_resnet18, _bottleneck_1111],
                         ids=["resnet18", "bottleneck_1111"])
def test_imagenet_branch_step_matches_jax(build):
    rs = np.random.RandomState(0)
    X = rs.rand(2, *IMAGE).astype(np.float32)
    y = np.asarray([3, 7], np.float32)
    with mx.name.NameManager():     # auto-names count from 0 in both
        jsym = build(jresnet)
    jit = mx.io.NDArrayIter(X, y, batch_size=2)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(jit.provide_data, jit.provide_label)
    jmod.init_params(mx.initializer.Xavier())
    args0, auxs0 = ({k: v.asnumpy() for k, v in d.items()}
                    for d in jmod.get_params())
    jmod.fit(jit, num_epoch=1, optimizer_params=SGD)
    assert jmod._fused_armed

    cpu = mxt.cpu()
    with mxt.name.NameManager():
        tsym = build(tresnet)
    assert tsym.tojson() == jsym.tojson()
    tmod = mxt.mod.Module(tsym, context=cpu)
    tmod.fit(mxt.io.NDArrayIter(X, y, batch_size=2), num_epoch=1,
             arg_params=mxt.convert.params_from_numpy(args0, cpu),
             aux_params=mxt.convert.params_from_numpy(auxs0, cpu),
             optimizer_params=SGD)

    jargs, jauxs = jmod.get_params()
    targs, tauxs = tmod.get_params()
    assert sorted(jargs) == sorted(targs)
    for k in jargs:
        _close(jargs[k].asnumpy(), targs[k].asnumpy(), k)
    for k in jauxs:
        _close(jauxs[k].asnumpy(), tauxs[k].asnumpy(), k)
    tstates = mxt.convert.optimizer_states_to_numpy(tmod)
    for k, mom in jmod._exec_group.export_fused_states().items():
        _close(mom, tstates[k], k)
