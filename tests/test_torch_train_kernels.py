"""The training kernels' plain versions against the JAX package.

The four CUDA kernels of the training path — row softmax, the softmax
cross-entropy gradient, SGD-momentum and Adam — each have a plain
PyTorch version in ``mxnet_tpu_torch.ops.cuda_kernels``, which is what a
CPU tensor runs. Each is held here against the JAX package's Pallas
kernel (interpret mode, as the JAX package's own tests run it off-TPU)
and against the JAX composition the kernel replaces, on the same
numpy-seeded inputs. Tolerance: float32 2e-5 (the frameworks sum and
round in other orders; Adam's ``(1 - b2) g^2`` is grouped differently in
the JAX composition than in its kernel).

Also here: the dispatch rule that a CUDA variant without a backward
refuses inputs that require grad (the decode attention and the update
ops), and that the differentiable variants take them, reached directly on
the CPU.
The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.loss import softmax_output
from mxnet_tpu_torch.ops.registry import refuse_without_backward

TOL = 2e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------- softmax
@pytest.mark.parametrize("shape", [(32, 1000), (5, 3), (4, 1), (1, 7),
                                   (2, 4096)])
def test_softmax_plain_matches_pallas_and_composition(shape):
    rs = np.random.RandomState(0)
    x = (4 * rs.randn(*shape)).astype(np.float32)
    ref = pk._pl_softmax(jnp.asarray(x))
    comp = jax.nn.softmax(jnp.asarray(x), axis=-1)
    got = ck.softmax_plain(_t(x))
    _close(ref, got)
    _close(comp, got)


# --------------------------------------------- softmax cross-entropy grad
_HEAD_ATTRS = [
    {},
    {"normalization": "batch", "grad_scale": 2.0},
    {"normalization": "valid", "use_ignore": True, "ignore_label": -1.0},
    {"normalization": "valid"},
    {"use_ignore": True, "ignore_label": 3.0, "grad_scale": 0.5},
    {"normalization": "batch", "use_ignore": True, "ignore_label": 0.0},
]


def _head_inputs(n=6, c=5, seed=1):
    rs = np.random.RandomState(seed)
    x = (2 * rs.randn(n, c)).astype(np.float32)
    # in range, ignored (-1, 3, 0 under the attrs above), and past C
    label = np.asarray([0, 3, -1, c, 2, 4][:n], np.float32)
    head = rs.randn(n, c).astype(np.float32)      # ignored by the head
    return x, label, head


def _torch_head_grad(x, label, attrs, **fns):
    data = _t(x).requires_grad_(True)
    prob = softmax_output(data, _t(label), attrs, **fns)
    prob.backward(torch.ones_like(prob) * 7)       # head grad is ignored
    return prob.detach().numpy(), data.grad.numpy()


@pytest.mark.parametrize("kwargs", _HEAD_ATTRS)
def test_softmax_ce_grad_plain_matches_pallas(kwargs):
    x, label, head = _head_inputs()
    attrs = jax_op("SoftmaxOutput").normalize_attrs(kwargs)
    prob, vjp = jax.vjp(lambda d: pk.fused_softmax_ce(d, jnp.asarray(label),
                                                      **attrs),
                        jnp.asarray(x))
    grad, = vjp(jnp.asarray(head))
    tattrs = mxt.ops.get_op("SoftmaxOutput").normalize_attrs(kwargs)
    tprob, tgrad = _torch_head_grad(x, label, tattrs,
                                    softmax=ck.softmax_plain,
                                    ce_grad=ck.softmax_ce_bwd_plain)
    _close(prob, tprob)
    _close(grad, tgrad)


@pytest.mark.parametrize("kwargs", _HEAD_ATTRS)
def test_softmax_ce_grad_plain_matches_composition(kwargs):
    x, label, head = _head_inputs(seed=2)
    jop = jax_op("SoftmaxOutput")
    attrs = jop.normalize_attrs(kwargs)

    def f(d):
        (out,), _ = jop.forward(attrs, [d, jnp.asarray(label)], [], True,
                                None)
        return out
    prob, vjp = jax.vjp(f, jnp.asarray(x))
    grad, = vjp(jnp.asarray(head))
    tprob, tgrad = _torch_head_grad(
        x, label, mxt.ops.get_op("SoftmaxOutput").normalize_attrs(kwargs))
    _close(prob, tprob)
    _close(grad, tgrad)


def test_softmax_ce_grad_direct_call_matches_pallas_kernel():
    """The row function alone, with a label outside [0, C): that row is
    p * scale (the iota compare matches nothing)."""
    rs = np.random.RandomState(3)
    p = rs.rand(4, 6).astype(np.float32)
    label = np.asarray([1, 6, -3, 5], np.float32)
    got = ck.softmax_ce_bwd_plain(_t(p), _t(label), 0.25)
    want = p.copy()
    want[0, 1] -= 1
    want[3, 5] -= 1
    _close(want * 0.25, got)


# --------------------------------------------------------- SGD-momentum
_SGD_CASES = [
    dict(lr=0.1, momentum=0.9, wd=1e-4, rescale=1 / 32, clip=-1.0),
    dict(lr=0.05, momentum=0.0, wd=0.0, rescale=1.0, clip=-1.0),
    dict(lr=0.1, momentum=0.9, wd=1e-3, rescale=0.5, clip=0.3),
]


@pytest.mark.parametrize("shape", [(7, 13), (64, 3, 3, 3), (1000,)])
@pytest.mark.parametrize("hp", _SGD_CASES)
def test_sgd_mom_plain_matches_pallas_and_composition(shape, hp):
    rs = np.random.RandomState(4)
    w, g, m = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    clip = hp["clip"] if hp["clip"] > 0 else None
    ref = pk.pallas_sgd_mom_update(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), hp["lr"],
        hp["momentum"], hp["wd"], hp["rescale"], clip)
    jop = jax_op("sgd_mom_update")
    comp, _ = jop.forward(jop.normalize_attrs(dict(
        lr=hp["lr"], momentum=hp["momentum"], wd=hp["wd"],
        rescale_grad=hp["rescale"], clip_gradient=hp["clip"])),
        [jnp.asarray(a) for a in (w, g, m)], [], False, None)
    got = ck.sgd_mom_update_plain(_t(w), _t(g), _t(m), **hp)
    for r, c, t in zip(ref, comp, got):
        _close(r, t)
        _close(c, t)


# ------------------------------------------------------------------ Adam
_ADAM_CASES = [
    dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
         rescale=1 / 8, clip=-1.0),
    dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6, wd=1e-2,
         rescale=1.0, clip=0.5),
]


@pytest.mark.parametrize("shape", [(7, 13), (128, 64)])
@pytest.mark.parametrize("hp", _ADAM_CASES)
def test_adam_plain_matches_pallas_and_composition(shape, hp):
    rs = np.random.RandomState(5)
    w, g, mean = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    var = rs.rand(*shape).astype(np.float32)
    clip = hp["clip"] if hp["clip"] > 0 else None
    ref = pk.pallas_adam_update(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(mean), jnp.asarray(var),
        hp["lr"], hp["beta1"], hp["beta2"], hp["epsilon"], hp["wd"],
        hp["rescale"], clip)
    jop = jax_op("adam_update")
    comp, _ = jop.forward(jop.normalize_attrs(dict(
        lr=hp["lr"], beta1=hp["beta1"], beta2=hp["beta2"],
        epsilon=hp["epsilon"], wd=hp["wd"], rescale_grad=hp["rescale"],
        clip_gradient=hp["clip"])),
        [jnp.asarray(a) for a in (w, g, mean, var)], [], False, None)
    got = ck.adam_update_plain(_t(w), _t(g), _t(mean), _t(var), **hp)
    for r, c, t in zip(ref, comp, got):
        _close(r, t)
        _close(c, t)


# --------------------------------------------------------- wrapper rules
def test_training_wrappers_on_cpu_update_in_place_and_count_nothing():
    ck.reset_launch_counts()
    rs = np.random.RandomState(6)
    w, g, m, v = (_t(rs.rand(5, 3).astype(np.float32)) for _ in range(4))
    w0 = w.clone()
    want = ck.sgd_mom_update_plain(w0, g, m.clone(), 0.1, 0.9)
    out = ck.sgd_mom_update(w, g, m, 0.1, 0.9)
    assert out[0] is w and out[1] is m
    torch.testing.assert_close(w, want[0], rtol=0, atol=0)
    ck.adam_update(w, g, m, v, 1e-3)
    x = _t(rs.randn(4, 10).astype(np.float32))
    p = ck.softmax(x)
    ck.softmax_ce_bwd(p, _t(np.arange(4, dtype=np.float32)), 1.0)
    assert ck.launch_counts() == {n: 0 for n in ck.KERNELS}


def test_training_ops_carry_cuda_variants():
    for name in ("SoftmaxOutput", "sgd_mom_update", "adam_update",
                 "pallas_sgd_mom_update"):
        assert "cuda" in mxt.ops.get_op(name).variants, name
    for name in ("sgd_update", "Convolution", "BatchNorm", "Pooling",
                 "Activation", "Flatten"):
        assert not mxt.ops.get_op(name).variants, name


# ------------------------------------------- variants without a backward
@pytest.mark.parametrize("name,kernel", [
    ("attention_decode", "decode-attention backward"),
    ("sgd_mom_update", "gradient of the update"),
    ("adam_update", "gradient of the update"),
    ("pallas_sgd_mom_update", "gradient of the update")])
def test_variant_without_backward_refuses_grad(name, kernel):
    """The check dispatch makes before a CUDA variant runs: an input that
    requires grad, with autograd recording, raises and names the backward
    kernel still to be ported; without grad the variant may run."""
    op = mxt.ops.get_op(name)
    variant = op.variants["cuda"]
    x = torch.randn(2, 8, requires_grad=True)
    with pytest.raises(MXNetError, match=kernel):
        refuse_without_backward(op, variant, [x, torch.randn(8)])
    refuse_without_backward(op, variant, [x.detach(), torch.randn(8)])
    with torch.no_grad():
        refuse_without_backward(op, variant, [x, torch.randn(8)])


@pytest.mark.parametrize("name", ["SoftmaxOutput", "LayerNorm",
                                  "FusedBiasGeLU", "Embedding", "attention",
                                  "pallas_flash_attention"])
def test_differentiable_variant_takes_grad(name):
    """The CUDA variants whose backward is in place (a kernel, or the
    JAX package's own plain rule) run on inputs that require grad."""
    op = mxt.ops.get_op(name)
    assert not op.variants["cuda"]["backward_pending"]
    refuse_without_backward(op, op.variants["cuda"],
                            [torch.randn(2, 8, requires_grad=True),
                             torch.randn(8, requires_grad=True)])


def test_pallas_sgd_mom_update_op_is_functional():
    """The explicit op name returns new arrays and leaves its inputs, on
    the plain path as the CUDA variant (which updates copies)."""
    rs = np.random.RandomState(7)
    w, g, m = (rs.randn(9).astype(np.float32) for _ in range(3))
    with mxt.cpu():
        nw, nm = mxt.nd.pallas_sgd_mom_update(
            mxt.nd.array(w), mxt.nd.array(g), mxt.nd.array(m), lr=0.1,
            momentum=0.9, wd=1e-4, clip_gradient=0.5)
    ref = pk.pallas_sgd_mom_update(jnp.asarray(w), jnp.asarray(g),
                                   jnp.asarray(m), 0.1, 0.9, 1e-4, 1.0, 0.5)
    _close(ref[0], nw.asnumpy())
    _close(ref[1], nm.asnumpy())
