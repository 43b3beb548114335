"""Imperative autograd: the PyTorch port's ``mx.autograd`` against the JAX
package's, on the same numpy-seeded inputs (CPU).

The counterparts of ``tests/test_autograd.py`` run the same code through
both packages and compare the gradients at 1e-6: ``grad_and_loss``;
``mark_variables`` + ``train_section`` + ``backward`` over NDArray
arithmetic and over the ``relu`` / ``sum`` registry ops; ``grad_req``
``add``; head gradients; a temporary freed inside the section; a second
model's backward leaving the first model's gradient cells alone; and a
branch the outputs do not reach (the JAX package skips its tape
entries, the port never differentiates it: a ``Custom`` op on it sees no
backward call). Then the port's own contract: a marked variable that
``_set`` replaces stays the leaf ``backward`` differentiates (assigned,
updated in place, stepped by an SGD loop — the JAX package follows the
variable's current value the same way), ``retain_graph``, and the
refusal of outputs no recorded op produced.

The reference's quirk: inside ``train_section`` the JAX package runs
BatchNorm with ``is_train=False`` and differentiates a replay with
``is_train=True``, so its value is the inference-mode one beside the
training-mode gradient. The port, as MXNet, takes value and gradient
from one training-mode forward: both packages' gradients agree, the
port's value is the batch-statistics forward, and the JAX package's the
moving-statistics one.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

TOL = 1e-6
PKGS = (mxj, mxt)


def _arr(pkg, x):
    return pkg.nd.array(np.asarray(x, np.float32), ctx=pkg.cpu())


def _zeros(pkg, shape):
    return pkg.nd.zeros(shape, ctx=pkg.cpu())


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL)


def _each(fn):
    """fn(package) for the JAX package, then the port."""
    return [fn(pkg) for pkg in PKGS]


def test_grad_and_loss():
    def run(pkg):
        grads, loss = pkg.autograd.grad_and_loss(
            lambda x: pkg.nd.sum(x * x))(_arr(pkg, [1.0, 2.0, 3.0]))
        return grads[0].asnumpy(), loss.asnumpy()
    (gj, lj), (gt, lt) = _each(run)
    _close(gt, gj)
    _close(lt, lj)
    _close(gt, [2.0, 4.0, 6.0])
    _close(lt, 14.0)


def test_grad_argnum_selects_arguments():
    def run(pkg):
        x = _arr(pkg, [1.0, 2.0])
        y = _arr(pkg, [3.0, -1.0])
        gy, = pkg.autograd.grad(lambda a, b: pkg.nd.sum(a * b * b),
                                argnum=1)(x, y)
        return gy.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, [6.0, -4.0])


def test_marked_backward_arithmetic():
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [1.0, 2.0]), _zeros(pkg, (2,))
        ag.mark_variables(x, gx)
        with ag.train_section():
            y = x * x + 3.0 * x
        ag.backward(y)
        return gx.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, [5.0, 7.0])


def test_marked_backward_registry_ops():
    xv = np.random.RandomState(0).rand(3, 4).astype(np.float32)

    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, xv), _zeros(pkg, (3, 4))
        ag.mark_variables(x, gx)
        with ag.train_section():
            z = pkg.nd.sum(pkg.nd.relu(x - 0.5))
        ag.backward(z)
        return gx.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, (xv - 0.5 > 0).astype(np.float32))


def test_backward_grad_req_add():
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [2.0]), _arr(pkg, [10.0])
        ag.mark_variables(x, gx, grad_reqs="add")
        with ag.train_section():
            y = x * x
        ag.backward(y)
        return gx.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, [14.0])


@pytest.mark.parametrize("values", [[2.0, -1.0], [np.nan, 3.0]],
                         ids=["finite", "nan"])
def test_marking_again_replaces_cell_and_request(values):
    """A second mark of the same variable replaces its cell and request
    (the marks are keyed by the variable, never by comparing arrays);
    a NaN element must not let the variable in twice."""
    def run(pkg):
        ag = pkg.autograd
        x = _arr(pkg, values)
        first, second = _zeros(pkg, (2,)), _arr(pkg, [10.0, 20.0])
        ag.mark_variables(x, first)
        ag.mark_variables(x, second, grad_reqs="add")
        with ag.train_section():
            y = x * 3.0
        ag.backward(y)
        return first.asnumpy(), second.asnumpy()
    (fj, sj), (ft, st) = _each(run)
    _close(ft, fj)
    _close(st, sj)
    _close(ft, [0.0, 0.0])
    _close(st, [13.0, 23.0])


def test_backward_with_head_grads():
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [1.0, 2.0]), _zeros(pkg, (2,))
        ag.mark_variables(x, gx)
        with ag.train_section():
            y = x * 2.0
        ag.backward(y, out_grads=_arr(pkg, [3.0, 5.0]))
        return gx.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, [6.0, 10.0])


def test_temporary_freed_in_the_section():
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [1.0, 2.0]), _zeros(pkg, (2,))
        ag.mark_variables(x, gx)
        with ag.train_section():
            t = x * 2.0
            del t
            c = _arr(pkg, [7.0, 7.0])
            y = c * x
        ag.backward(y)
        return gx.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, [7.0, 7.0])


def test_backward_does_not_clobber_unrelated_marked_grads():
    def run(pkg):
        ag = pkg.autograd
        a, ga = _arr(pkg, [3.0]), _zeros(pkg, (1,))
        ag.mark_variables(a, ga)
        with ag.train_section():
            ya = a * a
        ag.backward(ya)
        b, gb = _arr(pkg, [5.0]), _zeros(pkg, (1,))
        ag.mark_variables(b, gb)
        with ag.train_section():
            yb = b * 3.0
        ag.backward(yb)
        return ga.asnumpy(), gb.asnumpy()
    (gaj, gbj), (gat, gbt) = _each(run)
    _close(gat, gaj)
    _close(gbt, gbj)
    _close(gat, [6.0])
    _close(gbt, [3.0])


#: backward calls of the side-branch Custom op, per package
_SIDE_CALLS = {"mxnet_tpu": 0, "mxnet_tpu_torch": 0}


def _side_prop(pkg):
    class Times10(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() * 10.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            _SIDE_CALLS[pkg.__name__] += 1
            self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 10.0)

    class Times10Prop(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return Times10()
    return Times10Prop


for _pkg in PKGS:
    _pkg.operator.register("tt_ag_times10")(_side_prop(_pkg))


def test_backward_skips_unrelated_branches():
    """Only the sub-graph that feeds the requested outputs is
    differentiated: the side branch's op is never called backward and
    its leaf's gradient cell stays untouched."""
    def run(pkg):
        ag = pkg.autograd
        x, z = _arr(pkg, [1.0, 2.0]), _arr(pkg, [3.0, 4.0])
        gx, gz = _zeros(pkg, (2,)), _zeros(pkg, (2,))
        ag.mark_variables([x, z], [gx, gz])
        before = _SIDE_CALLS[pkg.__name__]
        with ag.train_section():
            y = x * x
            side = pkg.nd.Custom(z * 2.0, op_type="tt_ag_times10")
            ag.backward(y)
        assert side.shape == (2,)
        return (gx.asnumpy(), gz.asnumpy(),
                _SIDE_CALLS[pkg.__name__] - before)
    (gxj, gzj, cj), (gxt, gzt, ct) = _each(run)
    _close(gxt, gxj)
    _close(gzt, gzj)
    _close(gxt, [2.0, 4.0])
    _close(gzt, [0.0, 0.0])
    assert cj == ct == 0


def test_custom_op_inside_train_section():
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [1.0, -2.0]), _zeros(pkg, (2,))
        ag.mark_variables(x, gx)
        with ag.train_section():
            y = pkg.nd.Custom(x * x, op_type="tt_ag_times10")
        ag.backward(y)
        return y.asnumpy(), gx.asnumpy()
    (yj, gj), (yt, gt) = _each(run)
    _close(yt, yj)
    _close(gt, gj)
    _close(gt, [20.0, -40.0])


@pytest.mark.parametrize("how", ["assign", "inplace", "sgd_loop"])
def test_marked_variable_set_after_marking_stays_the_leaf(how):
    """The trap of ``NDArray._set``: a marked variable whose cell gets a
    new tensor is still what ``backward`` differentiates, at the value
    it holds when the outputs are computed from it."""
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [1.0, 2.0]), _zeros(pkg, (2,))
        ag.mark_variables(x, gx)
        steps = 3 if how == "sgd_loop" else 1
        trace = []
        for _ in range(steps):
            if how == "assign":
                x[:] = np.array([3.0, -1.0], np.float32)
            with ag.train_section():
                if how == "inplace":
                    x += 1.0
                y = x * x * x
            ag.backward(y)
            trace.append(gx.asnumpy().copy())
            if how == "sgd_loop":
                x -= 0.01 * gx            # the update, outside the section
        return np.stack(trace), x.asnumpy()
    (tj, xj), (tt, xt) = _each(run)
    _close(tt, tj)
    _close(xt, xj)


def test_retain_graph():
    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, [1.5, -2.0]), _zeros(pkg, (2,))
        ag.mark_variables(x, gx, grad_reqs="add")
        with ag.train_section():
            y = x * x
        ag.backward(y, retain_graph=True)
        ag.backward(y)
        return gx.asnumpy()
    gj, gt = _each(run)
    _close(gt, gj)
    _close(gt, [6.0, -8.0])


def test_training_state_and_refusals():
    ag = mxt.autograd
    assert not ag.is_training()
    with ag.train_section():
        assert ag.is_training()
        with ag.test_section():
            assert not ag.is_training()
        assert ag.is_training()
    assert ag.set_is_training(True) is False
    assert ag.set_is_training(False) is True
    x, gx = _arr(mxt, [1.0]), _zeros(mxt, (1,))
    ag.mark_variables(x, gx)
    y = x * 2.0                      # outside a train section: not recorded
    assert not y.astorch().requires_grad
    with pytest.raises(mxt.MXNetError, match="no recorded op"):
        ag.backward(y)
    with pytest.raises(mxt.MXNetError, match="no gradient"):
        ag.mark_variables(mxt.nd.array(np.arange(2, dtype=np.int32),
                                       ctx=mxt.cpu()), gx)


def test_batchnorm_in_train_section_is_training_mode():
    """The reference's quirk, with its numbers: both packages' gradients
    come from the training-mode forward; the port's value too, the JAX
    package's value is the inference-mode forward."""
    rs = np.random.RandomState(3)
    xv = (1.5 * rs.randn(4, 3, 2, 2) + 0.7).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, 3).astype(np.float32)
    beta = rs.randn(3).astype(np.float32)
    head = rs.randn(4, 3, 2, 2).astype(np.float32)
    eps = 1e-3

    def run(pkg):
        ag = pkg.autograd
        x, gx = _arr(pkg, xv), _zeros(pkg, xv.shape)
        mean, var = _zeros(pkg, (3,)), _arr(pkg, np.ones(3))
        ag.mark_variables(x, gx)
        with ag.train_section():
            y = pkg.nd.BatchNorm(x, _arr(pkg, gamma), _arr(pkg, beta), mean,
                                 var, eps=eps, fix_gamma=False)[0]
        ag.backward(y, out_grads=_arr(pkg, head))
        return y.asnumpy(), gx.asnumpy(), mean.asnumpy()
    (yj, gj, mj), (yt, gt, mt) = _each(run)
    g, b = gamma[None, :, None, None], beta[None, :, None, None]
    mu = xv.mean(axis=(0, 2, 3), keepdims=True)
    sd = np.sqrt(xv.var(axis=(0, 2, 3), keepdims=True) + eps)
    # 1e-5: batch statistics sum 16 terms a channel in another order
    np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt, (xv - mu) / sd * g + b, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(yj, xv / np.sqrt(1.0 + eps) * g + b,
                               rtol=1e-5, atol=1e-5)
    # the inference-mode gradient the JAX value belongs with, for scale
    eval_grad = head * g / np.sqrt(1.0 + eps)
    print(f"sum |dx|: training-mode {np.abs(gt).sum():.4f} (both "
          f"packages), inference-mode {np.abs(eval_grad).sum():.4f}; "
          f"max |value port - JAX| {np.abs(yt - yj).max():.4f}")
    assert abs(np.abs(gt).sum() - np.abs(eval_grad).sum()) > 1.0
    # the port's training-mode forward updates the moving mean; the JAX
    # package's inference-mode run leaves it
    np.testing.assert_allclose(mt, 0.1 * mu.ravel(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mj, 0.0)


def test_grad_and_loss_runs_batchnorm_in_inference_mode():
    """``grad_and_loss`` records with training off in both packages:
    BatchNorm (fix_gamma=False) over (4, 3, 5, 5) normalizes with the
    moving statistics, ones as the head. dgamma, dbeta, dx and the value
    agree with the JAX package within 1e-4, and the caller's moving mean
    and variance stay as they were."""
    rs = np.random.RandomState(5)
    xv = (1.5 * rs.randn(4, 3, 5, 5) + 0.7).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, 3).astype(np.float32)
    beta = rs.randn(3).astype(np.float32)
    mm = (0.2 * rs.randn(3)).astype(np.float32)
    mv = rs.uniform(0.5, 2.0, 3).astype(np.float32)
    eps = 1e-3

    def run(pkg):
        mean, var = _arr(pkg, mm), _arr(pkg, mv)

        def f(x, g, b):
            return pkg.nd.BatchNorm(x, g, b, mean, var, eps=eps,
                                    fix_gamma=False)[0]
        grads, y = pkg.autograd.grad_and_loss(f)(
            _arr(pkg, xv), _arr(pkg, gamma), _arr(pkg, beta))
        return ([g.asnumpy() for g in grads], y.asnumpy(), mean.asnumpy(),
                var.asnumpy())
    (gj, yj, mj, vj), (gt, yt, mt, vt) = _each(run)
    for a, b in zip(gt + [yt], gj + [yj]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    g, m, sd = (gamma[None, :, None, None], mm[None, :, None, None],
                np.sqrt(mv + eps)[None, :, None, None])
    np.testing.assert_allclose(yt, (xv - m) / sd * g
                               + beta[None, :, None, None],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt[1], ((xv - m) / sd).sum(axis=(0, 2, 3)),
                               rtol=1e-4, atol=1e-4)
    assert np.abs(gt[1]).max() > 1.0     # not the batch statistics' ~0
    for got in (mt, mj):
        np.testing.assert_array_equal(got, mm)
    for got in (vt, vj):
        np.testing.assert_array_equal(got, mv)
