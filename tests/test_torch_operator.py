"""CustomOp: the PyTorch port's ``mx.operator`` against the JAX package's,
on the same numpy-seeded inputs (CPU).

The counterparts of ``tests/test_custom_op.py``'s six tests, each run
through both packages and compared at 1e-6: a Python sigmoid
imperatively, in an executor's forward and backward, through shape
inference; the canonical custom softmax head (numpy forward, backward
``p - onehot(label)``, ``need_top_grad=False``) over ``FullyConnected``
fitted by ``Module.fit`` from the same parameters; and the legacy
``NumpyOp`` and ``NDArrayOp``. Then the plumbing the port adds: the head
gradient a ``need_top_grad=False`` op sees from ``Executor.backward``
(zeros in both packages: ``Custom`` is no loss head), ``create_operator``
called per forward and per backward, zero gradients for aux states, and
an output that aliases its input.

Each package registers its own props (the registries are separate), under
names no other test file uses.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

TOL = 1e-6
PKGS = (mxj, mxt)
#: per package: head gradients seen, operators created
SEEN = {pkg.__name__: {"heads": [], "created": 0} for pkg in PKGS}


def _register(pkg):
    op, seen = pkg.operator, SEEN[pkg.__name__]

    class Sigmoid(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], g * y * (1.0 - y))

    @op.register("tt_sigmoid")
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            seen["created"] += 1
            return Sigmoid()

    class Softmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            seen["heads"].append(out_grad[0].asnumpy().copy())
            label = in_data[1].asnumpy().astype(np.int64)
            p = out_data[0].asnumpy().copy()
            p[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], p)

    @op.register("tt_softmax")
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return Softmax()

    class ScaleByAux(op.CustomOp):
        """out = data * aux[0], out returned as the input cell itself
        when the aux is one (an output that aliases its input)."""

        def forward(self, is_train, req, in_data, out_data, aux):
            scale = float(aux[0].asnumpy()[0])
            self.assign(out_data[0], req[0],
                        in_data[0] if scale == 1.0 else
                        in_data[0].asnumpy() * scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * aux[0].asnumpy()[0])

    @op.register("tt_scale_aux")
    class ScaleProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_auxiliary_states(self):
            return ["scale"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [[1]]

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return ScaleByAux()


for _pkg in PKGS:
    _register(_pkg)


def _arr(pkg, x):
    return pkg.nd.array(np.asarray(x, np.float32), ctx=pkg.cpu())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_custom_nd():
    xv = np.array([[0.0, 1.0], [-1.0, 2.0]], np.float32)
    yj, yt = [pkg.nd.Custom(_arr(pkg, xv), op_type="tt_sigmoid").asnumpy()
              for pkg in PKGS]
    _close(yt, yj)
    _close(yt, 1.0 / (1.0 + np.exp(-xv)))


def test_custom_sym_forward_backward():
    xv = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    head = np.random.RandomState(1).rand(3, 4).astype(np.float32)

    def run(pkg):
        out = pkg.sym.Custom(pkg.sym.var("data"), op_type="tt_sigmoid",
                             name="sig")
        exe = out.simple_bind(pkg.cpu(), grad_req="write", data=(3, 4))
        exe.arg_dict["data"][:] = xv
        exe.forward(is_train=True)
        y = exe.outputs[0].asnumpy()
        exe.backward([_arr(pkg, head)])
        return y, exe.grad_dict["data"].asnumpy()
    (yj, gj), (yt, gt) = [run(pkg) for pkg in PKGS]
    _close(yt, yj)
    _close(gt, gj)
    _close(gt, head * yt * (1.0 - yt))


def test_custom_infer_shape_through_graph():
    for pkg in PKGS:
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=6,
                                     name="fc")
        net = pkg.sym.Custom(net, op_type="tt_sigmoid", name="sig")
        args, outs, _ = net.infer_shape(data=(5, 3))
        assert outs[0] == (5, 6)
        assert net.list_arguments() == ["data", "fc_weight", "fc_bias"]


def _blob(n=120, seed=42):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 2).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    return x, y


def test_custom_softmax_trains_in_module():
    """The custom softmax head over FullyConnected through Module.fit:
    the same parameters after 3 epochs of SGD in both packages, and the
    blob learned."""
    x, y = _blob()
    rs = np.random.RandomState(7)
    start = {"fc_weight": rs.uniform(-0.5, 0.5, (2, 2)).astype(np.float32),
             "fc_bias": np.zeros(2, np.float32)}

    def run(pkg):
        data = pkg.sym.var("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=2, name="fc")
        net = pkg.sym.Custom(fc, pkg.sym.var("softmax_label"),
                             op_type="tt_softmax", name="softmax")
        it = pkg.io.NDArrayIter(x, y, batch_size=20)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.fit(it, num_epoch=3, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: _arr(pkg, v) for k, v in start.items()})
        args, _ = mod.get_params()
        it.reset()
        prob = []
        for batch in it:
            mod.forward(batch, is_train=False)
            prob.append(mod.get_outputs()[0].asnumpy())
        return {k: v.asnumpy() for k, v in args.items()}, np.concatenate(prob)
    (pj, probj), (pt, probt) = [run(pkg) for pkg in PKGS]
    for k in start:
        _close(pt[k], pj[k])
        assert np.abs(pt[k] - start[k]).max() > 1e-2, k
    _close(probt, probj)
    assert ((probt.argmax(axis=1) == y).mean()) > 0.9


def test_need_top_grad_false_sees_zero_heads():
    """Executor.backward() with no head gradients seeds a Custom head
    with zeros in both packages (it is no loss head), and the op's
    backward, which ignores them, still gives p - onehot(label)."""
    rs = np.random.RandomState(5)
    xv = rs.randn(3, 5).astype(np.float32)
    lab = np.array([0, 3, 2], np.float32)
    wv = rs.randn(4, 5).astype(np.float32)

    def run(pkg):
        seen = SEEN[pkg.__name__]["heads"]
        del seen[:]
        net = pkg.sym.Custom(
            pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=4,
                                   no_bias=True, name="fc"),
            pkg.sym.var("softmax_label"), op_type="tt_softmax", name="sm")
        exe = net.simple_bind(pkg.cpu(), data=(3, 5), softmax_label=(3,))
        exe.arg_dict["data"][:] = xv
        exe.arg_dict["softmax_label"][:] = lab
        exe.arg_dict["fc_weight"][:] = wv
        exe.forward(is_train=True)
        exe.backward()
        return seen[-1], exe.grad_dict["fc_weight"].asnumpy(), \
            exe.outputs[0].asnumpy()
    (hj, gj, pj), (ht, gt, pt) = [run(pkg) for pkg in PKGS]
    _close(ht, hj)
    _close(ht, np.zeros((3, 4)))
    _close(gt, gj)
    d = pt.copy()
    d[np.arange(3), lab.astype(int)] -= 1.0
    _close(gt, d.T @ xv, 1e-5)


def test_cost_counts_output_width():
    """The accounting counts a Custom op's inputs at 4 B an element and
    each output at the width its prop's ``infer_type`` gives."""
    op = mxt.operator
    if "tt_half" not in op.get_all_registered():
        @op.register("tt_half")
        class HalfProp(op.CustomOpProp):
            def infer_type(self, in_type):
                return in_type, [np.float16], []
    cost = mxt.ops.get_op("Custom").cost
    assert cost({"op_type": "tt_sigmoid"}, [(4, 6)]) == (0.0, 8.0 * 24)
    assert cost({"op_type": "tt_half"}, [(4, 6)]) == (0.0, 6.0 * 24)


def test_operator_per_call_aux_and_aliasing():
    """``create_operator`` runs for every forward and every backward (as
    in the JAX package); an aux state gets a zero gradient; an output
    that is the input cell itself comes back as a tensor of its own."""
    xv = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    for scale in (1.0, 2.5):
        got = []
        for pkg in PKGS:
            before = SEEN[pkg.__name__]["created"]
            out = pkg.sym.Custom(pkg.sym.var("data"), op_type="tt_sigmoid")
            exe = out.simple_bind(pkg.cpu(), data=(2, 3))
            exe.arg_dict["data"][:] = xv
            exe.forward(is_train=True)
            exe.backward([_arr(pkg, np.ones((2, 3)))])
            assert SEEN[pkg.__name__]["created"] - before == 2
            net = pkg.sym.Custom(pkg.sym.var("data"), op_type="tt_scale_aux",
                                 name="s")
            exe = net.simple_bind(pkg.cpu(), data=(2, 3))
            assert net.list_auxiliary_states() == ["s_scale"]
            exe.aux_dict["s_scale"][:] = np.full(1, scale, np.float32)
            exe.arg_dict["data"][:] = xv
            exe.forward(is_train=True)
            exe.backward([_arr(pkg, np.ones((2, 3)))])
            got.append((exe.outputs[0].asnumpy(),
                        exe.grad_dict["data"].asnumpy(),
                        exe.aux_dict["s_scale"].asnumpy()))
        (yj, gj, aj), (yt, gt, at) = got
        _close(yt, yj)
        _close(gt, gj)
        _close(yt, xv * scale)
        _close(gt, np.full((2, 3), scale))
        _close(at, aj)
    # the port's autograd node: zero gradient for the aux input
    from mxnet_tpu_torch.operator import _CustomFn, _prop_for
    import torch
    x = torch.tensor(xv, requires_grad=True)
    aux = torch.full((1,), 2.0, requires_grad=True)
    y, = _CustomFn.apply(_prop_for({"op_type": "tt_scale_aux"}), True, 1, x,
                         aux)
    y.sum().backward()
    assert aux.grad is not None and float(aux.grad.abs().sum()) == 0.0


def _legacy_numpy(pkg):
    class NumpySigmoid(pkg.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]]

        def forward(self, in_data, out_data):
            out_data[0][:] = 1.0 / (1.0 + np.exp(-in_data[0]))

        def backward(self, out_grad, in_data, out_data, in_grad):
            y = out_data[0]
            in_grad[0][:] = out_grad[0] * y * (1.0 - y)
    return NumpySigmoid()


def _legacy_ndarray(pkg):
    class NdScale(pkg.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0].asnumpy() * 3.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0].asnumpy() * 3.0
    return NdScale()


@pytest.mark.parametrize("make", [_legacy_numpy, _legacy_ndarray],
                         ids=["NumpyOp", "NDArrayOp"])
def test_legacy_ops(make):
    rs = np.random.RandomState(0)
    xv = rs.randn(4, 3).astype(np.float32)
    head = rs.rand(4, 3).astype(np.float32)

    def run(pkg):
        op = make(pkg)
        exe = op(pkg.sym.var("x"), name="legacy").simple_bind(
            pkg.cpu(), x=(4, 3), grad_req="write")
        exe.arg_dict["x"][:] = xv
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward([_arr(pkg, head)])
        return out, exe.grad_dict["x"].asnumpy()
    (oj, gj), (ot, gt) = [run(pkg) for pkg in PKGS]
    _close(ot, oj)
    _close(gt, gj)
