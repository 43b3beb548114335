"""User kernels: the PyTorch port's ``mx.rtc`` against the JAX package's
(CPU).

The JAX package registers a user op from a Pallas kernel
(``register_pallas_op``, interpret mode on the CPU); the port from CUDA
source (``register_cuda_op``), which runs only on the card, and its plain
``reference``, which CPU tensors run. The same ops as
``tests/test_rtc.py`` — ``scaled_sub`` (two inputs, an attr) and
``sq_scale`` (with a VJP kernel) — go through both packages on the same
numpy-seeded inputs: the imperative forward, the ``relu(scaled_sub)``
executor graph, and ``sq_scale``'s gradient through an executor, at
1e-6. Then the port's refusals: ``Rtc`` and an op without a reference
raise on the CPU, ``push``'s count and shape errors read as the JAX
package's, and the generated signature carries the names and types in
order (float32, bfloat16, int32; any other dtype raises).
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

TOL = 1e-6
RS = np.random.RandomState(2)
A = RS.rand(16, 128).astype(np.float32)
B = RS.rand(16, 128).astype(np.float32)
X = RS.rand(8, 128).astype(np.float32) + 0.2


def _register():
    if "tt_scaled_sub" not in mxj.sym.__dict__:
        mxj.rtc.register_pallas_op(
            "tt_scaled_sub",
            kernel=lambda attrs: (
                lambda a_ref, b_ref, o_ref: o_ref.__setitem__(
                    ..., a_ref[...] - float(attrs.get("scale", 1.0)) *
                    b_ref[...])),
            out_shapes=lambda attrs, shapes: [(shapes[0], None)],
            inputs=("a", "b"), attr_spec={"scale": (float, 1.0)})

        def fwd_kernel(attrs):
            s = float(attrs.get("scale", 1.0))

            def k(x_ref, o_ref):
                o_ref[...] = s * x_ref[...] * x_ref[...]
            return k

        def bwd_kernel(attrs):
            s = float(attrs.get("scale", 1.0))

            def k(x_ref, ct_ref, gx_ref):
                gx_ref[...] = 2.0 * s * x_ref[...] * ct_ref[...]
            return k

        mxj.rtc.register_pallas_op(
            "tt_sq_scale", kernel=fwd_kernel,
            out_shapes=lambda attrs, shapes: [(shapes[0], None)],
            inputs=("data",), vjp_kernel=bwd_kernel,
            attr_spec={"scale": (float, 1.0)})
        mxj.sym._init_symbol_module(mxj.sym.__dict__)
        from mxnet_tpu import _op_gen
        _op_gen.init_ndarray_module(mxj.nd.__dict__)
    if "tt_scaled_sub" not in mxt.sym.__dict__:
        grid_stride = ("for (long long i = blockIdx.x * (long long)blockDim.x"
                       " + threadIdx.x; i < n; i += (long long)gridDim.x * "
                       "blockDim.x)\n")
        mxt.rtc.register_cuda_op(
            "tt_scaled_sub",
            kernel=lambda attrs: grid_stride +
            f"    out[i] = a[i] - {float(attrs.get('scale', 1.0))!r}f * b[i];",
            out_shapes=lambda attrs, shapes: [(shapes[0], None)],
            inputs=("a", "b"), attr_spec={"scale": (float, 1.0)},
            reference=lambda attrs, a, b: a - attrs.get("scale", 1.0) * b)
        mxt.rtc.register_cuda_op(
            "tt_sq_scale",
            kernel=lambda attrs: grid_stride +
            f"    out[i] = {float(attrs.get('scale', 1.0))!r}f * data[i] "
            "* data[i];",
            vjp_kernel=lambda attrs: grid_stride +
            f"    grad_data[i] = 2.0f * {float(attrs.get('scale', 1.0))!r}f"
            " * data[i] * ct[i];",
            out_shapes=lambda attrs, shapes: [(shapes[0], None)],
            inputs=("data",), attr_spec={"scale": (float, 1.0)},
            reference=lambda attrs, x: attrs.get("scale", 1.0) * x * x)
        mxt.rtc.register_cuda_op(
            "tt_no_plain", kernel=lambda attrs: "out[0] = data[0];",
            out_shapes=lambda attrs, shapes: [(shapes[0], None)])


_register()


def _arr(pkg, x):
    return pkg.nd.array(x, ctx=pkg.cpu())


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL)


def test_registered_op_forward():
    outs = [pkg.nd.tt_scaled_sub(_arr(pkg, A), _arr(pkg, B),
                                 scale=3.0).asnumpy() for pkg in (mxj, mxt)]
    _close(outs[1], outs[0])
    _close(outs[1], A - 3.0 * B)


def test_registered_op_in_an_executor_graph():
    def run(pkg):
        sym = pkg.sym.relu(pkg.sym.tt_scaled_sub(
            pkg.sym.var("a"), pkg.sym.var("b"), scale=3.0))
        assert sym.infer_shape(a=A.shape, b=B.shape)[1] == [A.shape]
        exe = sym.bind(pkg.cpu(), args={"a": _arr(pkg, A),
                                        "b": _arr(pkg, B)}, grad_req="null")
        exe.forward(is_train=False)
        return exe.outputs[0].asnumpy()
    got_j, got_t = run(mxj), run(mxt)
    _close(got_t, got_j)
    _close(got_t, np.maximum(A - 3.0 * B, 0))


def test_registered_op_gradient():
    """The JAX package differentiates through its VJP kernel (interpret
    mode); the port on the CPU through its reference."""
    head = RS.rand(*X.shape).astype(np.float32)

    def run(pkg):
        sym = pkg.sym.tt_sq_scale(pkg.sym.var("data"), scale=1.5)
        exe = sym.simple_bind(pkg.cpu(), grad_req="write", data=X.shape)
        exe.arg_dict["data"][:] = X
        exe.forward(is_train=True)
        exe.backward([_arr(pkg, head)])
        return exe.outputs[0].asnumpy(), exe.grad_dict["data"].asnumpy()
    (yj, gj), (yt, gt) = run(mxj), run(mxt)
    _close(yt, yj)
    _close(gt, gj)
    _close(gt, 3.0 * X * head)


def test_refusals_on_the_cpu():
    x = _arr(mxt, A)
    rtc = mxt.rtc.Rtc("tt_axpb", [("x", x), ("y", x)], [("out", x)],
                      "out[0] = x[0] + y[0];")
    with pytest.raises(mxt.MXNetError, match="CUDA tensors only"):
        rtc.push([x, x], [x])
    with pytest.raises(mxt.MXNetError, match="no plain version"):
        mxt.nd.tt_no_plain(x)
    # the op's kernel variant refuses CPU tensors too
    variant = mxt.ops.get_op("tt_scaled_sub").variants["cuda"]["fn"]
    with pytest.raises(mxt.MXNetError, match="CUDA tensors only"):
        variant({"scale": 1.0}, [x.astorch(), x.astorch()], [], False, None)


def test_missing_nvrtc_is_named(monkeypatch, tmp_path):
    """User kernels compile with NVRTC alone: without libnvrtc the build
    raises and says so, and writes nothing."""
    from mxnet_tpu_torch.ops import cuda_kernels
    monkeypatch.setattr(mxt.rtc, "_nvrtc", lambda: None)
    monkeypatch.setattr(cuda_kernels, "_BUILD_DIR", tmp_path / "kernels")
    src = mxt.rtc.kernel_source("tt_probe", [], "", False)
    with pytest.raises(mxt.MXNetError, match="NVRTC.*libnvrtc.so"):
        mxt.rtc._cubin("tt_probe", src)
    assert not (tmp_path / "kernels").exists()


def test_cost_counts_declared_output_width():
    """The accounting counts a user op's inputs at 4 B an element and
    each output at its declared dtype's width (input 0's, 4 B, when
    none is declared)."""
    import torch
    if "tt_to_bf16" not in mxt.sym.__dict__:
        mxt.rtc.register_cuda_op(
            "tt_to_bf16", kernel=lambda attrs: "",
            out_shapes=lambda attrs, shapes: [(shapes[0], "bfloat16")],
            reference=lambda attrs, x: x.to(torch.bfloat16))
    n = A.size
    assert mxt.ops.get_op("tt_scaled_sub").cost({}, [A.shape] * 2) == \
        (0.0, 12.0 * n)
    assert mxt.ops.get_op("tt_to_bf16").cost({}, [A.shape]) == \
        (0.0, 6.0 * n)
    assert mxt.nd.tt_to_bf16(_arr(mxt, A)).astorch().dtype == torch.bfloat16


def test_op_without_vjp_kernel_refuses_grad_on_the_card():
    variant = mxt.ops.get_op("tt_no_plain").variants["cuda"]
    assert "vjp_kernel" in variant["backward_pending"]
    assert mxt.ops.get_op("tt_sq_scale").variants["cuda"][
        "backward_pending"] is None


def test_push_errors_read_as_the_jax_package():
    def errors(pkg, kernel):
        x = pkg.nd.array(A, ctx=pkg.cpu())
        y = pkg.nd.array(B, ctx=pkg.cpu())
        out = pkg.nd.array(A, ctx=pkg.cpu())
        small = pkg.nd.array(A[:4], ctx=pkg.cpu())
        rtc = pkg.rtc.Rtc("tt_axpb", [("x", x), ("y", y)], [("out", out)],
                          kernel)
        got = []
        for ins, outs in (([x], [out]), ([x, y], []), ([x, small], [out]),
                          ([x, y], [small])):
            with pytest.raises(pkg.MXNetError) as e:
                rtc.push(ins, outs)
            got.append(str(e.value))
        return got

    def pallas_axpb(x_ref, y_ref, o_ref):
        o_ref[...] = 2.0 * x_ref[...] + y_ref[...]

    want = errors(mxj, pallas_axpb)
    got = errors(mxt, "out[0] = x[0];")
    assert got == want
    assert got[0] == "tt_axpb: expected 2 inputs"


def test_generated_signature():
    x = _arr(mxt, A)
    out = _arr(mxt, B)
    rtc = mxt.rtc.Rtc("axpb", [("x", x), ("y", x)], [("out", out)],
                      "    out[0] = 2.0f * x[0] + y[0];")
    assert rtc.source == (
        'extern "C" __global__ void axpb(const float* x, const float* y, '
        'float* out)\n{\n    out[0] = 2.0f * x[0] + y[0];\n}\n')
    import torch
    src = mxt.rtc.kernel_source(
        "mixed", [("h", torch.bfloat16, True), ("idx", torch.int32, True),
                  ("o", torch.bfloat16, False)], "", True)
    assert src.startswith("#include <cuda_bf16.h>\n")
    assert 'extern "C" __global__ void mixed(const __nv_bfloat16* h, ' \
        'const int* idx, __nv_bfloat16* o, long long n)' in src
    with pytest.raises(mxt.MXNetError, match="float32, bfloat16 or int32"):
        mxt.rtc.kernel_source("bad", [("d", torch.float64, True)], "", True)
    with pytest.raises(mxt.MXNetError, match="float32, bfloat16 or int32"):
        mxt.rtc.Rtc("bad", [("x", mxt.nd.array(np.zeros(2, np.int64),
                                                ctx=mxt.cpu()))], [], "")
