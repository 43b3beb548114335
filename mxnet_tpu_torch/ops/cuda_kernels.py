"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py`` (and of
``rtc.py``'s flash-attention kernel). Twelve kernels, each a CUDA C++
source under ``mxnet_tpu_torch/csrc/``:

=========================  ==================================================  ===================
wrapper                    replaces (mxnet_tpu/ops/pallas_kernels.py)          source
=========================  ==================================================  ===================
``embedding``              ``_emb_gather_kernel`` (``_pl_embedding``)          embedding.cu
``layernorm``              ``_ln_fwd_kernel`` (``_pl_layernorm_fwd``)          layernorm.cu
``bias_gelu``              ``_bias_gelu_kernel`` (``_pl_bias_gelu``)           bias_gelu.cu
``decode_attention``       ``_decode_attn_kernel``                             decode_attention.cu
``softmax``                ``_softmax_fwd_kernel`` (``_pl_softmax``)           softmax.cu
``softmax_ce_bwd``         ``_softmax_ce_bwd_kernel``                          softmax_ce_bwd.cu
``sgd_mom_update``         ``_sgd_mom_kernel`` (``_tiled_elementwise``)        sgd_mom.cu
``adam_update``            ``_adam_kernel`` (``_tiled_elementwise``)           adam.cu
``layernorm_bwd_dx``       ``_ln_bwd_dx_kernel`` (``_ln_pl_bwd_rule``)         ln_bwd_dx.cu
``layernorm_bwd_dparams``  ``_ln_bwd_dparams_kernel`` (``_ln_pl_bwd_rule``)    ln_bwd_dparams.cu
``bias_gelu_dx``           ``_bias_gelu_dx_kernel`` (``_bias_gelu_bwd_rule``)  bias_gelu_dx.cu
``flash_attention``        ``_flash_kernel`` of ``mxnet_tpu/rtc.py``           flash_attention.cu
``qfc_matmul``             ``_qfc_kernel`` of ``mxnet_tpu/ops/quant.py``       qfc_matmul.cu
``dequant_rows``           ``_dequant_rows_kernel`` of ``ops/quant.py``        dequant_rows.cu
=========================  ==================================================  ===================

The first four serve the decode path; with the ones from
``layernorm_bwd_dx`` to ``flash_attention`` they train the transformer LM;
softmax / cross-entropy and the optimizer updates serve every training
path; the last two serve the quantized tiers (``QuantizedFullyConnected``
and ``QuantizedConvolution``), each with one C entry point per weight
storage type (int8, float8_e4m3fn). Each source carries a note on what
bounds it on the card and what its design does about that. Beside each wrapper sits its
plain PyTorch version (``*_plain``), which computes the same function the
way the TPU kernel does; the CPU tests hold it against the JAX package,
and ``chip_smoke.py`` holds the kernel against it on the card.

Gradients: the ``"cuda"`` variants of ``LayerNorm``, ``FusedBiasGeLU``
and ``Embedding`` (and ``attention``'s, in ``rtc.py``) are
``torch.autograd.Function``s. LayerNorm's backward is the two backward
kernels (the statistic outputs' cotangents count as zero, as in the JAX
rule); FusedBiasGeLU's is ``bias_gelu_dx`` plus a plain column sum for
the bias, as the JAX package leaves that sum to XLA; Embedding's is a
plain float32 ``index_add_`` of ``ct * scale`` (``embedding_bwd_plain``),
the counterpart of ``_emb_bwd_rule``, which is no kernel in the JAX
package either.

Dispatch is by device and nothing else: a wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel (building it
first if needed) or raises — a build failure, a launch failure and an
input the kernel does not take all raise, and nothing gives way to the
plain version. Every wrapper counts its launches in a plain integer
attribute (``embedding.launches`` ...), incremented where it launches and
nowhere else. The optimizer wrappers update the weight and state tensors
in place on both devices.

Build: at first use, one ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` per source, all started together, into
``build/kernels/`` at the root of the checkout; each library exposes
plain C functions that return ``cudaGetLastError()`` and are bound with
``ctypes``. Libraries are named by a hash of their source, so an edited
source rebuilds and an unchanged one is reused. ``libraries_loaded()``
counts the libraries this process has built or loaded: eager PyTorch has
no programs to compile, so it is the serving engine's counterpart of the
JAX package's compile count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..base import MXNetError, parse_bool, parse_float
from .loss import softmax_ce_grad, softmax_output, softmax_rows
from .nn import _INV_SQRT2, _convolution as nn_convolution, \
    bias_gelu as nn_bias_gelu
from .optimizer_op import adam_step, sgd_mom_step
from .quant import dequantize, qfc_matmul_plain
from .registry import get_op
from .tensor import embedding_lookup

__all__ = ["build", "embedding", "embedding_plain", "layernorm",
           "layernorm_plain", "fused_layernorm", "bias_gelu",
           "bias_gelu_plain", "decode_attention", "decode_attention_plain",
           "softmax", "softmax_plain", "softmax_ce_bwd",
           "softmax_ce_bwd_plain", "sgd_mom_update", "sgd_mom_update_plain",
           "adam_update", "adam_update_plain", "layernorm_bwd_dx",
           "layernorm_bwd_dx_plain", "layernorm_bwd_dparams",
           "layernorm_bwd_dparams_plain", "bias_gelu_dx",
           "bias_gelu_dx_plain", "flash_attention", "flash_attention_plain",
           "embedding_bwd_plain", "layernorm_fn", "bias_gelu_fn",
           "embedding_fn", "qfc_matmul", "qfc_matmul_plain", "dequant_rows",
           "dequant_rows_plain", "launch_counts", "reset_launch_counts",
           "libraries_loaded", "KERNELS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

#: kernel name -> (source file, C symbol or {weight storage: C symbol},
#: ctypes argtypes)
_SPECS = {
    "embedding": ("embedding.cu", "mx_embedding_f32",
                  [_P, _P, _P, _I, _I, _I, _F, _P]),
    "layernorm": ("layernorm.cu", "mx_layernorm_fwd_f32",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]),
    "bias_gelu": ("bias_gelu.cu", "mx_bias_gelu_f32",
                  [_P, _P, _P, _I, _I, _P]),
    "decode_attention": ("decode_attention.cu", "mx_decode_attention_f32",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "softmax": ("softmax.cu", "mx_softmax_f32", [_P, _P, _I, _I, _P]),
    "softmax_ce_bwd": ("softmax_ce_bwd.cu", "mx_softmax_ce_bwd_f32",
                       [_P, _P, _P, _I, _I, _F, _I, _F, _P]),
    "sgd_mom": ("sgd_mom.cu", "mx_sgd_mom_f32",
                [_P, _P, _P, _L, _F, _F, _F, _F, _F, _P]),
    "adam": ("adam.cu", "mx_adam_f32",
             [_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P]),
    "ln_bwd_dx": ("ln_bwd_dx.cu", "mx_ln_bwd_dx_f32",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
    "ln_bwd_dparams": ("ln_bwd_dparams.cu", "mx_ln_bwd_dparams_f32",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "bias_gelu_dx": ("bias_gelu_dx.cu", "mx_bias_gelu_dx_f32",
                     [_P, _P, _P, _P, _I, _I, _P]),
    "flash_attention": ("flash_attention.cu", "mx_flash_attention_f32",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]),
    "qfc_matmul": ("qfc_matmul.cu", {"int8": "mx_qfc_matmul_i8_f32",
                                     "e4m3": "mx_qfc_matmul_e4m3_f32"},
                   [_P, _P, _P, _P, _I, _I, _I, _P]),
    "dequant_rows": ("dequant_rows.cu",
                     {"int8": "mx_dequant_rows_i8_f32",
                      "e4m3": "mx_dequant_rows_e4m3_f32"},
                     [_P, _P, _P, _I, _I, _P]),
}
KERNELS = tuple(_SPECS)

_lock = threading.Lock()
_libs = {}             # kernel name -> loaded library
_fns = {}              # (kernel name, C symbol) -> bound ctypes function
build_log = {}         # kernel name -> nvcc's stderr (ptxas register report)


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME): the port's CUDA "
                     "kernels are built from source at first use")


def _lib_path(name):
    src = _CSRC / _SPECS[name][0]
    digest = hashlib.sha256(src.read_bytes() + _ARCH.encode()).hexdigest()
    return _BUILD_DIR / f"libmx_{name}_{digest[:12]}.so"


def build(names=KERNELS):
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all running at once; raise with the compiler's
    output if any fails. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(_CSRC / _SPECS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _fn(name, storage=None):
    """The bound C entry point of one kernel (the one for ``storage``
    where the kernel has one per weight storage type), building and
    loading its library on first use."""
    sym = _SPECS[name][1] if storage is None else _SPECS[name][1][storage]
    fn = _fns.get((name, sym))
    if fn is not None:
        return fn
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        if (name, sym) not in _fns:
            fn = getattr(_libs[name], sym)
            fn.argtypes = _SPECS[name][2]
            fn.restype = ctypes.c_int
            _fns[(name, sym)] = fn
    return _fns[(name, sym)]


def libraries_loaded():
    """How many kernel libraries this process has built or loaded."""
    return len(_libs)


def _launch(name, tensor, *args, storage=None):
    """Launch one kernel on the current stream of ``tensor``'s device and
    raise on a refused launch."""
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        err = _fn(name, storage)(*args, stream)
    if err != 0:
        raise MXNetError(f"CUDA kernel {name!r} launch failed: cudaError "
                         f"{err}")


def _check(name, **tensors):
    """The inputs a kernel takes: float32 (int32 where named), contiguous,
    all on one CUDA device. Anything else raises."""
    dev = None
    for key, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise MXNetError(f"{name}: {key} is on {t.device}, the kernel "
                             "needs a CUDA tensor")
        if dev is not None and t.device != dev:
            raise MXNetError(f"{name}: inputs span {dev} and {t.device}")
        dev = t.device
        if t.dtype != dtype:
            raise MXNetError(f"{name}: {key} is {t.dtype}, the kernel "
                             f"takes {dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: {key} must be contiguous")


def _cpu_or_cuda(name, t):
    """True for CUDA, False for CPU; raise for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise MXNetError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def launch_counts():
    """{kernel name: launches so far}."""
    return {n: _WRAPPERS[n].launches for n in KERNELS}


def reset_launch_counts():
    for n in KERNELS:
        _WRAPPERS[n].launches = 0


# ==========================================================================
# 1. embedding gather (+ scale)
# ==========================================================================
#: out[i] = W[ids[i]] * scale, the scale applied in float32; an id in
#: [-V, 0) counts from the end, any other out-of-range id gives a NaN row
#: (the Embedding op's own definition, shared)
embedding_plain = embedding_lookup


def embedding(ids, weight, scale=1.0):
    """Gather rows ``ids`` (N,) int32 of ``weight`` (V, D) float32, times
    ``scale`` -> (N, D)."""
    if not _cpu_or_cuda("embedding", weight):
        return embedding_plain(ids, weight, scale)
    _check("embedding", ids=(ids, torch.int32),
           weight=(weight, torch.float32))
    if weight.ndim != 2 or ids.ndim != 1:
        raise MXNetError(f"embedding: want ids (N,) and weight (V, D), got "
                         f"{tuple(ids.shape)} and {tuple(weight.shape)}")
    n, (v, d) = ids.shape[0], weight.shape
    out = torch.empty((n, d), dtype=weight.dtype, device=weight.device)
    _launch("embedding", weight, ids.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n, v, d, float(scale))
    embedding.launches += 1
    return out


embedding.launches = 0


def embedding_bwd_plain(ids, ct, num_rows, scale=1.0):
    """The weight gradient of ``embedding``: ``ct * scale`` (float32)
    added into zeros (num_rows, D) at the rows ``ids`` (N,) read, the ids
    in [-V, 0) counted from the end and every other out-of-range id
    dropped, as ``_emb_bwd_rule``'s scatter-add does. Its order of
    addition is ``index_add_``'s."""
    ct32 = ct.reshape(ids.shape[0], -1).to(torch.float32)
    if scale != 1.0:
        ct32 = ct32 * scale
    idx = ids.to(torch.int64)
    idx = torch.where(idx < 0, idx + num_rows, idx)
    valid = (idx >= 0) & (idx < num_rows)
    ct32 = torch.where(valid[:, None], ct32, torch.zeros((), device=ct.device))
    dw = torch.zeros((num_rows, ct32.shape[1]), dtype=torch.float32,
                     device=ct.device)
    return dw.index_add_(0, idx.clamp(0, num_rows - 1), ct32)


class _EmbeddingFn(torch.autograd.Function):
    """Forward: the gather kernel. Backward: ``embedding_bwd_plain`` for
    the weight; the ids get no gradient."""

    @staticmethod
    def forward(ctx, ids, weight, scale):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.scale, ctx.dtype = weight.shape[0], scale, weight.dtype
        return embedding(ids, weight, scale)

    @staticmethod
    def backward(ctx, ct):
        ids, = ctx.saved_tensors
        dw = embedding_bwd_plain(ids, ct, ctx.rows, ctx.scale)
        return None, dw.to(ctx.dtype), None


def embedding_fn(ids, weight, scale=1.0):
    """Differentiable ``embedding``: ids (N,) int32, weight (V, D)."""
    return _EmbeddingFn.apply(ids, weight, float(scale))


def _embedding_cuda(attrs, inputs, aux, is_train, rng):
    data, weight = inputs
    # token ids arrive int32 (the decode drivers and SyntheticLMIter feed
    # int32); PyTorch indexes in int64, the kernel in int32
    ids = data.reshape(-1).to(weight.device, torch.int32).contiguous()
    out = embedding_fn(ids, weight, parse_float(attrs.get("scale", 1.0)))
    return [out.reshape(tuple(data.shape) + (weight.shape[1],))], []


# ==========================================================================
# 2. LayerNorm forward
# ==========================================================================
def layernorm_plain(x2, gamma, beta, eps):
    """Two-pass float32 statistics over the last axis of x2 (N, C):
    returns (y (N, C), mean (N,), rstd (N,))."""
    x = x2.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    d = x - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = d * rstd * gamma.to(torch.float32) + beta.to(torch.float32)
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def layernorm(x2, gamma, beta, eps):
    """LayerNorm of x2 (N, C) float32 -> (y, mean (N,), rstd (N,))."""
    if not _cpu_or_cuda("layernorm", x2):
        return layernorm_plain(x2, gamma, beta, eps)
    _check("layernorm", x=(x2, torch.float32), gamma=(gamma, torch.float32),
           beta=(beta, torch.float32))
    n, c = x2.shape
    if gamma.shape != (c,) or beta.shape != (c,):
        raise MXNetError(f"layernorm: gamma/beta must be ({c},)")
    y = torch.empty_like(x2)
    mean = torch.empty((n,), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2.device)
    _launch("layernorm", x2, x2.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            n, c, float(eps))
    layernorm.launches += 1
    return y, mean, rstd


layernorm.launches = 0


class _LayerNormFn(torch.autograd.Function):
    """Forward: the LayerNorm kernel, which saves mean and rstd.
    Backward: ``layernorm_bwd_dx`` and ``layernorm_bwd_dparams``; the
    cotangents of the statistic outputs count as zero (they are marked
    non-differentiable), as in ``_ln_pl_bwd_rule``."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layernorm(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, gy, _gmean, _grstd):
        x2, gamma, mean, rstd = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dg = db = None
        if ctx.needs_input_grad[0]:
            dx = layernorm_bwd_dx(x2, gamma, gy, mean, rstd)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dg, db = layernorm_bwd_dparams(x2, gy, mean, rstd)
        return dx, dg, db, None


def layernorm_fn(x2, gamma, beta, eps):
    """Differentiable ``layernorm``: (y, mean, rstd) of x2 (N, C)."""
    return _LayerNormFn.apply(x2, gamma, beta, float(eps))


def fused_layernorm(data, gamma, beta, eps=1e-5):
    """The LayerNorm op's contract over the last axis: ``(out, mean,
    std)`` with mean/std shaped ``data.shape[:-1]`` and std = 1/rstd."""
    c = data.shape[-1]
    y, mean, rstd = layernorm_fn(data.reshape(-1, c).contiguous(), gamma,
                                 beta, eps)
    lead = data.shape[:-1]
    return y.reshape(data.shape), mean.reshape(lead), \
        (1.0 / rstd).reshape(lead)


def _layernorm_cuda(attrs, inputs, aux, is_train, rng):
    data, gamma, beta = inputs
    axis = int(attrs.get("axis", -1))
    if axis not in (-1, data.ndim - 1):
        raise MXNetError(f"LayerNorm: the CUDA kernel normalizes the last "
                         f"axis, got axis={axis}")
    y, mean, std = fused_layernorm(data, gamma, beta,
                                   parse_float(attrs.get("eps", 1e-5)))
    return [y, mean, std], []


# ==========================================================================
# 3. bias + GeLU epilogue
# ==========================================================================
#: 0.5 z (1 + erf(z / sqrt 2)) with z = x + bias, in float32 (the
#: FusedBiasGeLU op's own definition, shared)
bias_gelu_plain = nn_bias_gelu


def bias_gelu(x2, bias):
    """Bias + exact GeLU over x2 (N, C) float32 with bias (C,)."""
    if not _cpu_or_cuda("bias_gelu", x2):
        return bias_gelu_plain(x2, bias)
    _check("bias_gelu", x=(x2, torch.float32), bias=(bias, torch.float32))
    n, c = x2.shape
    if bias.shape != (c,):
        raise MXNetError(f"bias_gelu: bias must be ({c},)")
    y = torch.empty_like(x2)
    _launch("bias_gelu", x2, x2.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, c)
    bias_gelu.launches += 1
    return y


bias_gelu.launches = 0


class _BiasGeLUFn(torch.autograd.Function):
    """Forward: the bias + GeLU kernel. Backward: ``bias_gelu_dx``, and
    the bias gradient as the plain column sum of dx (the JAX package
    leaves that reduction to XLA)."""

    @staticmethod
    def forward(ctx, x2, bias):
        ctx.save_for_backward(x2, bias)
        return bias_gelu(x2, bias)

    @staticmethod
    def backward(ctx, gy):
        x2, bias = ctx.saved_tensors
        dx = bias_gelu_dx(x2, bias, gy.contiguous())
        db = torch.sum(dx, 0) if ctx.needs_input_grad[1] else None
        return (dx if ctx.needs_input_grad[0] else None), db


def bias_gelu_fn(x2, bias):
    """Differentiable ``bias_gelu`` over x2 (N, C)."""
    return _BiasGeLUFn.apply(x2, bias)


def _bias_gelu_cuda(attrs, inputs, aux, is_train, rng):
    data, bias = inputs
    c = data.shape[-1]
    y = bias_gelu_fn(data.reshape(-1, c).contiguous(), bias)
    return [y.reshape(data.shape)], []


# ==========================================================================
# 4. flash-decode attention read
# ==========================================================================
def decode_attention_plain(q, k_cache, v_cache, pos):
    """Attention of q (B, H, S, Dh) over the cache prefix each row sees:
    key k_pos is live for query s of row b iff k_pos <= pos[b] + s. The
    query is scaled by Dh^-1/2 before the product, as in the TPU kernel.
    Returns float32 (B, H, S, Dh)."""
    B, H, S, Dh = q.shape
    C = k_cache.shape[2]
    qs = q.to(torch.float32) * (float(Dh) ** -0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k_cache.to(torch.float32))
    q_pos = pos.to(torch.int64)[:, None] + torch.arange(S, device=q.device)
    k_pos = torch.arange(C, device=q.device)
    live = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # B,1,S,C
    s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p / p.sum(dim=-1, keepdim=True),
                        v_cache.to(torch.float32))


def decode_attention(q, k_cache, v_cache, pos):
    """Cursor-bounded flash-decode read: q (B, H, S, Dh), caches
    (B, H, C, Dh) with this step's rows already written, pos (B,) int32
    per-row cursors -> float32 (B, H, S, Dh). The kernel takes float32,
    Dh in {64, 128} and S <= 64."""
    if not _cpu_or_cuda("decode_attention", q):
        return decode_attention_plain(q, k_cache, v_cache, pos)
    _check("decode_attention", q=(q, torch.float32),
           k_cache=(k_cache, torch.float32),
           v_cache=(v_cache, torch.float32), pos=(pos, torch.int32))
    B, H, S, Dh = q.shape
    C = k_cache.shape[2]
    if Dh not in (64, 128):
        raise MXNetError(f"decode_attention: head dim {Dh} — the kernel "
                         "takes 64 or 128")
    if S > 64:
        raise MXNetError(f"decode_attention: window S={S} > 64")
    if tuple(k_cache.shape) != (B, H, C, Dh) or \
            tuple(v_cache.shape) != (B, H, C, Dh) or \
            tuple(pos.shape) != (B,):
        raise MXNetError("decode_attention: want caches (B, H, C, Dh) and "
                         f"pos (B,), got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}, {tuple(pos.shape)}")
    out = torch.empty((B, H, S, Dh), dtype=torch.float32, device=q.device)
    _launch("decode_attention", q, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, S, C,
            Dh, float(Dh) ** -0.5)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

# ==========================================================================
# 5. row softmax (SoftmaxOutput forward)
# ==========================================================================
#: e = exp(x - max), e / sum(e) per row, float32 (the SoftmaxOutput op's
#: own row function, shared)
softmax_plain = softmax_rows

#: the JAX package's eligibility bound for its softmax kernel
SOFTMAX_MAX_C = 65536


def softmax(x2):
    """Row softmax of x2 (N, C) float32, C <= 65536 -> (N, C)."""
    if not _cpu_or_cuda("softmax", x2):
        return softmax_plain(x2)
    _check("softmax", x=(x2, torch.float32))
    if x2.ndim != 2 or x2.shape[1] > SOFTMAX_MAX_C:
        raise MXNetError(f"softmax: want (N, C) with C <= {SOFTMAX_MAX_C}, "
                         f"got {tuple(x2.shape)}")
    n, c = x2.shape
    y = torch.empty_like(x2)
    _launch("softmax", x2, x2.data_ptr(), y.data_ptr(), n, c)
    softmax.launches += 1
    return y


softmax.launches = 0


# ==========================================================================
# 6. softmax cross-entropy gradient (SoftmaxOutput backward)
# ==========================================================================
#: (p - onehot(int(label))) * keep * scale (the op's own row function)
softmax_ce_bwd_plain = softmax_ce_grad


def softmax_ce_bwd(prob2, label, scale, use_ignore=False, ignore_label=-1.0):
    """Cross-entropy gradient over prob2 (N, C) float32 with label (N,)
    float32 -> (N, C)."""
    if not _cpu_or_cuda("softmax_ce_bwd", prob2):
        return softmax_ce_bwd_plain(prob2, label, scale, use_ignore,
                                    ignore_label)
    _check("softmax_ce_bwd", prob=(prob2, torch.float32),
           label=(label, torch.float32))
    if prob2.ndim != 2 or tuple(label.shape) != (prob2.shape[0],):
        raise MXNetError(f"softmax_ce_bwd: want prob (N, C) and label (N,),"
                         f" got {tuple(prob2.shape)} and "
                         f"{tuple(label.shape)}")
    n, c = prob2.shape
    g = torch.empty_like(prob2)
    _launch("softmax_ce_bwd", prob2, prob2.data_ptr(), label.data_ptr(),
            g.data_ptr(), n, c, float(scale), int(bool(use_ignore)),
            float(ignore_label))
    softmax_ce_bwd.launches += 1
    return g


softmax_ce_bwd.launches = 0


# ==========================================================================
# 7. SGD with momentum (in place)
# ==========================================================================
#: functional (w', m') = the sgd_mom_update op's plain forward
sgd_mom_update_plain = sgd_mom_step


def _check_same(name, **tensors):
    _check(name, **{k: (t, torch.float32) for k, t in tensors.items()})
    shapes = {tuple(t.shape) for t in tensors.values()}
    if len(shapes) != 1:
        raise MXNetError(f"{name}: operands differ in shape: {shapes}")


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0, rescale=1.0,
                   clip=-1.0):
    """In place on ``weight`` and ``mom`` (same shape, float32):
    ``mom = momentum * mom - lr * (clip(rescale * grad) + wd * weight)``,
    ``weight += mom``. ``clip <= 0`` means no clip. Returns (weight,
    mom)."""
    if not _cpu_or_cuda("sgd_mom_update", weight):
        new_w, new_m = sgd_mom_update_plain(weight, grad, mom, lr, momentum,
                                            wd, rescale, clip)
        weight.copy_(new_w)
        mom.copy_(new_m)
        return weight, mom
    _check_same("sgd_mom_update", weight=weight, grad=grad, mom=mom)
    _launch("sgd_mom", weight, weight.data_ptr(), grad.data_ptr(),
            mom.data_ptr(), weight.numel(), float(lr), float(momentum),
            float(wd), float(rescale), float(clip))
    sgd_mom_update.launches += 1
    return weight, mom


sgd_mom_update.launches = 0


# ==========================================================================
# 8. Adam (in place)
# ==========================================================================
#: functional (w', mean', var') = the adam_update op's plain forward
adam_update_plain = adam_step


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale=1.0, clip=-1.0):
    """In place on ``weight``, ``mean`` and ``var`` (same shape,
    float32): the Adam moments and ``weight -= lr * mean / (sqrt(var) +
    epsilon)``. Returns (weight, mean, var)."""
    if not _cpu_or_cuda("adam_update", weight):
        for dst, src in zip((weight, mean, var), adam_update_plain(
                weight, grad, mean, var, lr, beta1, beta2, epsilon, wd,
                rescale, clip)):
            dst.copy_(src)
        return weight, mean, var
    _check_same("adam_update", weight=weight, grad=grad, mean=mean, var=var)
    _launch("adam", weight, weight.data_ptr(), grad.data_ptr(),
            mean.data_ptr(), var.data_ptr(), weight.numel(), float(lr),
            float(beta1), float(1 - beta1), float(beta2), float(1 - beta2),
            float(epsilon), float(wd), float(rescale), float(clip))
    adam_update.launches += 1
    return weight, mean, var


adam_update.launches = 0


# ==========================================================================
# 9. LayerNorm backward: dx
# ==========================================================================
#: the JAX package's eligibility bound for its LayerNorm kernels
LN_MAX_C = 65536


def layernorm_bwd_dx_plain(x2, gamma, ct, mean, rstd):
    """dx of LayerNorm over x2 (N, C) from the saved mean and rstd (N,),
    in float32: ``rstd (gy - mean(gy) - xh mean(gy xh))`` with ``xh = (x
    - mean) rstd`` and ``gy = ct gamma``."""
    r = rstd.to(torch.float32)[:, None]
    xh = (x2.to(torch.float32) - mean.to(torch.float32)[:, None]) * r
    gy = ct.to(torch.float32) * gamma.to(torch.float32)
    m1 = gy.mean(dim=-1, keepdim=True)
    m2 = (gy * xh).mean(dim=-1, keepdim=True)
    return (r * (gy - m1 - xh * m2)).to(x2.dtype)


def _check_ln_bwd(name, x2, ct, mean, rstd):
    if x2.ndim != 2 or tuple(ct.shape) != tuple(x2.shape) or \
            tuple(mean.shape) != (x2.shape[0],) or \
            tuple(rstd.shape) != (x2.shape[0],):
        raise MXNetError(f"{name}: want x, ct (N, C) and mean, rstd (N,), "
                         f"got {tuple(x2.shape)}, {tuple(ct.shape)}, "
                         f"{tuple(mean.shape)}, {tuple(rstd.shape)}")
    if x2.shape[1] > LN_MAX_C:
        raise MXNetError(f"{name}: C={x2.shape[1]} > {LN_MAX_C}")


def layernorm_bwd_dx(x2, gamma, ct, mean, rstd):
    """LayerNorm's input gradient: x2, ct (N, C), gamma (C,), mean, rstd
    (N,), float32, C <= 65536 -> dx (N, C)."""
    if not _cpu_or_cuda("layernorm_bwd_dx", x2):
        return layernorm_bwd_dx_plain(x2, gamma, ct, mean, rstd)
    _check("layernorm_bwd_dx", x=(x2, torch.float32),
           gamma=(gamma, torch.float32), ct=(ct, torch.float32),
           mean=(mean, torch.float32), rstd=(rstd, torch.float32))
    _check_ln_bwd("layernorm_bwd_dx", x2, ct, mean, rstd)
    n, c = x2.shape
    if tuple(gamma.shape) != (c,):
        raise MXNetError(f"layernorm_bwd_dx: gamma must be ({c},)")
    dx = torch.empty_like(x2)
    _launch("ln_bwd_dx", x2, x2.data_ptr(), gamma.data_ptr(), ct.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), n, c)
    layernorm_bwd_dx.launches += 1
    return dx


layernorm_bwd_dx.launches = 0


# ==========================================================================
# 10. LayerNorm backward: dgamma, dbeta
# ==========================================================================
def layernorm_bwd_dparams_plain(x2, ct, mean, rstd):
    """(dgamma, dbeta), each (C,) float32, summed over the rows of x2 and
    ct (N, C): ``sum(ct xh)`` and ``sum(ct)``."""
    xh = (x2.to(torch.float32) - mean.to(torch.float32)[:, None]) * \
        rstd.to(torch.float32)[:, None]
    c32 = ct.to(torch.float32)
    return (c32 * xh).sum(dim=0), c32.sum(dim=0)


def _dparams_chunks(n):
    """(rows per chunk, chunks) of the kernel's first stage: 64-row
    chunks, larger (a multiple of 8) when N needs more than 65535."""
    rows = max(64, -(-n // 65535))
    rows = -(-rows // 8) * 8
    return rows, max(1, -(-n // rows))


def layernorm_bwd_dparams(x2, ct, mean, rstd):
    """LayerNorm's parameter gradients over x2, ct (N, C) with mean, rstd
    (N,), float32, C <= 65536 -> (dgamma, dbeta) (C,). A deterministic
    two-stage reduction: one call, one launch count."""
    if not _cpu_or_cuda("layernorm_bwd_dparams", x2):
        return layernorm_bwd_dparams_plain(x2, ct, mean, rstd)
    _check("layernorm_bwd_dparams", x=(x2, torch.float32),
           ct=(ct, torch.float32), mean=(mean, torch.float32),
           rstd=(rstd, torch.float32))
    _check_ln_bwd("layernorm_bwd_dparams", x2, ct, mean, rstd)
    n, c = x2.shape
    rows, chunks = _dparams_chunks(n)
    part = torch.empty((2, chunks, c), dtype=torch.float32, device=x2.device)
    dg = torch.empty((c,), dtype=torch.float32, device=x2.device)
    db = torch.empty((c,), dtype=torch.float32, device=x2.device)
    _launch("ln_bwd_dparams", x2, x2.data_ptr(), ct.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), dg.data_ptr(), db.data_ptr(), n, c, rows,
            chunks)
    layernorm_bwd_dparams.launches += 1
    return dg, db


layernorm_bwd_dparams.launches = 0


# ==========================================================================
# 11. bias + GeLU backward: dx
# ==========================================================================
_INV_SQRT2PI = 0.3989422804014327


def bias_gelu_dx_plain(x2, bias, ct):
    """``ct (0.5 (1 + erf(z / sqrt 2)) + z phi(z))`` with z = x2 + bias,
    in float32, with the TPU kernel's constants."""
    z = x2.to(torch.float32) + bias.to(torch.float32)
    phi = torch.exp(-0.5 * z * z) * _INV_SQRT2PI
    dgelu = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) + z * phi
    return (ct.to(torch.float32) * dgelu).to(x2.dtype)


def bias_gelu_dx(x2, bias, ct):
    """The bias + GeLU input gradient over x2, ct (N, C) float32 with
    bias (C,) -> dx (N, C)."""
    if not _cpu_or_cuda("bias_gelu_dx", x2):
        return bias_gelu_dx_plain(x2, bias, ct)
    _check("bias_gelu_dx", x=(x2, torch.float32),
           bias=(bias, torch.float32), ct=(ct, torch.float32))
    if x2.ndim != 2 or tuple(ct.shape) != tuple(x2.shape) or \
            tuple(bias.shape) != (x2.shape[1],):
        raise MXNetError(f"bias_gelu_dx: want x, ct (N, C) and bias (C,), "
                         f"got {tuple(x2.shape)}, {tuple(ct.shape)}, "
                         f"{tuple(bias.shape)}")
    n, c = x2.shape
    dx = torch.empty_like(x2)
    _launch("bias_gelu_dx", x2, x2.data_ptr(), bias.data_ptr(),
            ct.data_ptr(), dx.data_ptr(), n, c)
    bias_gelu_dx.launches += 1
    return dx


bias_gelu_dx.launches = 0


# ==========================================================================
# 12. flash-attention forward
# ==========================================================================
def flash_attention_plain(q, k, v, causal=False):
    """Softmax attention of q over k, v (B, H, T, Dh) as the flash kernel
    computes it: q scaled by Dh^-1/2 BEFORE the product, float32 scores
    and softmax, the causal mask keeping key <= query. Returns float32
    (B, H, T, Dh)."""
    qs = q.to(torch.float32) * (float(q.shape[-1]) ** -0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.to(torch.float32))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        live = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~live, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.to(torch.float32))


def flash_attention(q, k, v, causal=False):
    """Self-attention of q, k, v (B, H, T, Dh) float32 -> (B, H, T, Dh).
    The kernel takes Dh in {64, 128}, any T, and Tq == Tk only."""
    if not _cpu_or_cuda("flash_attention", q):
        return flash_attention_plain(q, k, v, causal)
    _check("flash_attention", q=(q, torch.float32), k=(k, torch.float32),
           v=(v, torch.float32))
    if q.ndim != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise MXNetError("flash_attention: self-attention only, want q, k, "
                         f"v (B, H, T, Dh) alike (Tq == Tk), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, Dh = q.shape
    if Dh not in (64, 128):
        raise MXNetError(f"flash_attention: head dim {Dh} — the kernel "
                         "takes 64 or 128")
    if B * H > 65535:
        raise MXNetError(f"flash_attention: B*H={B * H} > 65535")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise MXNetError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    _launch("flash_attention", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B * H, T, Dh, int(bool(causal)),
            float(Dh) ** -0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ==========================================================================
# 13. dequant-fused dense matmul (QuantizedFullyConnected)
# 14. per-row weight dequant (QuantizedConvolution)
# ==========================================================================
#: float(wq2[o, c]) * scale[o] over rows (O, cols), in float32 (the
#: quantized ops' own dequant, shared)
dequant_rows_plain = dequantize

#: weight storage dtype -> the kernels' C entry point suffix
_QUANT_STORAGE = {torch.int8: "int8", torch.float8_e4m3fn: "e4m3"}


def _check_quant(name, wq, **tensors):
    """A narrow weight (int8 or float8_e4m3fn) plus the float32 tensors,
    contiguous, on one CUDA device; returns the storage key."""
    storage = _QUANT_STORAGE.get(wq.dtype)
    if storage is None:
        raise MXNetError(f"{name}: weight is {wq.dtype}, the kernel takes "
                         "torch.int8 or torch.float8_e4m3fn")
    _check(name, weight=(wq, wq.dtype),
           **{k: (t, torch.float32) for k, t in tensors.items()})
    return storage


def qfc_matmul(x2, wq, scale):
    """``x2 @ (wq * scale[:, None]).T``: x2 (M, K) float32, wq (N, K)
    int8 or float8_e4m3fn, scale (N,) float32 -> (M, N) float32, each
    weight scaled before the product."""
    if not _cpu_or_cuda("qfc_matmul", x2):
        return qfc_matmul_plain(x2, wq, scale)
    storage = _check_quant("qfc_matmul", wq, x=x2, scale=scale)
    if x2.ndim != 2 or wq.ndim != 2 or wq.shape[1] != x2.shape[1] or \
            tuple(scale.shape) != (wq.shape[0],):
        raise MXNetError(f"qfc_matmul: want x (M, K), weight (N, K) and "
                         f"scale (N,), got {tuple(x2.shape)}, "
                         f"{tuple(wq.shape)}, {tuple(scale.shape)}")
    (m, k), n = x2.shape, wq.shape[0]
    if m > 64 * 65535:
        raise MXNetError(f"qfc_matmul: M={m} > {64 * 65535}")
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    _launch("qfc_matmul", x2, x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, n, k, storage=storage)
    qfc_matmul.launches += 1
    return out


qfc_matmul.launches = 0


def dequant_rows(wq2, scale):
    """``float(wq2[o, c]) * scale[o]``: wq2 (O, cols) int8 or
    float8_e4m3fn, scale (O,) float32 -> (O, cols) float32, bit for bit
    the plain version's."""
    if not _cpu_or_cuda("dequant_rows", wq2):
        return dequant_rows_plain(wq2, scale)
    storage = _check_quant("dequant_rows", wq2, scale=scale)
    if wq2.ndim != 2 or tuple(scale.shape) != (wq2.shape[0],):
        raise MXNetError(f"dequant_rows: want weight (O, cols) and scale "
                         f"(O,), got {tuple(wq2.shape)}, "
                         f"{tuple(scale.shape)}")
    rows, cols = wq2.shape
    out = torch.empty((rows, cols), dtype=torch.float32, device=wq2.device)
    _launch("dequant_rows", wq2, wq2.data_ptr(), scale.data_ptr(),
            out.data_ptr(), rows, cols, storage=storage)
    dequant_rows.launches += 1
    return out


dequant_rows.launches = 0

_WRAPPERS = {"embedding": embedding, "layernorm": layernorm,
             "bias_gelu": bias_gelu, "decode_attention": decode_attention,
             "softmax": softmax, "softmax_ce_bwd": softmax_ce_bwd,
             "sgd_mom": sgd_mom_update, "adam": adam_update,
             "ln_bwd_dx": layernorm_bwd_dx,
             "ln_bwd_dparams": layernorm_bwd_dparams,
             "bias_gelu_dx": bias_gelu_dx,
             "flash_attention": flash_attention, "qfc_matmul": qfc_matmul,
             "dequant_rows": dequant_rows}


# ==========================================================================
# the "cuda" variants of the ops these kernels serve (attention_decode's
# and attention's variants live with the ops, in rtc.py)
# ==========================================================================
def _softmax_output_cuda(attrs, inputs, aux, is_train, rng):
    """SoftmaxOutput on the card: the softmax kernel forward, the
    cross-entropy kernel backward (an autograd.Function, so the variant
    trains). Labels go to the kernel as float32, as the TPU path casts
    them."""
    data, label = inputs
    if parse_bool(attrs.get("multi_output", False)):
        raise MXNetError("SoftmaxOutput(multi_output=True): no CUDA kernel "
                         "takes the per-position softmax yet; run it on "
                         "mx.cpu()")
    return [softmax_output(data, label.to(torch.float32).contiguous(),
                           attrs, softmax=softmax,
                           ce_grad=softmax_ce_bwd)], []


def _sgd_mom_cuda(attrs, inputs, aux, is_train, rng):
    w, g, m = inputs
    return list(sgd_mom_update(
        w, g, m, attrs["lr"], attrs.get("momentum", 0.0),
        attrs.get("wd", 0.0), attrs.get("rescale_grad", 1.0),
        attrs.get("clip_gradient", -1.0))), []


def _adam_cuda(attrs, inputs, aux, is_train, rng):
    w, g, mean, var = inputs
    return list(adam_update(
        w, g, mean, var, attrs["lr"], attrs.get("beta1", 0.9),
        attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-8),
        attrs.get("wd", 0.0), attrs.get("rescale_grad", 1.0),
        attrs.get("clip_gradient", -1.0))), []


def _float32_data(op, data):
    if data.dtype != torch.float32:
        raise MXNetError(f"{op}: the CUDA kernels take float32 data, got "
                         f"{data.dtype}")


def _qfc_cuda(attrs, inputs, aux, is_train, rng):
    """QuantizedFullyConnected on the card: the dequant-fused matmul
    kernel, then the bias add (after the kernel, as in the JAX package's
    Pallas variant)."""
    data, weight, scale = inputs[:3]
    _float32_data("QuantizedFullyConnected", data)
    if data.ndim > 2 and parse_bool(attrs.get("flatten", True)):
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    out = qfc_matmul(data.reshape(-1, data.shape[-1]).contiguous(), weight,
                     scale)
    if len(inputs) > 3:
        out = out + inputs[3].to(torch.float32)
    return [out.reshape(tuple(lead) + (weight.shape[0],))], []


def _qconv_cuda(attrs, inputs, aux, is_train, rng):
    """QuantizedConvolution on the card: the row-dequant kernel rebuilds
    the float32 weight, then cuDNN convolves (the convolution stays a
    library call, as it stays XLA's in the JAX package)."""
    data, weight, scale = inputs[:3]
    _float32_data("QuantizedConvolution", data)
    wf = dequant_rows(weight.reshape(weight.shape[0], -1), scale)
    return [nn_convolution(attrs, data, wf.reshape(weight.shape),
                           inputs[3] if len(inputs) > 3 else None)], []


_UPDATE_BWD = ("a gradient of the update itself, which the JAX package "
               "takes through its composition")
_QUANT_BWD = ("a gradient of a quantized op: quantized graphs are an "
              "inference tier, which the JAX package gives no gradient "
              "either")
get_op("FusedBiasGeLU").add_variant("cuda", _bias_gelu_cuda)
get_op("Embedding").add_variant("cuda", _embedding_cuda)
get_op("LayerNorm").add_variant("cuda", _layernorm_cuda)
get_op("SoftmaxOutput").add_variant("cuda", _softmax_output_cuda)
get_op("sgd_mom_update").add_variant("cuda", _sgd_mom_cuda,
                                     backward_pending=_UPDATE_BWD)
get_op("adam_update").add_variant("cuda", _adam_cuda,
                                  backward_pending=_UPDATE_BWD)
get_op("QuantizedFullyConnected").add_variant("cuda", _qfc_cuda,
                                              backward_pending=_QUANT_BWD)
get_op("QuantizedConvolution").add_variant("cuda", _qconv_cuda,
                                           backward_pending=_QUANT_BWD)
