"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py``. Eight
kernels, each a CUDA C++ source under ``mxnet_tpu_torch/csrc/``:

====================  =============================================  ===================
wrapper               replaces (mxnet_tpu/ops/pallas_kernels.py)     source
====================  =============================================  ===================
``embedding``         ``_emb_gather_kernel`` (``_pl_embedding``)     embedding.cu
``layernorm``         ``_ln_fwd_kernel`` (``_pl_layernorm_fwd``)     layernorm.cu
``bias_gelu``         ``_bias_gelu_kernel`` (``_pl_bias_gelu``)      bias_gelu.cu
``decode_attention``  ``_decode_attn_kernel``                        decode_attention.cu
``softmax``           ``_softmax_fwd_kernel`` (``_pl_softmax``)      softmax.cu
``softmax_ce_bwd``    ``_softmax_ce_bwd_kernel``                     softmax_ce_bwd.cu
``sgd_mom_update``    ``_sgd_mom_kernel`` (``_tiled_elementwise``)   sgd_mom.cu
``adam_update``       ``_adam_kernel`` (``_tiled_elementwise``)      adam.cu
====================  =============================================  ===================

The first four serve the decode path, the last four the training path
(the SoftmaxOutput head and the optimizer updates). Each source carries a
note on what bounds it on the card and what its design does about that.
Beside each wrapper sits its plain PyTorch version (``*_plain``), which
computes the same function the way the TPU kernel does; the CPU tests
hold it against the JAX package, and ``chip_smoke.py`` holds the kernel
against it on the card.

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
``build/kernels/`` at the root of the checkout; each library exposes a
plain C function that returns ``cudaGetLastError()`` and is bound with
``ctypes``. Libraries are named by a hash of their source, so an edited
source rebuilds and an unchanged one is reused.
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
from .nn import bias_gelu as nn_bias_gelu
from .optimizer_op import adam_step, sgd_mom_step
from .registry import get_op
from .tensor import embedding_lookup

__all__ = ["build", "embedding", "embedding_plain", "layernorm",
           "layernorm_plain", "fused_layernorm", "bias_gelu",
           "bias_gelu_plain", "decode_attention", "decode_attention_plain",
           "softmax", "softmax_plain", "softmax_ce_bwd",
           "softmax_ce_bwd_plain", "sgd_mom_update", "sgd_mom_update_plain",
           "adam_update", "adam_update_plain", "launch_counts",
           "reset_launch_counts", "KERNELS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

#: kernel name -> (source file, C symbol, ctypes argtypes)
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
}
KERNELS = tuple(_SPECS)

_lock = threading.Lock()
_fns = {}              # kernel name -> bound ctypes function
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


def _fn(name):
    """The bound C entry point of one kernel, building it on first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, _SPECS[name][1])
            fn.argtypes = _SPECS[name][2]
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return _fns[name]


def _launch(name, tensor, *args):
    """Launch one kernel on the current stream of ``tensor``'s device and
    raise on a refused launch."""
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        err = _fn(name)(*args, stream)
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


def _embedding_cuda(attrs, inputs, aux, is_train, rng):
    data, weight = inputs
    # token ids arrive int32 (the decode drivers feed int32); PyTorch
    # indexes in int64, the kernel in int32
    ids = data.reshape(-1).to(torch.int32).contiguous()
    out = embedding(ids, weight, parse_float(attrs.get("scale", 1.0)))
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


def fused_layernorm(data, gamma, beta, eps=1e-5):
    """The LayerNorm op's contract over the last axis: ``(out, mean,
    std)`` with mean/std shaped ``data.shape[:-1]`` and std = 1/rstd."""
    c = data.shape[-1]
    y, mean, rstd = layernorm(data.reshape(-1, c).contiguous(), gamma,
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


def _bias_gelu_cuda(attrs, inputs, aux, is_train, rng):
    data, bias = inputs
    c = data.shape[-1]
    y = bias_gelu(data.reshape(-1, c).contiguous(), bias)
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

_WRAPPERS = {"embedding": embedding, "layernorm": layernorm,
             "bias_gelu": bias_gelu, "decode_attention": decode_attention,
             "softmax": softmax, "softmax_ce_bwd": softmax_ce_bwd,
             "sgd_mom": sgd_mom_update, "adam": adam_update}


# ==========================================================================
# the "cuda" variants of the ops these kernels serve (attention_decode's
# variant lives with the op, in rtc.py)
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


_LN_BWD = ("the LayerNorm backward kernels _ln_bwd_dx_kernel and "
           "_ln_bwd_dparams_kernel, mxnet_tpu/ops/pallas_kernels.py:600 and "
           ":612")
_UPDATE_BWD = ("a gradient of the update itself, which the JAX package "
               "takes through its composition")
get_op("FusedBiasGeLU").add_variant(
    "cuda", _bias_gelu_cuda,
    backward_pending="the GeLU backward kernel _bias_gelu_dx_kernel, "
                     "mxnet_tpu/ops/pallas_kernels.py:751")
get_op("Embedding").add_variant(
    "cuda", _embedding_cuda,
    backward_pending="the embedding gradient, a scatter-add the JAX "
                     "package takes through its composition")
get_op("LayerNorm").add_variant("cuda", _layernorm_cuda,
                                backward_pending=_LN_BWD)
get_op("SoftmaxOutput").add_variant("cuda", _softmax_output_cuda)
get_op("sgd_mom_update").add_variant("cuda", _sgd_mom_cuda,
                                     backward_pending=_UPDATE_BWD)
get_op("adam_update").add_variant("cuda", _adam_cuda,
                                  backward_pending=_UPDATE_BWD)
