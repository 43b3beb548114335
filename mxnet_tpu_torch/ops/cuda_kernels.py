"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py`` (and of
``rtc.py``'s flash-attention kernel), and the threefry2x32 random bits
that the JAX package draws through XLA. Twenty-one kernels, each in a
CUDA C++ source under ``mxnet_tpu_torch/csrc/`` (the flash-attention
forward and its partial mode share one source and one library, as each
update's and the conv-weight dequant's one-array and multi-tensor kernels
do, and Dropout and the uniform draws; the LayerNorm backward's three
wrappers launch one kernel, with one half off or none; the decode read is
four libraries, its tiles by cache type and its general route, which all
count as ``decode_attention``):

===========================  ==================================================  ===================
wrapper                      replaces (mxnet_tpu/ops/pallas_kernels.py)          source
===========================  ==================================================  ===================
``embedding``                ``_emb_gather_kernel`` (``_pl_embedding``)          embedding.cu
``layernorm``                ``_ln_fwd_kernel`` (``_pl_layernorm_fwd``)          layernorm.cu
``bias_gelu``                ``_bias_gelu_kernel`` (``_pl_bias_gelu``)           bias_gelu.cu
``decode_attention``         ``_decode_attn_kernel``                             decode_attention.cu
``softmax``                  ``_softmax_fwd_kernel`` (``_pl_softmax``)           softmax.cu
``softmax_ce_bwd``           ``_softmax_ce_bwd_kernel``                          softmax_ce_bwd.cu
``sgd_mom_update``           ``_sgd_mom_kernel`` (``_tiled_elementwise``)        sgd_mom.cu
``adam_update``              ``_adam_kernel`` (``_tiled_elementwise``)           adam.cu
``sgd_mom_update_multi``     ``_sgd_mom_kernel`` over a whole step's arrays      sgd_mom.cu
``adam_update_multi``        ``_adam_kernel`` over a whole step's arrays         adam.cu
``layernorm_bwd``            ``_ln_bwd_dx_kernel`` + ``_ln_bwd_dparams_kernel``  ln_bwd.cu
``layernorm_bwd_dx``         ``_ln_bwd_dx_kernel`` (``_ln_pl_bwd_rule``)         ln_bwd.cu
``layernorm_bwd_dparams``    ``_ln_bwd_dparams_kernel`` (``_ln_pl_bwd_rule``)    ln_bwd.cu
``bias_gelu_dx``             ``_bias_gelu_dx_kernel`` (``_bias_gelu_bwd_rule``)  bias_gelu_dx.cu
``flash_attention``          ``_flash_kernel`` of ``mxnet_tpu/rtc.py``           flash_attention.cu
``flash_attention_partial``  ``_flash_kernel(partial=True)`` (ring attention)    flash_attention.cu
``qfc_matmul``               ``_qfc_kernel`` of ``mxnet_tpu/ops/quant.py``       qfc_matmul.cu
``dequant_rows``             ``_dequant_rows_kernel`` of ``ops/quant.py``        dequant_rows.cu
``dequant_rows_multi``       ``_dequant_rows_kernel`` over a forward's weights   dequant_rows.cu
``bn_stats``                 ``_bn_stats_kernel`` (``_pl_channel_stats``)        bn_stats.cu
``bn_apply_relu``            ``_bn_apply_relu_kernel`` (``_pl_apply_bn_relu``)   bn_apply_relu.cu
``dropout``                  no TPU kernel: Dropout's ``jax.random.bernoulli``   threefry.cu
``uniform``                  no TPU kernel: ``jax.random.uniform`` (samplers)    threefry.cu
===========================  ==================================================  ===================

The first four serve the decode path. Each wrapper launches the instance
of its data's dtype and counts the launch under that instance's counter:
eleven kernels (``embedding`` to ``bn_apply_relu`` but the updates and
``dequant_rows``) have a float32, a bfloat16 and a float16 instance
(``compute_dtype="bfloat16"`` or ``"float16"``, the JAX package's mixed
precision), counted in ``<kernel>``, ``<wrapper>_bf16`` and
``<wrapper>_f16``; ``decode_attention`` also reads fp8 caches (one C entry
point per cache storage type, float8_e4m3fn and float8_e5m2), counted in
``decode_attention_fp8``; ``qfc_matmul`` has one entry point per weight
storage type (int8, float8_e4m3fn) for each data type. A 16-bit instance
reads its type, computes in float32 as the TPU kernel does, and stores
its type once (float32 for the statistics, for the decode read's output
and for the quantized matmul's, as the TPU kernels store them); it is
never the float32 kernel behind a cast. The 16-bit flash-attention
instances (both modes) are a design of their own on the tensor cores
(wgmma, TMA): 16-bit q and k go into the first product as stored (their
products are exact in float32), the float32 scores are scaled and take
the float32 online softmax, and P . V is p_hi . V + p_lo . V with P
split into two 16-bit terms, so no float32 value is rounded to 16 bits
before the output. The updates (``sgd_mom_update``,
``adam_update`` and their ``*_multi`` forms: one launch for up to
``MULTI_CAP`` arrays, each with its own lr and wd, the JAX package's
fused step's update; ``Module.update`` takes them) take float32 master
weights and states only, and
``dequant_rows`` (and ``dequant_rows_multi``, every conv weight of a
forward in one launch: ``QuantizedConvolution``'s per-forward prologue)
writes float32 rows from narrow weights whatever the data's type. ``flash_attention_partial`` has the three instances too,
and writes its float32 state whatever its input's type. A CUDA tensor
of a dtype no instance takes raises, naming the dtype.
With the ones from ``layernorm_bwd`` to ``flash_attention`` they
train the transformer LM, and ``flash_attention_partial`` takes the
place of ``flash_attention`` under a sequence-parallel plan (ring
attention, ``parallel/ring_attention.py``);
softmax / cross-entropy and the optimizer updates serve every training
path; ``qfc_matmul`` and ``dequant_rows`` serve the quantized tiers
(``QuantizedFullyConnected`` and ``QuantizedConvolution``), each with one
C entry point per weight storage type (int8, float8_e4m3fn); the last two
are the BatchNorm-and-ReLU half of ``FusedConvBNReLU``, in training and
inference. ``dropout`` (float32, bfloat16 and float16 instances) is the
``Dropout`` op's forward in training, mask and output in one launch under
the node's ``mx.random`` key; ``uniform`` (float32) draws the samplers'
and the initializers' values on the card, the same bits as
``mx.random``'s plain versions on the CPU, as the JAX package's. Each source carries a note on what
bounds it on the card and what its design does about that. Beside each wrapper sits its
plain PyTorch version (``*_plain``), which computes the same function the
way the TPU kernel does; the CPU tests hold it against the JAX package,
and ``chip_smoke.py`` holds the kernel against it on the card.

Gradients: the ``"cuda"`` variants of ``LayerNorm``, ``FusedBiasGeLU``
and ``Embedding`` (and ``attention``'s, in ``rtc.py``) are
``torch.autograd.Function``s. LayerNorm's backward is one
``layernorm_bwd`` launch, dx, dgamma and dbeta from one pass over x and
the cotangent (``layernorm_bwd_dx`` or ``layernorm_bwd_dparams`` when
only one half is needed; the statistic outputs' cotangents count as
zero, as in the JAX rule); FusedBiasGeLU's is ``bias_gelu_dx`` plus a
plain column sum for the bias, as the JAX package leaves that sum to
XLA; Embedding's is a
plain float32 ``index_add_`` of ``ct * scale`` (``embedding_bwd_plain``),
the counterpart of ``_emb_bwd_rule``, which is no kernel in the JAX
package either. FusedConvBNReLU's backward recomputes its plain
composition and differentiates it, as the JAX package's does: it has no
backward kernel there either.

Dispatch is by device and nothing else: a wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel (building it
first if needed) or raises — a build failure, a launch failure and an
input the kernel does not take all raise, and nothing gives way to the
plain version. Every launch is counted (``launch_counts()``) where it is
made and nowhere else. A small kernel's time is mostly the host's: the
launch path (``_check``, ``_launch``) reads plain tensor attributes, keeps
each bound C function with its counter after the first call, takes the
stream as a raw handle and switches devices only when it must; LayerNorm
writes the op's std itself, its three statistics in one allocation
(``layernorm_stats``). The optimizer wrappers update the weight and state
tensors in place on both devices, and on the card bump their version
counters (the kernels write through raw pointers, which PyTorch does not
see).

Build: at first use, one ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` per source, all started together, into
``build/kernels/`` at the root of the checkout; each library exposes
plain C functions that return ``cudaGetLastError()`` and are bound with
``ctypes``. Libraries are named by a hash of their source and of the
shared headers (``csrc/*.cuh``), so an edited source rebuilds and an
unchanged one is reused. ``libraries_loaded()`` counts the libraries
this process has built or loaded: eager PyTorch has no programs to
compile, so it is the serving engine's counterpart of the JAX package's
compile count.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import math
import operator
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd.graph import increment_version

from ..base import MXNetError, parse_bool, parse_float
from .loss import softmax_ce_grad, softmax_output, softmax_rows
from .nn import _INV_SQRT2, _convolution as nn_convolution, \
    bias_gelu as nn_bias_gelu, cbr_plain, dropout_mask_value, \
    dropout_plain, momentum_update, weak_scalar
from .optimizer_op import adam_step, sgd_mom_step
from .quant import dequantize, qfc_matmul_plain
from .registry import get_op
from .tensor import embedding_lookup, sample as tensor_sample
from .. import random as _random

__all__ = ["build", "embedding", "embedding_plain", "layernorm",
           "layernorm_plain", "layernorm_stats", "fused_layernorm",
           "bias_gelu",
           "bias_gelu_plain", "decode_attention", "decode_attention_fp8",
           "decode_attention_plain",
           "softmax", "softmax_plain", "softmax_ce_bwd",
           "softmax_ce_bwd_plain", "sgd_mom_update", "sgd_mom_update_plain",
           "adam_update", "adam_update_plain", "sgd_mom_update_multi",
           "sgd_mom_update_multi_plain", "adam_update_multi",
           "adam_update_multi_plain", "layernorm_bwd",
           "layernorm_bwd_plain", "layernorm_bwd_dx",
           "layernorm_bwd_dx_plain", "layernorm_bwd_dparams",
           "layernorm_bwd_dparams_plain", "bias_gelu_dx",
           "bias_gelu_dx_plain", "flash_attention", "flash_attention_plain",
           "flash_attention_partial", "flash_attention_partial_plain",
           "embedding_bwd_plain", "layernorm_fn", "bias_gelu_fn",
           "embedding_fn", "qfc_matmul", "qfc_matmul_plain", "dequant_rows",
           "dequant_rows_plain", "dequant_rows_multi",
           "dequant_rows_multi_plain", "bn_stats", "bn_stats_plain",
           "bn_apply_relu", "bn_apply_relu_plain", "dropout",
           "dropout_plain", "dropout_fn", "dropout_mask_value", "uniform",
           "uniform_plain", "conv_bn_relu",
           "conv_bn_relu_fn", "decode_attention_bf16",
           "layernorm_bwd_dx_bf16", "layernorm_bwd_dparams_bf16",
           "bias_gelu_dx_bf16", "flash_attention_bf16", "launch_counts",
           "reset_launch_counts", "libraries_loaded", "source",
           "resources",
           "KERNELS", "COUNTERS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = "arch=compute_90a,code=sm_90a"

_P, _I, _L, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_uint

#: kernel name -> (source file, {instance key: C symbol}, ctypes argtypes).
#: An instance key is the data type its tensors hold ("f32", "bf16",
#: "f16", or "fp8" for the flash-decode read of fp8 caches), then, where
#: the kernel has one entry point per storage type of its weight or cache,
#: ":" and that type
_SPECS = {
    "embedding": ("embedding.cu", {"f32": "mx_embedding_f32",
                                   "bf16": "mx_embedding_bf16",
                                   "f16": "mx_embedding_f16"},
                  [_P, _P, _P, _I, _I, _I, _F, _P]),
    "layernorm": ("layernorm.cu", {"f32": "mx_layernorm_fwd_f32",
                                   "bf16": "mx_layernorm_fwd_bf16",
                                   "f16": "mx_layernorm_fwd_f16"},
                  [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P]),
    "bias_gelu": ("bias_gelu.cu", {"f32": "mx_bias_gelu_f32",
                                   "bf16": "mx_bias_gelu_bf16",
                                   "f16": "mx_bias_gelu_f16"},
                  [_P, _P, _P, _I, _I, _P]),
    # the decode read: the tiles in three libraries by cache type and the
    # general route in a fourth, so that they build in parallel; every
    # launch counts as decode_attention's (``_ROUTES``)
    "decode_attention": ("decode_attention.cu",
                         {"f32": "mx_decode_attention_f32"},
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _F, _P]),
    "decode_attention_16": ("decode_attention_16.cu",
                            {"bf16": "mx_decode_attention_bf16",
                             "f16": "mx_decode_attention_f16"},
                            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _P]),
    "decode_attention_fp8": ("decode_attention_fp8.cu",
                             {"fp8:e4m3": "mx_decode_attention_e4m3",
                              "fp8:e5m2": "mx_decode_attention_e5m2"},
                             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _P]),
    "decode_attention_any": ("decode_attention_any.cu",
                             {"f32": "mx_decode_attention_any_f32",
                              "bf16": "mx_decode_attention_any_bf16",
                              "f16": "mx_decode_attention_any_f16",
                              "fp8:e4m3": "mx_decode_attention_any_e4m3",
                              "fp8:e5m2": "mx_decode_attention_any_e5m2"},
                             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _P]),
    "softmax": ("softmax.cu", {"f32": "mx_softmax_f32",
                               "bf16": "mx_softmax_bf16",
                               "f16": "mx_softmax_f16"},
                [_P, _P, _I, _I, _P]),
    "softmax_ce_bwd": ("softmax_ce_bwd.cu",
                       {"f32": "mx_softmax_ce_bwd_f32",
                        "bf16": "mx_softmax_ce_bwd_bf16",
                        "f16": "mx_softmax_ce_bwd_f16"},
                       [_P, _P, _P, _I, _I, _F, _I, _F, _P]),
    "sgd_mom": ("sgd_mom.cu", {"f32": "mx_sgd_mom_f32"},
                [_P, _P, _P, _L, _F, _F, _F, _F, _F, _P]),
    "adam": ("adam.cu", {"f32": "mx_adam_f32"},
             [_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P]),
    "sgd_mom_multi": ("sgd_mom.cu", {"f32": "mx_sgd_mom_multi_f32"},
                      [_P, _L, _I, _F, _F, _F, _P]),
    "adam_multi": ("adam.cu", {"f32": "mx_adam_multi_f32"},
                   [_P, _L, _I, _F, _F, _F, _F, _F, _F, _F, _P]),
    "ln_bwd": ("ln_bwd.cu", {"f32": "mx_ln_bwd_f32",
                             "bf16": "mx_ln_bwd_bf16",
                             "f16": "mx_ln_bwd_f16"},
               [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "bias_gelu_dx": ("bias_gelu_dx.cu", {"f32": "mx_bias_gelu_dx_f32",
                                         "bf16": "mx_bias_gelu_dx_bf16",
                                         "f16": "mx_bias_gelu_dx_f16"},
                     [_P, _P, _P, _P, _I, _I, _P]),
    "flash_attention": ("flash_attention.cu",
                        {"f32": "mx_flash_attention_f32",
                         "bf16": "mx_flash_attention_bf16",
                         "f16": "mx_flash_attention_f16"},
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attention_partial": (
        "flash_attention.cu", {"f32": "mx_flash_attention_partial_f32",
                               "bf16": "mx_flash_attention_partial_bf16",
                               "f16": "mx_flash_attention_partial_f16"},
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "qfc_matmul": ("qfc_matmul.cu",
                   {"f32:int8": "mx_qfc_matmul_i8_f32",
                    "f32:e4m3": "mx_qfc_matmul_e4m3_f32",
                    "bf16:int8": "mx_qfc_matmul_i8_bf16",
                    "bf16:e4m3": "mx_qfc_matmul_e4m3_bf16",
                    "f16:int8": "mx_qfc_matmul_i8_f16",
                    "f16:e4m3": "mx_qfc_matmul_e4m3_f16"},
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dequant_rows": ("dequant_rows.cu",
                     {"f32:int8": "mx_dequant_rows_i8_f32",
                      "f32:e4m3": "mx_dequant_rows_e4m3_f32"},
                     [_P, _P, _P, _I, _I, _P]),
    "dequant_rows_multi": ("dequant_rows.cu",
                           {"f32:int8": "mx_dequant_rows_multi_i8_f32",
                            "f32:e4m3": "mx_dequant_rows_multi_e4m3_f32"},
                           [_P, _L, _I, _P]),
    "bn_stats": ("bn_stats.cu", {"f32": "mx_bn_stats_f32",
                                 "bf16": "mx_bn_stats_bf16",
                                 "f16": "mx_bn_stats_f16"},
                 [_P, _P, _I, _I, _L] + [_I] * 6 + [_P]),
    "bn_apply_relu": ("bn_apply_relu.cu", {"f32": "mx_bn_apply_relu_f32",
                                           "bf16": "mx_bn_apply_relu_bf16",
                                           "f16": "mx_bn_apply_relu_f16"},
                      [_P, _P, _P, _P, _I, _I, _I, _P]),
    "dropout": ("threefry.cu", {"f32": "mx_dropout_f32",
                                "bf16": "mx_dropout_bf16",
                                "f16": "mx_dropout_f16"},
                [_P, _P, _P, _L, _U, _U, _F, _F, _P]),
    "uniform": ("threefry.cu", {"f32": "mx_uniform_f32",
                                "bf16": "mx_uniform_bf16",
                                "f16": "mx_uniform_f16"},
                [_P, _L, _U, _U, _F, _F, _I, _P]),
}
KERNELS = tuple(_SPECS)

_lock = threading.Lock()
_libs = {}             # library (source stem) -> loaded library
_fns = {}              # (wrapper name, instance key) -> (bound ctypes
                       # function, launch counter)
build_log = {}         # library -> nvcc's stderr (ptxas register report),
                       # kept beside the library


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME): the port's CUDA "
                     "kernels are built from source at first use")


def _library(name):
    """The library that holds kernel ``name``: its source's stem (the
    flash-attention forward and its partial mode share one)."""
    return _SPECS[name][0][:-len(".cu")]


def _lib_path(lib):
    h = hashlib.sha256((_CSRC / f"{lib}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(_ARCH.encode())
    return _BUILD_DIR / f"libmx_{lib}_{h.hexdigest()[:12]}.so"


def build(names=KERNELS):
    """Compile the library of every kernel in ``names`` that is missing,
    one ``nvcc`` per source, all running at once; raise with the
    compiler's output if any fails. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    libs = {_library(n) for n in names}
    for lib in libs:        # the report of a library built before
        log = _lib_path(lib).with_suffix(".log")
        if lib not in build_log and log.exists():
            build_log[lib] = log.read_text()
    todo = sorted(lib for lib in libs if not _lib_path(lib).exists())
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
               str(_CSRC / f"{n}.cu")]
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
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _fn(wrapper, key):
    """(the bound C entry point, the launch counter) of instance ``key``
    of wrapper ``wrapper``'s kernel, building and loading its library on
    first use; resolved once and kept in ``_fns``."""
    name = _WRAPPER_KERNEL[wrapper]
    lib = _library(name)
    with _lock:
        if lib not in _libs:
            build([name])
            _libs[lib] = ctypes.CDLL(str(_lib_path(lib)))
        if (wrapper, key) not in _fns:
            fn = getattr(_libs[lib], _SPECS[name][1][key])
            fn.argtypes = _SPECS[name][2]
            fn.restype = ctypes.c_int
            _fns[(wrapper, key)] = fn, _counter(wrapper, key)
    return _fns[(wrapper, key)]


def _tool(name):
    """A CUDA toolkit program beside nvcc."""
    path = Path(_nvcc()).parent / name
    if not path.exists():
        raise MXNetError(f"{name} not found beside nvcc ({path.parent})")
    return str(path)


def resources(name, sass=True):
    """What the compiler made of kernel ``name``'s library, per kernel
    function (demangled by ``cu++filt``): ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes) from ptxas' report, and
    (``sass``) the count of each SASS opcode (``HGMMA``, ``FFMA``, ...,
    without modifiers) in ``cuobjdump -sass``, which takes seconds for a
    library of many instances. Builds the library first if it is
    missing."""
    build([name])
    lib = _library(name)
    funcs, fn = {}, None
    for line in build_log.get(lib, "").splitlines():
        m = re.search(r"entry function '(\w+)'|Function properties for "
                      r"(\w+)", line)
        if m:
            fn = funcs.setdefault(m.group(1) or m.group(2), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    dump = subprocess.run([_tool("cuobjdump"), "-sass",
                           str(_lib_path(lib))], capture_output=True,
                          text=True, check=True).stdout if sass else ""
    ops = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            ops = funcs.setdefault(m.group(1), {}).setdefault("sass", {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and ops is not None:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    names = list(funcs)
    plain = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {p: funcs[n] for n, p in zip(names, plain)}


def libraries_loaded():
    """How many kernel libraries this process has built or loaded."""
    return len(_libs)


#: tensor dtype -> the data part of an instance key: the suffix of the C
#: entry point and of the launch counter of the instance that takes it
_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16"}
_DTYPES = {k: dt for dt, k in _STORAGE.items()}

#: wrapper name -> the kernel (``_SPECS`` key) it launches
_WRAPPER_KERNEL = {}
#: wrapper name -> the counter of its float32 instance
_F32_COUNTER = {}


def _wrapper(kernel, f32_counter=None):
    """Register the decorated function as the wrapper of ``kernel``; its
    float32 launches count under ``f32_counter`` (default: the kernel's
    name), for a kernel that more than one wrapper launches."""
    def register_wrapper(fn):
        _WRAPPER_KERNEL[fn.__name__] = kernel
        _F32_COUNTER[fn.__name__] = f32_counter or kernel
        return fn
    return register_wrapper


#: the instances and routes of a wrapper that live in libraries of their
#: own and count under the wrapper's counters: route name -> (its kernel,
#: the wrapper); registered after the wrapper (``_route``)
_ROUTES = {}


def _route(name, kernel, wrapper):
    _ROUTES[name] = (kernel, wrapper)
    _WRAPPER_KERNEL[name] = kernel
    _F32_COUNTER[name] = wrapper


def _counter(name, key):
    """The launch counter of wrapper ``name``'s instance ``key``: its
    float32 counter (the kernel's name unless it says otherwise) for
    float32 data, else ``<wrapper>_<bf16|f16|fp8>`` (a route of its own
    library counts as its wrapper)."""
    data = key.split(":")[0]
    base = _ROUTES[name][1] if name in _ROUTES else name
    return _F32_COUNTER[name] if data == "f32" else f"{base}_{data}"


def _instance(name, t, storage=None):
    """The instance key wrapper ``name`` launches for data ``t`` (and a
    weight or cache stored as ``storage``); a dtype with no instance
    raises, naming it."""
    data = _STORAGE.get(t.dtype)
    key = data if storage is None else f"{data}:{storage}"
    keys = _SPECS[_WRAPPER_KERNEL[name]][1]
    if key not in keys:
        have = sorted({str(_DTYPES[k.split(":")[0]]) for k in keys
                       if k.split(":")[0] in _DTYPES})
        raise MXNetError(f"{name}: no kernel instance takes {t.dtype} "
                         f"data; it has {', '.join(have)}")
    return key


def _launch(name, key, tensor, *args, launches=1):
    """Launch instance ``key`` of wrapper ``name``'s kernel on the current
    stream of ``tensor``'s device, raise on a refused launch, and count
    the launch under the instance's counter (``launches`` of them where
    the C entry point launches its grid in chunks). The host's cost is
    most of a small kernel's time, so this path reads raw handles: the
    stream as an integer (no ``Stream`` object), and the device is
    switched only when the tensor is not on the current one."""
    bound = _fns.get((name, key)) or _fn(name, key)
    dev = tensor.get_device()
    if dev == torch._C._cuda_getDevice():
        err = bound[0](*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = bound[0](*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise MXNetError(f"CUDA kernel {name!r} launch failed: cudaError "
                         f"{err}")
    _LAUNCHES[bound[1]] += launches


#: the grid's y limit: the decode read's and the flash forward's query
#: tiles go on that axis in chunks of it, one launch a chunk
GRID_Y = 65535


def _grid_chunks(tiles):
    """Launches of a grid of ``tiles`` query tiles on the y axis."""
    return max(1, -(-tiles // GRID_Y))


#: what the float32-only kernels (the updates on float32 master weights)
#: say of half-precision input
_HALF_LATER = ("the update kernels read float32 master weights, states and "
               "gradients; a half-precision instance is a later slice of "
               "the port (ROADMAP.md queue B)")


def _check(name, **tensors):
    """The inputs a kernel takes: the dtype named for each, contiguous,
    all on one CUDA device. Anything else raises. Plain attribute reads
    (``is_cuda``, ``get_device()``): a ``device`` object is built only for
    an error's message."""
    dev = None
    for key, (t, dtype) in tensors.items():
        if not t.is_cuda:
            raise MXNetError(f"{name}: {key} is on {t.device}, the kernel "
                             "needs a CUDA tensor")
        index = t.get_device()
        if dev is not None and index != dev:
            raise MXNetError(f"{name}: inputs span "
                             f"{torch.device('cuda', dev)} and {t.device}")
        dev = index
        if t.dtype is not dtype:
            raise MXNetError(f"{name}: {key} is {t.dtype}, the kernel "
                             f"takes {dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: {key} must be contiguous")


def _cpu_or_cuda(name, t):
    """True for CUDA, False for CPU; raise for any other device."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise MXNetError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def _pinned(wrapper, suffix, dtypes, arg=0, want=None):
    """``wrapper`` held to its instances for ``dtypes`` (of its argument
    ``arg``): the name an instance had as a wrapper of its own, kept for
    callers."""
    name = f"{wrapper.__name__}_{suffix}"

    def pinned(*args, **kwargs):
        t = args[arg]
        if t.dtype not in dtypes:
            raise MXNetError(f"{name}: {t.dtype} input, want "
                             f"{want or ' or '.join(map(str, dtypes))}")
        return wrapper(*args, **kwargs)
    pinned.__name__ = pinned.__qualname__ = name
    pinned.__doc__ = f"``{wrapper.__name__}`` on {want or dtypes} input only."
    return pinned


def launch_counts():
    """{counter name: launches so far}: one counter per kernel instance
    data type — ``<kernel>`` for float32, ``<wrapper>_bf16`` and
    ``<wrapper>_f16`` for the bfloat16 and float16 instances, and
    ``decode_attention_fp8`` for the flash-decode read of fp8 caches."""
    return dict(_LAUNCHES)


def source(counter):
    """The repo path of the CUDA source behind launch counter
    ``counter``."""
    return f"mxnet_tpu_torch/csrc/{_SPECS[_COUNTER_KERNEL[counter]][0]}"


def reset_launch_counts():
    for n in _LAUNCHES:
        _LAUNCHES[n] = 0


# ==========================================================================
# 1. embedding gather (+ scale)
# ==========================================================================
#: out[i] = W[ids[i]] * scale, the scale applied in float32; an id in
#: [-V, 0) counts from the end, any other out-of-range id gives a NaN row
#: (the Embedding op's own definition, shared)
embedding_plain = embedding_lookup


@_wrapper("embedding")
def embedding(ids, weight, scale=1.0):
    """Gather rows ``ids`` (N,) int32 of ``weight`` (V, D) float32,
    bfloat16 or float16, times ``scale`` -> (N, D) in the weight's dtype:
    each value widened exactly, scaled in float32 and rounded once."""
    if not _cpu_or_cuda("embedding", weight):
        return embedding_plain(ids, weight, scale)
    key = _instance("embedding", weight)
    _check("embedding", ids=(ids, torch.int32), weight=(weight, weight.dtype))
    if weight.ndim != 2 or ids.ndim != 1:
        raise MXNetError(f"embedding: want ids (N,) and weight (V, D), got "
                         f"{tuple(ids.shape)} and {tuple(weight.shape)}")
    n, (v, d) = ids.shape[0], weight.shape
    out = weight.new_empty((n, d))
    _launch("embedding", key, weight, ids.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n, v, d, float(scale))
    return out


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
    """Two-pass float32 statistics over the last axis of x2 (N, C) (or
    any (..., C)): returns (y like x2, mean (N,), rstd (N,))."""
    x = x2.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    d = x - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = d * rstd * gamma.to(torch.float32) + beta.to(torch.float32)
    return y.to(x2.dtype), mean[..., 0], rstd[..., 0]


@_wrapper("layernorm")
def layernorm(x2, gamma, beta, eps):
    """LayerNorm of x2 (N, C) float32, bfloat16 or float16 (gamma, beta
    (C,) of the same dtype) -> (y in x2's dtype, mean (N,), rstd (N,)
    float32): float32 statistics and arithmetic, y rounded once."""
    if x2.ndim != 2:
        raise MXNetError(f"layernorm: want x (N, C), got {tuple(x2.shape)}")
    y, stats = layernorm_stats(x2, gamma, beta, eps)
    return y, stats[0], stats[1]


def layernorm_stats(x, gamma, beta, eps):
    """``layernorm`` over the last axis of x (..., C), with its
    statistics in one float32 block: ``(y, stats)``, y shaped like x and
    stats (3, ...) holding the mean, rstd and the LayerNorm op's std
    output ``1 / rstd`` (an IEEE division, bit for bit PyTorch's ``1.0 /
    rstd``). On the card one launch writes all four, and the statistics
    take one allocation."""
    if not _cpu_or_cuda("layernorm", x):
        y, mean, rstd = layernorm_plain(x, gamma, beta, eps)
        return y, torch.stack((mean, rstd, 1.0 / rstd))
    key = _instance("layernorm", x)
    _check("layernorm", x=(x, x.dtype), gamma=(gamma, x.dtype),
           beta=(beta, x.dtype))
    c = x.shape[-1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise MXNetError(f"layernorm: gamma/beta must be ({c},)")
    y = torch.empty_like(x)
    stats = x.new_empty((3,) + x.shape[:-1], dtype=torch.float32)
    n = stats.numel() // 3
    mean = stats.data_ptr()
    _launch("layernorm", key, x, x.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), mean, mean + 4 * n,
            mean + 8 * n, n, c, float(eps))
    return y, stats


class _LayerNormFn(torch.autograd.Function):
    """Forward: the LayerNorm kernel over x (..., C), which saves mean
    and rstd and also returns the op's std. Backward over the rows: one
    ``layernorm_bwd`` call when x and a parameter both need gradients
    (every training step), else ``layernorm_bwd_dx`` or
    ``layernorm_bwd_dparams`` alone; the cotangents of the statistic
    outputs count as zero (they are marked non-differentiable), as in
    ``_ln_pl_bwd_rule``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, stats = layernorm_stats(x, gamma, beta, eps)
        mean, rstd, std = stats.unbind(0)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd, std)
        # the statistics' cotangents are never read: no zeros are made
        # (a fill launch each) for them
        ctx.set_materialize_grads(False)
        return y, mean, rstd, std

    @staticmethod
    def backward(ctx, gy, _gmean, _grstd, _gstd):
        if gy is None:
            return None, None, None, None
        x, gamma, mean, rstd = ctx.saved_tensors
        c = x.shape[-1]
        x2, gy = x.reshape(-1, c), gy.reshape(-1, c).contiguous()
        mean, rstd = mean.reshape(-1), rstd.reshape(-1)
        need_dx = ctx.needs_input_grad[0]
        need_dp = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx = dg = db = None
        if need_dx and need_dp:
            dx, dg, db = layernorm_bwd(x2, gamma, gy, mean, rstd)
        elif need_dx:
            dx = layernorm_bwd_dx(x2, gamma, gy, mean, rstd)
        elif need_dp:
            dg, db = layernorm_bwd_dparams(x2, gy, mean, rstd)
        return None if dx is None else dx.reshape(x.shape), dg, db, None


def layernorm_fn(x, gamma, beta, eps):
    """Differentiable ``layernorm`` over the last axis of x (..., C)
    contiguous: (y, mean, rstd, std), std = 1 / rstd."""
    return _LayerNormFn.apply(x, gamma, beta, float(eps))


def fused_layernorm(data, gamma, beta, eps=1e-5):
    """The LayerNorm op's contract over the last axis: ``(out, mean,
    std)`` with mean/std shaped ``data.shape[:-1]`` and std = 1/rstd (the
    kernel's own output: nothing is launched after it). Where no gradient
    is recorded (serving) the kernel is called without the
    ``autograd.Function`` around it: each tensor object made costs the
    host microseconds."""
    x = data.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        y, mean, _rstd, std = layernorm_fn(x, gamma, beta, eps)
        return y, mean, std
    y, stats = layernorm_stats(x, gamma, beta, eps)
    return y, stats[0], stats[2]


def _layernorm_cuda(attrs, inputs, aux, is_train, rng):
    """LayerNorm over any axis: the kernels normalize the last, so another
    axis is moved last first (a per-call copy of the activation) and the
    output moved back; mean and std come out over the other axes in their
    order, the JAX op's shapes."""
    data, gamma, beta = inputs
    axis = int(attrs.get("axis", -1)) % data.ndim
    last = axis == data.ndim - 1
    y, mean, std = fused_layernorm(data if last else data.movedim(axis, -1),
                                   gamma, beta,
                                   parse_float(attrs.get("eps", 1e-5)))
    return [y if last else y.movedim(-1, axis), mean, std], []


# ==========================================================================
# 3. bias + GeLU epilogue
# ==========================================================================
#: 0.5 z (1 + erf(z / sqrt 2)) with z = x + bias, in float32 (the
#: FusedBiasGeLU op's own definition, shared)
bias_gelu_plain = nn_bias_gelu


@_wrapper("bias_gelu")
def bias_gelu(x2, bias):
    """Bias + exact GeLU over x2 (N, C) float32, bfloat16 or float16 with
    bias (C,) of the same dtype: float32 arithmetic, y rounded once."""
    if not _cpu_or_cuda("bias_gelu", x2):
        return bias_gelu_plain(x2, bias)
    key = _instance("bias_gelu", x2)
    _check("bias_gelu", x=(x2, x2.dtype), bias=(bias, x2.dtype))
    if x2.ndim != 2:
        raise MXNetError(f"bias_gelu: want x (N, C), got {tuple(x2.shape)}")
    n, c = x2.shape
    if bias.shape != (c,):
        raise MXNetError(f"bias_gelu: bias must be ({c},)")
    y = torch.empty_like(x2)
    _launch("bias_gelu", key, x2, x2.data_ptr(), bias.data_ptr(),
            y.data_ptr(), n, c)
    return y


class _BiasGeLUFn(torch.autograd.Function):
    """Forward: the bias + GeLU kernel. Backward: ``bias_gelu_dx``, and
    the bias gradient as the plain column sum of dx, accumulated in
    float32 and stored in the bias's dtype (the JAX package leaves that
    reduction to XLA, ``sum(dx.astype(float32)).astype(bias.dtype)``)."""

    @staticmethod
    def forward(ctx, x2, bias):
        ctx.save_for_backward(x2, bias)
        return bias_gelu(x2, bias)

    @staticmethod
    def backward(ctx, gy):
        x2, bias = ctx.saved_tensors
        dx = bias_gelu_dx(x2, bias, gy.contiguous())
        db = torch.sum(dx, 0, dtype=torch.float32).to(bias.dtype) \
            if ctx.needs_input_grad[1] else None
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
    query is scaled by Dh^-1/2 before the product, as in the TPU kernel;
    fp8 cells are read back exactly (``.to(float32)``). Returns float32
    (B, H, S, Dh)."""
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


#: fp8 cache storage dtype -> the storage part of its instance key
_FP8_STORAGE = {torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}

#: the attention kernels' tiles by head dim (decode read, flash forward and
#: its partial mode; the 16-bit flash instances have the Dh 64 and 128 ones)
HEAD_TILES = (32, 64, 128)
#: the head dims whose rows are a whole number of 16-byte copies in every
#: cache type, on one tile: every multiple of 16 up to the largest tile.
#: Every other Dh >= 1 runs too (``decode_route``; the flash kernels take
#: any Dh up to 128 on a tile, above it their wide route: column groups of
#: 128, the scores over Dh in 128-wide steps)
HEAD_DIMS = tuple(range(16, HEAD_TILES[-1] + 1, 16))


def head_tile(dh):
    """The tile head dim ``dh`` runs on: the smallest of HEAD_TILES that
    holds it, or the largest, 128, for the wide routes' column groups
    above it (the sources' ``head_tile`` keeps the same rule). The columns
    past ``dh`` reach the tile as zeros and are not stored."""
    return next((t for t in HEAD_TILES if dh <= t), HEAD_TILES[-1])


def head_groups(dh):
    """Output-column groups of a head dim: 1 up to 128 (one tile), else
    ceil(Dh / 128), the wide routes' blocks a (b, h) row and query tile."""
    return 1 if dh <= HEAD_TILES[-1] else -(-dh // HEAD_TILES[-1])


def _check_head_dim(name, dh):
    if dh < 1:
        raise MXNetError(f"{name}: head dim {dh}; want Dh >= 1")

#: the decode kernel's shapes (csrc/decode_attention.cu): keys a warp
#: takes at once (one a lane), query rows a window tile, and warps a block
#: by the query rows a block takes (one at S = 1)
DECODE_CHUNK, DECODE_WIN_ROWS = 32, 16
DECODE_WARPS = {1: 2, DECODE_WIN_ROWS: 4}


def _decode_splits(bh, s, c, sms):
    """(splits, keys a split) of the decode kernel's key range for B*H =
    ``bh`` rows, S = ``s`` queries, capacity ``c`` on a card of ``sms``
    SMs. From the shapes alone, never the cursors (reading them would
    synchronize): splits of a power of two of 32-key chunks, at most 32
    (16 a warp, streamed through its ring), so that the (row, query tile)
    grid holds about two blocks an SM at S = 1, whose blocks are short,
    and one block for every two SMs for a window, whose 16 query rows
    give a block 16 times the work and four warps to share it; a long
    cache keeps few partials to merge. The rule counts blocks, not bytes:
    at one d_model, Dh 32 has twice Dh 64's rows (B*H), so it takes half
    the splits and a block reads the same bytes (the bench LM's served
    step: 2 splits of 128 keys at Dh 32, 4 of 64 at Dh 64). Nor does a
    head dim between the tiles change the plan: at d_model 384 over 8
    heads of 48 or 6 of 64 the served step takes 4 splits of 64 keys, so a
    block reads 48 / 64 of the bytes a Dh 64 block reads; at d_model 640
    over 8 heads of 80 or 10 of 64, 80 / 64 of them."""
    tiles = 1 if s == 1 else -(-s // DECODE_WIN_ROWS)
    chunks = max(1, -(-c // DECODE_CHUNK))
    blocks = 2 * sms if s == 1 else max(1, sms // 2)
    want = max(-(-blocks // max(1, bh * tiles)), -(-chunks // 32))
    per = -(-chunks // min(want, chunks))
    keys = (1 << (per - 1).bit_length()) * DECODE_CHUNK
    return max(1, -(-c // keys)), keys


def _decode_ws_sizes(bh, s, dh, splits):
    """(float32 partials, int32 counters) of the decode kernel's
    workspace: each split's (acc, m, l) of each query tile's rows, and a
    counter a (row, query tile); (0, 0) for one split, where the kernel
    writes its output directly."""
    if splits == 1:
        return 0, 0
    rows = 1 if s == 1 else DECODE_WIN_ROWS
    tiles = -(-s // rows)
    return bh * tiles * splits * rows * (dh + 2), bh * tiles


_DECODE_WS = {}        # (device index, stream) -> [float32 partials,
                       # int32 counters (zeros)]
_DECODE_PLAN = {}      # (device index, B*H, S, C, tile, groups) ->
                       # (splits, keys a split, partials, counters)


def decode_route(dh, s, itemsize, *ptrs):
    """(tile, column groups, query rows a block, copy unit) of a decode
    launch at head dim ``dh``, S = ``s``, ``itemsize`` bytes a cache
    value, the caches at ``ptrs``. The copy unit is the widest, 16, 8, 4
    (cp.async), 2 or 1 bytes (plain loads), that divides a row's bytes
    and the caches' addresses. Rows of whole 16-byte copies up to Dh 128
    run on the tile ``head_tile(dh)`` in one group: every multiple of 16
    up to 128 (HEAD_DIMS) on aligned caches, as before the general route.
    Any other Dh takes the general route: the Dh 128 tile in ceil(Dh /
    128) column groups. One query row at S = 1, else window tiles of 16
    (any S: the tiles on the grid's y axis)."""
    unit = 16
    for v in (dh * itemsize, *ptrs):
        while v % unit:
            unit //= 2
    general = unit != 16 or dh > HEAD_TILES[-1]
    return (HEAD_TILES[-1] if general else head_tile(dh), head_groups(dh),
            1 if s == 1 else DECODE_WIN_ROWS, unit)


def _decode_plan(q, bh, s, c, tile, groups):
    """(splits, keys a split, partials pointer, counters pointer) of a
    decode launch on the route's ``tile`` and column ``groups`` (null
    pointers for one split); the general route's column groups count as
    rows (B*H * groups blocks a query tile). The workspace is kept per
    device and stream and reused: launches on one stream run in order,
    and the kernel leaves its counters at 0. The counters are allocated
    zeroed and the partials uninitialized, each 1 MiB at least, and a
    buffer that is too small is replaced by one twice as large."""
    dev = q.get_device()
    plan = _DECODE_PLAN.get((dev, bh, s, c, tile, groups))
    if plan is None:
        rows = bh * groups
        splits, keys = _decode_splits(rows, s, c, _sm_count(dev))
        plan = _DECODE_PLAN[(dev, bh, s, c, tile, groups)] = (
            splits, keys, *_decode_ws_sizes(rows, s, tile, splits))
    if plan[0] == 1:
        return plan[0], plan[1], 0, 0
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    bufs = _DECODE_WS.get(key)
    if bufs is None:
        bufs = _DECODE_WS[key] = [None, None]
    for i, (need, make) in enumerate(((plan[2], torch.empty),
                                      (plan[3], torch.zeros))):
        if bufs[i] is None or bufs[i].numel() < need:
            old = bufs[i].numel() if bufs[i] is not None else 0
            bufs[i] = make(max(need, 1 << 18, 2 * old), device=q.device,
                           dtype=torch.float32 if i == 0 else torch.int32)
    return plan[0], plan[1], bufs[0].data_ptr(), bufs[1].data_ptr()


@_wrapper("decode_attention")
def decode_attention(q, k_cache, v_cache, pos):
    """Cursor-bounded flash-decode read: q (B, H, S, Dh) float32 with
    caches (B, H, C, Dh) float32, float8_e4m3fn or float8_e5m2, or q and
    caches bfloat16 or float16 (the mixed-precision paths), with this
    step's rows already written, pos (B,) int32 per-row cursors ->
    float32 (B, H, S, Dh). Narrow cells are widened exactly as they are
    read (no float32 copy of the cache is made); fp8 launches count in
    ``decode_attention_fp8``. The key range is split over blocks
    (``_decode_splits``) and the splits merged in order inside the same
    launch. Any Dh >= 1 and any S (``decode_route``: rows of whole
    16-byte copies up to Dh 128 on the tile ``head_tile(Dh)``, every other
    Dh on the general route, column groups of 128 with rows copied in the
    widest unit their bytes and the caches' addresses allow)."""
    if not _cpu_or_cuda("decode_attention", q):
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if k_cache.dtype in _FP8_STORAGE:
        key, q_dtype = "fp8:" + _FP8_STORAGE[k_cache.dtype], torch.float32
        lib = "decode_attention_fp8"
    elif k_cache.dtype in _STORAGE:
        key, q_dtype = _STORAGE[k_cache.dtype], k_cache.dtype
        lib = "decode_attention" if key == "f32" else "decode_attention_16"
    else:
        raise MXNetError(f"decode_attention: cache is {k_cache.dtype}, the "
                         "kernel takes float32, bfloat16, float16, "
                         "float8_e4m3fn or float8_e5m2")
    _check("decode_attention", q=(q, q_dtype),
           k_cache=(k_cache, k_cache.dtype),
           v_cache=(v_cache, k_cache.dtype), pos=(pos, torch.int32))
    B, H, S, Dh = q.shape
    C = k_cache.shape[2]
    _check_head_dim("decode_attention", Dh)
    if tuple(k_cache.shape) != (B, H, C, Dh) or \
            tuple(v_cache.shape) != (B, H, C, Dh) or \
            tuple(pos.shape) != (B,):
        raise MXNetError(f"decode_attention: want caches (B, H, C, Dh) and "
                         f"pos (B,), got {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}, {tuple(pos.shape)}")
    out = q.new_empty((B, H, S, Dh), dtype=torch.float32)
    kp, vp = k_cache.data_ptr(), v_cache.data_ptr()
    tile, groups, rows, unit = decode_route(Dh, S, k_cache.element_size(),
                                            kp, vp)
    splits, keys, ws, counters = _decode_plan(q, B * H, S, C, tile, groups)
    general = unit != 16 or groups > 1
    _launch("decode_attention_any" if general else lib, key,
            q, q.data_ptr(), kp, vp, pos.data_ptr(), out.data_ptr(), ws,
            counters, B, H, S, C, Dh, keys, splits, unit, groups,
            float(Dh) ** -0.5, launches=_grid_chunks(-(-S // rows)))
    return out


_route("decode_attention_16", "decode_attention_16", "decode_attention")
_route("decode_attention_fp8", "decode_attention_fp8", "decode_attention")
_route("decode_attention_any", "decode_attention_any", "decode_attention")
decode_attention_fp8 = _pinned(decode_attention, "fp8", tuple(_FP8_STORAGE),
                               arg=1, want="float8_e4m3fn or float8_e5m2")
decode_attention_bf16 = _pinned(decode_attention, "bf16", (torch.bfloat16,),
                                arg=1)

# ==========================================================================
# 5. row softmax (SoftmaxOutput forward)
# ==========================================================================
#: e = exp(x - max), e / sum(e) per row in float32, stored in x's type
#: (the SoftmaxOutput op's own row function, shared)
softmax_plain = softmax_rows

#: the JAX package's eligibility bound for its softmax kernel: the longest
#: row the kernel's register routes hold (a cluster of four blocks at it);
#: longer rows take its streaming route, which has no bound
SOFTMAX_MAX_C = 65536


@_wrapper("softmax")
def softmax(x2):
    """Row softmax of x2 (N, C) float32, bfloat16 or float16, any C -> (N,
    C) in x2's dtype: float32 arithmetic, y rounded once (rows past
    ``SOFTMAX_MAX_C`` read twice by the streaming route)."""
    if not _cpu_or_cuda("softmax", x2):
        return softmax_plain(x2)
    key = _instance("softmax", x2)
    _check("softmax", x=(x2, x2.dtype))
    if x2.ndim != 2:
        raise MXNetError(f"softmax: want (N, C), got {tuple(x2.shape)}")
    n, c = x2.shape
    y = torch.empty_like(x2)
    _launch("softmax", key, x2, x2.data_ptr(), y.data_ptr(), n, c)
    return y


# ==========================================================================
# 6. softmax cross-entropy gradient (SoftmaxOutput backward)
# ==========================================================================
#: (p - onehot(int(label))) * keep * scale in float32, stored in p's type
#: (the op's own row function)
softmax_ce_bwd_plain = softmax_ce_grad


@_wrapper("softmax_ce_bwd")
def softmax_ce_bwd(prob2, label, scale, use_ignore=False, ignore_label=-1.0):
    """Cross-entropy gradient over prob2 (N, C) float32, bfloat16 or
    float16 with label (N,) float32 -> (N, C) in prob2's dtype: float32
    arithmetic, the gradient rounded once."""
    if not _cpu_or_cuda("softmax_ce_bwd", prob2):
        return softmax_ce_bwd_plain(prob2, label, scale, use_ignore,
                                    ignore_label)
    key = _instance("softmax_ce_bwd", prob2)
    _check("softmax_ce_bwd", prob=(prob2, prob2.dtype),
           label=(label, torch.float32))
    if prob2.ndim != 2 or tuple(label.shape) != (prob2.shape[0],):
        raise MXNetError(f"softmax_ce_bwd: want prob (N, C) and label (N,), "
                         f"got {tuple(prob2.shape)} and "
                         f"{tuple(label.shape)}")
    n, c = prob2.shape
    g = torch.empty_like(prob2)
    _launch("softmax_ce_bwd", key, prob2, prob2.data_ptr(), label.data_ptr(),
            g.data_ptr(), n, c, float(scale), int(bool(use_ignore)),
            float(ignore_label))
    return g


# ==========================================================================
# 7. SGD with momentum (in place)
# ==========================================================================
#: functional (w', m') = the sgd_mom_update op's plain forward
sgd_mom_update_plain = sgd_mom_step


def _check_same(name, **tensors):
    for key, t in tensors.items():
        if t.dtype in (torch.bfloat16, torch.float16):
            raise MXNetError(f"{name}: {key} is {t.dtype}; {_HALF_LATER}")
    _check(name, **{k: (t, torch.float32) for k, t in tensors.items()})
    shapes = {tuple(t.shape) for t in tensors.values()}
    if len(shapes) != 1:
        raise MXNetError(f"{name}: operands differ in shape: {shapes}")


@_wrapper("sgd_mom")
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
    _launch("sgd_mom_update", "f32", weight, weight.data_ptr(),
            grad.data_ptr(), mom.data_ptr(), weight.numel(), float(lr),
            float(momentum), float(wd), float(rescale), float(clip))
    increment_version((weight, mom))      # written through raw pointers
    return weight, mom


# ==========================================================================
# 8. Adam (in place)
# ==========================================================================
#: functional (w', mean', var') = the adam_update op's plain forward
adam_update_plain = adam_step


@_wrapper("adam")
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
    _launch("adam_update", "f32", weight, weight.data_ptr(),
            grad.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.numel(),
            float(lr), float(beta1), float(1 - beta1), float(beta2),
            float(1 - beta2), float(epsilon), float(wd), float(rescale),
            float(clip))
    increment_version((weight, mean, var))
    return weight, mean, var


# ==========================================================================
# 7-8 multi. SGD-momentum and Adam over a whole step's arrays, one launch
# ==========================================================================
#: arrays a launch's table holds, and elements a block updates (csrc/
#: multi_update.cuh kCap and kChunk)
MULTI_CAP = 512
MULTI_CHUNK = 8192
_SHAPE, _DTYPE, _IS_CPU = (operator.attrgetter(a)
                           for a in ("shape", "dtype", "is_cpu"))


def _multi_dtype(ops):
    """``mxmulti::Table<ops>`` (csrc/multi_update.cuh) as a numpy
    structured type: the same fields in the same order, packed as the C
    struct lays them out (every field lands on its own alignment)."""
    cap = MULTI_CAP
    return np.dtype([("ptr", np.uint64, (ops, cap)), ("n", np.int64, cap),
                     ("lr", np.float32, cap), ("wd", np.float32, cap),
                     ("chunk_end", np.int32, cap), ("vec", np.int32, cap),
                     ("count", np.int32), ("pad", np.int32)])


#: operands an array (3: SGD-momentum, 4: Adam) -> its launch table's type
_MULTI_TABLE = {ops: _multi_dtype(ops) for ops in (3, 4)}


def _multi_plan(lens, chunk=MULTI_CHUNK, cap=MULTI_CAP):
    """The launches of a multi-tensor kernel over arrays of lengths
    ``lens``, in index order: (positions in the list, cumulative
    ``chunk``-element chunk counts) for each, at most ``cap`` arrays a
    launch; zero-length arrays are left out."""
    lens = np.asarray(lens, np.int64)
    live = np.flatnonzero(lens > 0)
    return [(pos, np.cumsum(-(-lens[pos] // chunk)))
            for pos in (live[s:s + cap] for s in range(0, len(live), cap))]


def _multi_tables(ptrs, lens, lrs, wds):
    """(table, blocks) for each launch of a multi-tensor update: ``ptrs``
    (operands, arrays) the operands' addresses (weight, gradient, then the
    states), ``lens``, ``lrs`` and ``wds`` one per array; each table a 0-d
    array of ``_MULTI_TABLE[operands]``. An array whose operands all lie on
    16-byte boundaries is flagged for 16-byte accesses."""
    ptrs = np.asarray(ptrs, np.uint64)
    lens = np.asarray(lens, np.int64)
    vec = (ptrs % 16 == 0).all(axis=0)
    lrs, wds = np.asarray(lrs, np.float32), np.asarray(wds, np.float32)
    out = []
    for pos, ends in _multi_plan(lens):
        table, k = np.zeros((), _MULTI_TABLE[len(ptrs)]), len(pos)
        table["ptr"][:, :k] = ptrs[:, pos]
        table["n"][:k] = lens[pos]
        table["lr"][:k] = lrs[pos]
        table["wd"][:k] = wds[pos]
        table["chunk_end"][:k] = ends
        table["vec"][:k] = vec[pos]
        table["count"] = k
        out.append((table, int(ends[-1])))
    return out


def _multi_check(name, operands, lrs, wds):
    """``"cuda"`` when every tensor of ``operands`` ({name: list}, one
    entry an array) lies on one CUDA device as float32, contiguous, each
    array's operands of one shape; ``"cpu"`` when every tensor lies on the
    CPU (shapes checked too); None for empty lists. Anything else raises,
    naming the array's position. The common case takes a few reads over
    whole lists (``map``: a step's lists hold hundreds of tensors); only a
    failure walks them one by one, to name the array."""
    n = len(lrs)
    if len(wds) != n or any(len(ts) != n for ts in operands.values()):
        raise MXNetError(f"{name}: the lists differ in length: " + ", ".join(
            f"{k} {len(v)}" for k, v in
            dict(operands, lrs=lrs, wds=wds).items()))
    if not n:
        return None
    lead, first = next(iter(operands.items()))
    cuda = _cpu_or_cuda(name, first[0])
    dev = first[0].get_device()
    every = list(itertools.chain.from_iterable(operands.values()))
    shapes = list(map(_SHAPE, first))
    if set(map(torch.Tensor.get_device, every)) == {dev} and all(
            list(map(_SHAPE, ts)) == shapes for ts in operands.values()) \
            and (set(map(_DTYPE, every)) == {torch.float32} and
                 all(map(torch.Tensor.is_contiguous, every)) if cuda
                 else all(map(_IS_CPU, every))):
        return "cuda" if cuda else "cpu"
    for i in range(n):
        for key, ts in operands.items():
            t = ts[i]
            if t.get_device() != dev or not (cuda or t.is_cpu):
                raise MXNetError(f"{name}: {key}[{i}] is on {t.device}, "
                                 f"{lead}[0] on {first[0].device}")
            if t.shape != shapes[i]:
                raise MXNetError(f"{name}: {key}[{i}] is "
                                 f"{tuple(t.shape)}, its weight "
                                 f"{tuple(shapes[i])}")
            if not cuda:
                continue
            if t.dtype is not torch.float32:
                raise MXNetError(
                    f"{name}: {key}[{i}] is {t.dtype}; " + (
                        _HALF_LATER if t.dtype in (torch.bfloat16,
                                                   torch.float16)
                        else "the kernel takes torch.float32"))
            if not t.is_contiguous():
                raise MXNetError(f"{name}: {key}[{i}] must be contiguous")
    return "cuda" if cuda else "cpu"


def _multi_launch(name, operands, lrs, wds, *hyper):
    """Launch ``name``'s multi-tensor kernel over ``operands`` (checked),
    as many launches as the tables need, and bump the written tensors'
    version counters."""
    ts = list(operands.values())
    for table, blocks in _multi_tables(
            [list(map(torch.Tensor.data_ptr, op)) for op in ts],
            list(map(torch.Tensor.numel, ts[0])), lrs, wds):
        _launch(name, "f32", ts[0][0], table.ctypes.data, table.nbytes,
                blocks, *hyper)
    increment_version([t for j, op in enumerate(ts) if j != 1 for t in op])


def sgd_mom_update_multi_plain(weights, grads, moms, lrs, wds, momentum=0.0,
                               rescale=1.0, clip=-1.0):
    """[(w', m')]: ``sgd_mom_update_plain`` of each array with its own lr
    and wd."""
    return [sgd_mom_update_plain(w, g, m, lr, momentum, wd, rescale, clip)
            for w, g, m, lr, wd in zip(weights, grads, moms, lrs, wds)]


@_wrapper("sgd_mom_multi")
def sgd_mom_update_multi(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale=1.0, clip=-1.0):
    """``sgd_mom_update`` of every array of the lists in place, array i
    with ``lrs[i]`` and ``wds[i]``: on the card one launch for up to
    MULTI_CAP arrays (a longer list takes more, in index order), bit for
    bit the per-array kernel's result. An empty list launches nothing."""
    ops = {"weights": weights, "grads": grads, "moms": moms}
    where = _multi_check("sgd_mom_update_multi", ops, lrs, wds)
    if where is None:
        return
    if where == "cpu":
        for w, m, new in zip(weights, moms, sgd_mom_update_multi_plain(
                weights, grads, moms, lrs, wds, momentum, rescale, clip)):
            w.copy_(new[0])
            m.copy_(new[1])
        return
    _multi_launch("sgd_mom_update_multi", ops, lrs, wds, float(momentum),
                  float(rescale), float(clip))


def adam_update_multi_plain(weights, grads, means, vars, lrs, wds,
                            beta1=0.9, beta2=0.999, epsilon=1e-8,
                            rescale=1.0, clip=-1.0):
    """[(w', mean', var')]: ``adam_update_plain`` of each array with its
    own lr and wd."""
    return [adam_update_plain(w, g, m, v, lr, beta1, beta2, epsilon, wd,
                              rescale, clip)
            for w, g, m, v, lr, wd in zip(weights, grads, means, vars, lrs,
                                          wds)]


@_wrapper("adam_multi")
def adam_update_multi(weights, grads, means, vars, lrs, wds, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, rescale=1.0, clip=-1.0):
    """``adam_update`` of every array of the lists in place, array i with
    ``lrs[i]`` (the bias correction folded in) and ``wds[i]``; launches
    as ``sgd_mom_update_multi``."""
    ops = {"weights": weights, "grads": grads, "means": means, "vars": vars}
    where = _multi_check("adam_update_multi", ops, lrs, wds)
    if where is None:
        return
    if where == "cpu":
        for dst, new in zip(zip(weights, means, vars), adam_update_multi_plain(
                weights, grads, means, vars, lrs, wds, beta1, beta2, epsilon,
                rescale, clip)):
            for d, s in zip(dst, new):
                d.copy_(s)
        return
    _multi_launch("adam_update_multi", ops, lrs, wds, float(beta1),
                  float(1 - beta1), float(beta2), float(1 - beta2),
                  float(epsilon), float(rescale), float(clip))


# ==========================================================================
# 9-10. LayerNorm backward: dx, dgamma and dbeta (one kernel, ln_bwd.cu)
# ==========================================================================
#: the JAX package's eligibility bound for its LayerNorm kernels; the
#: backward kernel's walked route takes rows past it too
LN_MAX_C = 65536
#: the longest row the kernel holds in a warp's registers (its register
#: route, one pass over x and ct); longer rows take its walked route
LN_REG_ROW_MAX = 1024


def layernorm_bwd_dx_plain(x2, gamma, ct, mean, rstd):
    """dx of LayerNorm over x2 (N, C) from the saved mean and rstd (N,),
    in float32: ``rstd (gy - mean(gy) - xh mean(gy xh))`` with ``xh = (x
    - mean) rstd`` and ``gy = ct gamma``, stored in x2's dtype."""
    r = rstd.to(torch.float32)[:, None]
    xh = (x2.to(torch.float32) - mean.to(torch.float32)[:, None]) * r
    gy = ct.to(torch.float32) * gamma.to(torch.float32)
    m1 = gy.mean(dim=-1, keepdim=True)
    m2 = (gy * xh).mean(dim=-1, keepdim=True)
    return (r * (gy - m1 - xh * m2)).to(x2.dtype)


def layernorm_bwd_dparams_plain(x2, ct, mean, rstd):
    """(dgamma, dbeta), each (C,), summed in float32 over the rows of x2
    and ct (N, C): ``sum(ct xh)`` and ``sum(ct)``, each stored in x2's
    dtype (rounded once from the float32 sum, as ``_ln_pl_bwd_rule``
    casts to gamma's dtype)."""
    xh = (x2.to(torch.float32) - mean.to(torch.float32)[:, None]) * \
        rstd.to(torch.float32)[:, None]
    c32 = ct.to(torch.float32)
    return (c32 * xh).sum(dim=0).to(x2.dtype), c32.sum(dim=0).to(x2.dtype)


def layernorm_bwd_plain(x2, gamma, ct, mean, rstd):
    """(dx, dgamma, dbeta): ``layernorm_bwd_dx_plain`` and
    ``layernorm_bwd_dparams_plain`` together."""
    return (layernorm_bwd_dx_plain(x2, gamma, ct, mean, rstd),
            *layernorm_bwd_dparams_plain(x2, ct, mean, rstd))


def _dparams_chunks(n):
    """(rows per chunk, chunks) of the walked route's parameter
    gradients: 64-row chunks, larger (a multiple of 8) when N needs more
    than 65535; at least one chunk (``walk_chunks`` in ln_bwd.cu)."""
    rows = max(64, -(-n // 65535))
    rows = -(-rows // 8) * 8
    return rows, max(1, -(-n // rows))


_SMS = {}              # device index -> its SM count


def _sm_count(dev):
    """The SM count of CUDA device ``dev``, read once and kept."""
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms

_LN_SCRATCH = {}       # (device index, stream) -> float32 partials scratch


def _ln_bwd_scratch(x2, rows, c):
    """float32 scratch of ``rows`` x 2C values for the kernel's column
    partials. The register route's (at most two rows an SM) is kept per
    device and stream and reused: launches on one stream run in order, so
    one buffer serves every call there, and a call makes no allocation
    for it. The walked route's, a row per chunk of rows, is allocated per
    call."""
    if c > LN_REG_ROW_MAX:
        return x2.new_empty((rows * 2 * c,), dtype=torch.float32)
    dev = x2.get_device()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    buf = _LN_SCRATCH.get(key)
    if buf is None or buf.numel() < rows * 2 * c:
        buf = _LN_SCRATCH[key] = x2.new_empty(
            (max(rows, 2 * _SMS[dev]) * 2 * LN_REG_ROW_MAX,),
            dtype=torch.float32)
    return buf


def _ln_bwd_part_rows(x2, n, c):
    """Rows of the float32 scratch (2C values each) the parameter
    gradients need: one per block of the register route's persistent grid
    (at most two blocks an SM, and a block holds 8 warps or more: at most
    ceil(N / 8)), one per chunk of rows on the walked route."""
    if c > LN_REG_ROW_MAX:
        return _dparams_chunks(n)[1]
    return max(1, min(2 * _sm_count(x2.get_device()), -(-n // 8)))


def _ln_bwd(name, x2, gamma, ct, mean, rstd, want_dx, want_dp):
    """One launch of ln_bwd.cu for wrapper ``name`` with the halves asked
    for: (dx or None, dgdb (2, C) — dgamma, dbeta — or None). gamma is
    read only for dx."""
    key = _instance(name, x2)
    tensors = dict(x=(x2, x2.dtype))
    if want_dx:
        tensors["gamma"] = (gamma, x2.dtype)
    _check(name, **tensors, ct=(ct, x2.dtype), mean=(mean, torch.float32),
           rstd=(rstd, torch.float32))
    n_rows = x2.shape[:1]
    if x2.ndim != 2 or ct.shape != x2.shape or mean.shape != n_rows or \
            rstd.shape != n_rows:
        raise MXNetError(f"{name}: want x, ct (N, C) and mean, rstd (N,), "
                         f"got {tuple(x2.shape)}, {tuple(ct.shape)}, "
                         f"{tuple(mean.shape)}, {tuple(rstd.shape)}")
    n, c = x2.shape
    if want_dx and gamma.shape != x2.shape[1:]:
        raise MXNetError(f"{name}: gamma must be ({c},)")
    dx = torch.empty_like(x2) if want_dx else None
    dgdb = part = None
    rows = 0
    if want_dp:
        rows = _ln_bwd_part_rows(x2, n, c)
        dgdb = x2.new_empty((2, c))
        part = _ln_bwd_scratch(x2, rows, c)
    _launch(name, key, x2, x2.data_ptr(),
            gamma.data_ptr() if want_dx else None, ct.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr() if want_dx else None,
            dgdb.data_ptr() if want_dp else None,
            part.data_ptr() if want_dp else None, n, c, rows)
    return dx, dgdb


@_wrapper("ln_bwd")
def layernorm_bwd(x2, gamma, ct, mean, rstd):
    """LayerNorm's three gradients in one call: x2, ct (N, C), gamma (C,)
    float32, bfloat16 or float16, mean, rstd (N,) float32, C <= 65536 ->
    (dx (N, C), dgamma (C,), dbeta (C,)) in x2's dtype, float32
    arithmetic and sums, each output rounded once. On the card one
    launch reads x and ct once for all three (C <= 1024; longer rows take
    the walked route); dgamma and dbeta are the two rows of one (2, C)
    tensor, and the reduction's scratch is kept between calls on a
    stream (one allocation for the walked route)."""
    if not _cpu_or_cuda("layernorm_bwd", x2):
        return layernorm_bwd_plain(x2, gamma, ct, mean, rstd)
    dx, dgdb = _ln_bwd("layernorm_bwd", x2, gamma, ct, mean, rstd, True,
                       True)
    dg, db = dgdb
    return dx, dg, db


@_wrapper("ln_bwd", "ln_bwd_dx")
def layernorm_bwd_dx(x2, gamma, ct, mean, rstd):
    """LayerNorm's input gradient alone (``layernorm_bwd``'s kernel with
    the parameter gradients off): x2, ct (N, C), gamma (C,) float32,
    bfloat16 or float16, mean, rstd (N,) float32, C <= 65536 -> dx (N, C)
    in x2's dtype: float32 arithmetic, dx rounded once."""
    if not _cpu_or_cuda("layernorm_bwd_dx", x2):
        return layernorm_bwd_dx_plain(x2, gamma, ct, mean, rstd)
    return _ln_bwd("layernorm_bwd_dx", x2, gamma, ct, mean, rstd, True,
                   False)[0]


layernorm_bwd_dx_bf16 = _pinned(layernorm_bwd_dx, "bf16", (torch.bfloat16,))


@_wrapper("ln_bwd", "ln_bwd_dparams")
def layernorm_bwd_dparams(x2, ct, mean, rstd):
    """LayerNorm's parameter gradients alone (``layernorm_bwd``'s kernel
    with dx off): x2, ct (N, C) float32, bfloat16 or float16 with mean,
    rstd (N,) float32, C <= 65536 -> (dgamma, dbeta) (C,) in x2's dtype,
    each the float32 sum rounded once. A reduction in a fixed order (no
    float atomics): repeated calls give the same bits."""
    if not _cpu_or_cuda("layernorm_bwd_dparams", x2):
        return layernorm_bwd_dparams_plain(x2, ct, mean, rstd)
    dg, db = _ln_bwd("layernorm_bwd_dparams", x2, None, ct, mean, rstd,
                     False, True)[1]
    return dg, db


layernorm_bwd_dparams_bf16 = _pinned(layernorm_bwd_dparams, "bf16",
                                     (torch.bfloat16,))


# ==========================================================================
# 11. bias + GeLU backward: dx
# ==========================================================================
_INV_SQRT2PI = 0.3989422804014327


def bias_gelu_dx_plain(x2, bias, ct):
    """``ct (0.5 (1 + erf(z / sqrt 2)) + z phi(z))`` with z = x2 + bias,
    in float32, with the TPU kernel's constants, stored in x2's dtype."""
    z = x2.to(torch.float32) + bias.to(torch.float32)
    phi = torch.exp(-0.5 * z * z) * _INV_SQRT2PI
    dgelu = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2)) + z * phi
    return (ct.to(torch.float32) * dgelu).to(x2.dtype)


@_wrapper("bias_gelu_dx")
def bias_gelu_dx(x2, bias, ct):
    """The bias + GeLU input gradient over x2, ct (N, C) float32, bfloat16
    or float16 with bias (C,) of the same dtype -> dx (N, C) in x2's
    dtype: float32 arithmetic, dx rounded once."""
    if not _cpu_or_cuda("bias_gelu_dx", x2):
        return bias_gelu_dx_plain(x2, bias, ct)
    key = _instance("bias_gelu_dx", x2)
    _check("bias_gelu_dx", x=(x2, x2.dtype), bias=(bias, x2.dtype),
           ct=(ct, x2.dtype))
    if x2.ndim != 2 or tuple(ct.shape) != tuple(x2.shape) or \
            tuple(bias.shape) != (x2.shape[1],):
        raise MXNetError(f"bias_gelu_dx: want x, ct (N, C) and bias (C,), "
                         f"got {tuple(x2.shape)}, {tuple(ct.shape)}, "
                         f"{tuple(bias.shape)}")
    n, c = x2.shape
    dx = torch.empty_like(x2)
    _launch("bias_gelu_dx", key, x2, x2.data_ptr(), bias.data_ptr(),
            ct.data_ptr(), dx.data_ptr(), n, c)
    return dx


bias_gelu_dx_bf16 = _pinned(bias_gelu_dx, "bf16", (torch.bfloat16,))


# ==========================================================================
# 12. flash-attention forward
# ==========================================================================
def flash_attention_plain(q, k, v, causal=False):
    """Softmax attention of q over k, v (B, H, T, Dh) as the flash kernel
    computes it: q scaled by Dh^-1/2 BEFORE the product, float32 scores
    and softmax, the causal mask keeping key <= query. Returns (B, H, T,
    Dh) in q's dtype (float32 arithmetic, rounded once)."""
    qs = q.to(torch.float32) * (float(q.shape[-1]) ** -0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.to(torch.float32))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        live = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~live, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.to(torch.float32)).to(q.dtype)


def _flash_operands(q, k, v):
    """(q, k, v, head dim) as the kernel takes them: as they are, but on
    the routes of Dh <= 128, whose copies are 16 bytes (cp.async for
    float32, TMA's row pitch and addresses for 16 bits), where a row is no
    multiple of 16 bytes (Dh of 4 floats, of 8 16-bit values) or an operand
    is not 16-byte aligned: then zero-padded copies to that multiple, whose
    columns past Dh leave the scores unchanged and give the output zero
    columns, cut off after the call. A per-call copy of the activations."""
    dh = q.shape[-1]
    unit = 16 // q.element_size()
    if dh > HEAD_TILES[-1] or (
            dh % unit == 0 and not any(t.data_ptr() % 16 for t in (q, k, v))):
        return q, k, v, dh
    pad = -dh % unit
    return (*(torch.nn.functional.pad(t, (0, pad)) if pad else t.clone()
              for t in (q, k, v)), dh + pad)


def flash_query_rows(dh, dtype):
    """Query rows a block of the flash forward takes (csrc/
    flash_attention.cu): float32 128 on the Dh 32 tile and 64 on the
    others, the 16-bit tensor-core tiles 128, the wide route (Dh past
    128, every type) 64."""
    if dh > HEAD_TILES[-1]:
        return 64
    if dtype == torch.float32:
        return 128 if head_tile(dh) == 32 else 64
    return 128


@_wrapper("flash_attention")
def flash_attention(q, k, v, causal=False):
    """Attention of q (B, H, Tq, Dh) over k, v (B, H, Tk, Dh) float32,
    bfloat16 or float16 -> (B, H, Tq, Dh) in q's dtype, the output rounded
    once; under ``causal`` the mask is bottom-right aligned (key j is live
    for query i when j <= i + Tk - Tq), and a query row that sees no key
    (Tq > Tk) is NaN, as in the reference. float32: q scaled, every
    product and the online softmax float32 FMAs on the CUDA cores.
    bfloat16 / float16: the tensor cores (wgmma) take q and k as stored
    (exact float32 products, float32 sums), the float32 scores are then
    scaled and take the same float32 online softmax, and P . V is p_hi . V
    + p_lo . V with p_hi = round16(p), p_lo = round16(p - p_hi). Any Dh
    (up to 128 on the tile ``head_tile(Dh)``, the 16-bit instances on the
    Dh 64 tiles at Dh <= 64; a zero-padded copy where Dh is no multiple
    of 8, of 4 in float32 (``_flash_operands``); above 128 every type on
    the CUDA cores' wide route, column groups of 128), any T and any
    B*H."""
    if not _cpu_or_cuda("flash_attention", q):
        return flash_attention_plain(q, k, v, causal)
    key = _instance("flash_attention", q)
    _check("flash_attention", q=(q, q.dtype), k=(k, q.dtype),
           v=(v, q.dtype))
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise MXNetError(f"flash_attention: want q (B, H, Tq, Dh) and k, v "
                         f"(B, H, Tk, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, Dh = q.shape
    _check_head_dim("flash_attention", Dh)
    qk, kk, vk, dk = _flash_operands(q, k, v)
    out = qk.new_empty((B, H, Tq, dk))
    _launch("flash_attention", key, q, qk.data_ptr(), kk.data_ptr(),
            vk.data_ptr(), out.data_ptr(), B * H, Tq, k.shape[2], dk,
            int(bool(causal)), float(Dh) ** -0.5,
            launches=_grid_chunks(-(-Tq // flash_query_rows(dk, q.dtype))))
    return out if dk == Dh else out[..., :Dh].contiguous()


flash_attention_bf16 = _pinned(flash_attention, "bf16", (torch.bfloat16,))


# ==========================================================================
# 12b. flash-attention partial mode (the local block of ring attention)
# ==========================================================================
def _ring_scale(q):
    """The ring's default scale, 1/sqrt(Dh), as the JAX package takes it."""
    return 1.0 / float(q.shape[-1]) ** 0.5


def flash_attention_partial_plain(q, k, v, q_off=0, k_off=0, causal=False,
                                  scale=None):
    """The unnormalized online-softmax state of q (B, H, Tq, Dh) over one
    K/V shard k, v (B, H, Tk, Dh), as the partial kernel leaves it at the
    end of its key loop: s = (q * scale) . k in float32, keys masked where
    ``q_off + t < k_off + key`` under ``causal``; m = max_key s (-inf for a
    row that sees no key), p = exp(s - m) where s is finite else 0 (m read
    as 0 where it is -inf), l = sum_key p, acc = p . v. Returns (acc (B, H,
    Tq, Dh), m (B, H, Tq), l (B, H, Tq)), all float32: one key block of the
    kernel's arithmetic, which rescales partial sums where this sums
    once."""
    if scale is None:
        scale = _ring_scale(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        live = (q_off + torch.arange(tq, device=q.device))[:, None] >= \
            (k_off + torch.arange(tk, device=q.device))[None, :]
        s = s.masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    return (torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32)), m,
            p.sum(dim=-1))


@_wrapper("flash_attention_partial")
def flash_attention_partial(q, k, v, q_off=0, k_off=0, causal=False,
                            scale=None):
    """The partial flash-attention block of ring attention: q (B, H, Tq,
    Dh) over the K/V shard k, v (B, H, Tk, Dh) float32, bfloat16 or
    float16, the shards at absolute sequence offsets ``q_off`` and
    ``k_off`` -> (acc, m, l) float32 (see ``flash_attention_partial_
    plain``); the 16-bit instances run on the tensor cores as
    ``flash_attention``'s do (exact 16-bit products summed in float32,
    the float32 softmax, P . V from P split into two 16-bit terms). The
    scale defaults to 1/sqrt(Dh). Any Dh, Tq, Tk and B*H, as
    ``flash_attention`` takes them."""
    if scale is None:
        scale = _ring_scale(q)
    if not _cpu_or_cuda("flash_attention_partial", q):
        return flash_attention_partial_plain(q, k, v, q_off, k_off, causal,
                                             scale)
    key = _instance("flash_attention_partial", q)
    _check("flash_attention_partial", q=(q, q.dtype), k=(k, q.dtype),
           v=(v, q.dtype))
    if q.ndim != 4 or tuple(k.shape) != tuple(v.shape) or k.ndim != 4 or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise MXNetError(f"flash_attention_partial: want q (B, H, Tq, Dh) and "
                         f"k, v (B, H, Tk, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, Dh = q.shape
    _check_head_dim("flash_attention_partial", Dh)
    qk, kk, vk, dk = _flash_operands(q, k, v)
    acc = q.new_empty((B, H, Tq, dk), dtype=torch.float32)
    m = q.new_empty((B, H, Tq), dtype=torch.float32)
    l = torch.empty_like(m)
    _launch("flash_attention_partial", key, q, qk.data_ptr(), kk.data_ptr(),
            vk.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), B * H,
            Tq, k.shape[2], dk, int(q_off), int(k_off), int(bool(causal)),
            float(scale),
            launches=_grid_chunks(-(-Tq // flash_query_rows(dk, q.dtype))))
    return acc if dk == Dh else acc[..., :Dh].contiguous(), m, l


# ==========================================================================
# 13. dequant-fused dense matmul (QuantizedFullyConnected)
# 14. per-row weight dequant (QuantizedConvolution)
# ==========================================================================
#: float(wq2[o, c]) * scale[o] over rows (O, cols), in float32 (the
#: quantized ops' own dequant, shared)
dequant_rows_plain = dequantize

#: weight storage dtype -> the storage part of the kernels' instance keys
_QUANT_STORAGE = {torch.int8: "int8", torch.float8_e4m3fn: "e4m3"}


def _quant_storage(name, wq):
    storage = _QUANT_STORAGE.get(wq.dtype)
    if storage is None:
        raise MXNetError(f"{name}: weight is {wq.dtype}, the kernel takes "
                         "torch.int8 or torch.float8_e4m3fn")
    return storage


#: the dequant-fused matmul's GEMV route (csrc/qfc_matmul.cu): output
#: channels a warp, warps a block, floats a staged 16-value unit of x
QFC_NR, QFC_WARPS, QFC_PITCH = 4, 8, 20
#: the route break, fit to the route-break table (PERF.md; N 1000, 4096 and
#: 32000): the outputs an SM computes on the GEMV route while one 64 x 64
#: tile of the tiled route runs, and those in a tile's share of the card's
#: time once the tiles fill it (the tiled route's full rate is 4096 / 3200
#: the GEMV route's)
QFC_GEMV_PER_SM, QFC_GEMV_PER_TILE = 7400, 3200
#: shared memory a block may opt into on Hopper
_SMEM_OPT_IN = 232448


def _qfc_gemv_smem(mt, k):
    """Bytes of dynamic shared memory the GEMV route takes for ``mt`` rows
    of x of ``k`` values: the staged rows and the warps' sums."""
    return (mt * -(-k // 16) * QFC_PITCH + QFC_WARPS * QFC_NR * mt) * 4


def _qfc_gemv_plan(m, n, k, sms=132):
    """(mt, ks) of the GEMV route for x (m, k) and a (n, k) weight on a
    card of ``sms`` SMs, or None where one row of x does not fit a
    block's shared memory: mt rows of x a block (the least power of two
    >= m, at most 4, halved while the staged rows do not fit) and K split
    over ks warps, the least power of two that gives the card ``sms``
    blocks, at most 8 and at most K / 512 (32 units a split, one a
    lane)."""
    mt = min(4, 1 << (max(m, 1) - 1).bit_length())
    while mt > 1 and _qfc_gemv_smem(mt, k) > _SMEM_OPT_IN:
        mt //= 2
    if _qfc_gemv_smem(mt, k) > _SMEM_OPT_IN:
        return None
    units = -(-k // 16)
    ks_max = min(QFC_WARPS, 1 << ((units // 32).bit_length() - 1)) \
        if units >= 32 else 1
    rows = -(-m // mt)
    ks = 1
    while ks < ks_max and \
            -(-n // (QFC_NR * QFC_WARPS // ks)) * rows < sms:
        ks *= 2
    return mt, ks


def _qfc_gemv_wins(m, n, sms=132):
    """Whether the GEMV route is the faster for m rows of x and n output
    channels on a card of ``sms`` SMs. Both routes' times grow with K. The
    GEMV route's grows with m n; the tiled route takes one tile's time
    until its tiles fill the card, then grows with the tiles, padding
    included (N = 33 fills half of each)."""
    tiles = -(-m // 64) * -(-n // 64)
    return m * n <= max(QFC_GEMV_PER_SM * sms, QFC_GEMV_PER_TILE * tiles)


@functools.lru_cache(maxsize=1024)
def _qfc_route(m, n, k, sms=132):
    """(mt, ks): the dequant-fused matmul's route for x (m, k) and a (n, k)
    weight on a card of ``sms`` SMs, from the shapes alone: the GEMV
    route's plan (``_qfc_gemv_plan``) where it is the faster
    (``_qfc_gemv_wins``), else (0, 1), the tiled route (also for a K whose
    single row of x does not fit a block's shared memory)."""
    plan = _qfc_gemv_plan(m, n, k, sms) if _qfc_gemv_wins(m, n, sms) \
        else None
    return plan or (0, 1)


@_wrapper("qfc_matmul")
def qfc_matmul(x2, wq, scale):
    """``x2 @ (wq * scale[:, None]).T``: x2 (M, K) float32, bfloat16 or
    float16, wq (N, K) int8 or float8_e4m3fn, scale (N,) float32 -> (M, N)
    float32, each weight scaled before the product, x widened exactly and
    every product summed in float32 (the TPU kernel's output is float32
    whatever x's type; the op rounds to x's type after the bias). The
    kernel's route comes from the shapes (``_qfc_route``): a GEMV with K
    split over warps for small M, 64 x 64 tiles above. The tiles' rows sit
    on the grid's y axis, so M past ``QFC_CHUNK_M`` (64 x 65535) is
    launched in chunks of rows, a launch each, at pointer offsets."""
    if not _cpu_or_cuda("qfc_matmul", x2):
        return qfc_matmul_plain(x2, wq, scale)
    key = _instance("qfc_matmul", x2, _quant_storage("qfc_matmul", wq))
    _check("qfc_matmul", x=(x2, x2.dtype), weight=(wq, wq.dtype),
           scale=(scale, torch.float32))
    if x2.ndim != 2 or wq.ndim != 2 or wq.shape[1] != x2.shape[1] or \
            tuple(scale.shape) != (wq.shape[0],):
        raise MXNetError(f"qfc_matmul: want x (M, K), weight (N, K) and "
                         f"scale (N,), got {tuple(x2.shape)}, "
                         f"{tuple(wq.shape)}, {tuple(scale.shape)}")
    (m, k), n = x2.shape, wq.shape[0]
    out = x2.new_empty((m, n), dtype=torch.float32)
    sms = _sm_count(x2.get_device())
    for r0 in range(0, max(m, 1), QFC_CHUNK_M):
        rows = min(QFC_CHUNK_M, m - r0)
        _launch("qfc_matmul", key, x2,
                x2.data_ptr() + r0 * k * x2.element_size(), wq.data_ptr(),
                scale.data_ptr(), out.data_ptr() + r0 * n * 4, rows, n, k,
                *_qfc_route(rows, n, k, sms))
    return out


#: the rows of one qfc_matmul launch: its tiled route's 64-row tiles on
#: the grid's y axis (65535 at most)
QFC_CHUNK_M = 64 * 65535


@_wrapper("dequant_rows")
def dequant_rows(wq2, scale):
    """``float(wq2[o, c]) * scale[o]``: wq2 (O, cols) int8 or
    float8_e4m3fn, scale (O,) float32 -> (O, cols) float32, bit for bit
    the plain version's."""
    if not _cpu_or_cuda("dequant_rows", wq2):
        return dequant_rows_plain(wq2, scale)
    key = _instance("dequant_rows", scale,
                    _quant_storage("dequant_rows", wq2))
    _check("dequant_rows", weight=(wq2, wq2.dtype),
           scale=(scale, torch.float32))
    if wq2.ndim != 2 or tuple(scale.shape) != (wq2.shape[0],):
        raise MXNetError(f"dequant_rows: want weight (O, cols) and scale "
                         f"(O,), got {tuple(wq2.shape)}, "
                         f"{tuple(scale.shape)}")
    rows, cols = wq2.shape
    out = wq2.new_empty((rows, cols), dtype=torch.float32)
    _launch("dequant_rows", key, wq2, wq2.data_ptr(), scale.data_ptr(),
            out.data_ptr(), rows, cols)
    return out


#: weights a multi-weight dequant launch's table holds, and values a block
#: dequantizes (csrc/dequant_rows.cu kCap and kChunk)
DEQUANT_CAP, DEQUANT_CHUNK = 512, 16384
#: the multi-weight dequant's launch table (csrc/dequant_rows.cu ``Table``)
#: as a numpy structured type: the same fields in the same order
_DEQUANT_TABLE = np.dtype([
    ("w", np.uint64, DEQUANT_CAP), ("s", np.uint64, DEQUANT_CAP),
    ("out", np.uint64, DEQUANT_CAP), ("n", np.int64, DEQUANT_CAP),
    ("cols", np.int32, DEQUANT_CAP), ("chunk_end", np.int32, DEQUANT_CAP),
    ("vec", np.int32, DEQUANT_CAP), ("count", np.int32), ("pad", np.int32)])


def dequant_rows_multi_plain(weights, scales):
    """``float(w[o, ...]) * s[o]`` for each weight w (O, ...) and its scale
    s (O,): the plain dequant weight by weight, float32 in each weight's
    shape."""
    return [dequantize(w, s) for w, s in zip(weights, scales)]


def _dequant_tables(wptrs, sptrs, optrs, rows, cols, chunk=DEQUANT_CHUNK):
    """(table, blocks) for each launch of a multi-weight dequant over
    weights (rows, cols) at ``wptrs`` with scales at ``sptrs`` into
    outputs at ``optrs``: each table a 0-d array of ``_DEQUANT_TABLE``, at
    most DEQUANT_CAP weights, a block a ``chunk``-value chunk (the
    kernel's kChunk). A weight
    takes the 16-byte route where its columns are a multiple of 16 and its
    weight and output lie on 16-byte boundaries; any other weight the
    kernel's one-value route."""
    wptrs, sptrs, optrs = (np.asarray(p, np.uint64)
                           for p in (wptrs, sptrs, optrs))
    cols = np.asarray(cols, np.int64)
    ns = np.asarray(rows, np.int64) * cols
    vec = (cols % 16 == 0) & (wptrs % 16 == 0) & (optrs % 16 == 0)
    out = []
    for pos, ends in _multi_plan(ns, chunk, DEQUANT_CAP):
        table, k = np.zeros((), _DEQUANT_TABLE), len(pos)
        for field, vals in (("w", wptrs), ("s", sptrs), ("out", optrs),
                            ("n", ns), ("cols", cols), ("vec", vec)):
            table[field][:k] = vals[pos]
        table["chunk_end"][:k] = ends
        table["count"] = k
        out.append((table, int(ends[-1])))
    return out


def _dequant_multi_check(weights, scales):
    """The storage key of a multi-weight dequant on the card: every tensor
    on one CUDA device and contiguous, the weights of one storage type
    (int8 or float8_e4m3fn), each scale float32 (O,) for its weight (O,
    ...). One walk over the pairs; the first pair that breaks a rule
    raises, naming its position."""
    name = "dequant_rows_multi"
    storage = _quant_storage(name, weights[0])
    dev, wdt, f32 = weights[0].get_device(), weights[0].dtype, torch.float32
    for i, (w, sc) in enumerate(zip(weights, scales)):
        if w.dtype is wdt and sc.dtype is f32 and w.ndim >= 1 and \
                w.get_device() == dev == sc.get_device() and \
                w.is_contiguous() and sc.is_contiguous() and \
                sc.shape == w.shape[:1]:
            continue
        if w.dtype is not wdt:
            raise MXNetError(f"{name}: weights[{i}] is {w.dtype}, "
                             f"weights[0] {wdt}: one storage type a call")
        _check(name, **{f"weights[{i}]": (w, wdt),
                        f"scales[{i}]": (sc, f32)})
        if w.get_device() != dev:
            raise MXNetError(f"{name}: weights[{i}] is on {w.device}, "
                             f"weights[0] on {weights[0].device}")
        raise MXNetError(f"{name}: want scales[{i}] (O,) for weights[{i}] "
                         f"(O, ...), got {tuple(sc.shape)} and "
                         f"{tuple(w.shape)}")
    return storage


@_wrapper("dequant_rows_multi")
def dequant_rows_multi(weights, scales):
    """``dequant_rows`` of every weight of the list: weights (O, ...) int8 or
    float8_e4m3fn, one storage type a call, scales (O,) float32 ->
    float32 tensors in the weights' shapes, bit for bit the plain
    version's. On the card one launch for up to DEQUANT_CAP weights (a
    longer list takes more, in order); the outputs are views of one
    allocation, each starting on a 16-byte boundary. CPU tensors run the
    plain version; a list that mixes devices raises. An empty list
    launches nothing."""
    weights, scales = list(weights), list(scales)
    if len(weights) != len(scales):
        raise MXNetError(f"dequant_rows_multi: {len(weights)} weights, "
                         f"{len(scales)} scales")
    if not weights:
        return []
    if not _cpu_or_cuda("dequant_rows_multi", weights[0]):
        bad = next((i for i, t in enumerate(weights + scales)
                    if not t.is_cpu), None)
        if bad is not None:
            raise MXNetError(f"dequant_rows_multi: tensor {bad} of the "
                             "lists is on a CUDA device, weights[0] on the "
                             "CPU")
        return dequant_rows_multi_plain(weights, scales)
    key = "f32:" + _dequant_multi_check(weights, scales)
    shapes = list(map(_SHAPE, weights))
    numels = list(map(torch.Tensor.numel, weights))
    rows = [sh[0] for sh in shapes]
    padded = np.asarray([-(-n // 4) * 4 for n in numels], np.int64)
    offs = np.cumsum(padded) - padded
    flat = torch.empty(int(padded.sum()), dtype=torch.float32,
                       device=weights[0].device)
    for table, blocks in _dequant_tables(
            list(map(torch.Tensor.data_ptr, weights)),
            list(map(torch.Tensor.data_ptr, scales)),
            np.uint64(flat.data_ptr()) + 4 * offs.astype(np.uint64), rows,
            [n // r if r else 0 for n, r in zip(numels, rows)]):
        _launch("dequant_rows_multi", key, flat, table.ctypes.data,
                table.nbytes, blocks)
    return [torch.as_strided(flat, sh, w.stride(), int(off))
            for sh, w, off in zip(shapes, weights, offs)]


# ==========================================================================
# 15. BatchNorm channel statistics (FusedConvBNReLU, training)
# 16. BatchNorm apply + ReLU (FusedConvBNReLU)
# ==========================================================================
def bn_stats_plain(x4):
    """Per-channel (sum, sum of squares) over every axis of x4 (N, C, H, W)
    but the channel, in float32: ``_pl_channel_stats``' function."""
    x = x4.to(torch.float32)
    return x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))


def _check_nchw(name, x4):
    if x4.ndim != 4:
        raise MXNetError(f"{name}: want x (N, C, H, W), got "
                         f"{tuple(x4.shape)}")


#: bn_stats' blocks (csrc/bn_stats.cu): threads a block, units (one load
#: each) a thread keeps in flight and a stage holds a thread, the blocks an
#: SM the grid aims for, and the most splits of N a channel group takes
#: (its blocks are one cluster: the portable most)
BN_STATS_THREADS, BN_STATS_LOADS, BN_STATS_BLOCKS_PER_SM = 256, 4, 4
BN_STATS_SPLITS = 8
#: bn_stats' routes: the kernel's ``route`` argument
BN_PLANES, BN_SLABS = 0, 1


def _pow2_floor(v):
    return 1 << (max(int(v), 1).bit_length() - 1)


def _bn_stats_plan(n, c, hw, itemsize, aligned, sms):
    """(route, vec, group, stage_rows, rows, splits) of a ``bn_stats``
    launch over x (n, c, hw) of ``itemsize``-byte values, 16-byte aligned
    or not, on a card of ``sms`` SMs; a function of these alone, so a shape
    always sums in one order. Planes (``BN_PLANES``: one channel a block,
    its (n, c) planes read ``vec`` values a load) where HW is a multiple of
    the 16-byte unit and x aligned; else slabs (``BN_SLABS``: ``group``
    channels a block, a power of two with group * HW a multiple of the
    unit, so each row's slab of the group is one aligned run; about HW / 6
    lanes a channel, at most 32, and no more channels than leave the grid
    its blocks at BN_STATS_SPLITS splits; a stage of ``stage_rows`` rows at
    most BN_STATS_LOADS units a thread) where the unit allows; else planes
    one value a load. N is cut into ``splits`` splits of ``rows`` rows, at
    most BN_STATS_SPLITS, so that the grid holds about
    BN_STATS_BLOCKS_PER_SM blocks an SM."""
    vec = 16 // itemsize
    cap = BN_STATS_LOADS * BN_STATS_THREADS       # units a stage holds
    slots = BN_STATS_BLOCKS_PER_SM * sms
    route, group, stage = BN_PLANES, 1, 0
    if not (aligned and hw % vec == 0):
        g0 = vec // math.gcd(hw, vec) if hw else vec
        if aligned and hw and (c * hw) % vec == 0 and g0 * hw <= cap * vec:
            lanes = min(32, _pow2_floor(hw // 6))
            group = max(g0, min(BN_STATS_THREADS // lanes,
                                1 << (max(c, 1) - 1).bit_length(),
                                _pow2_floor(cap * vec // hw),
                                _pow2_floor(c * BN_STATS_SPLITS // slots)))
            route = BN_SLABS
            stage = max(1, cap // (group * hw // vec))
        else:
            vec = 1
    groups = -(-c // group)
    splits = max(1, min(n, BN_STATS_SPLITS, slots // max(groups, 1)))
    rows = -(-n // splits) if n > 0 else 0
    splits = -(-n // rows) if rows else 1
    if route == BN_SLABS:
        stage = min(stage, max(rows, 1))
    return route, vec, group, stage, rows, splits


_BN_PLAN = {}          # (device index, N, C, HW, itemsize, aligned) -> the
                       # plan


@_wrapper("bn_stats")
def bn_stats(x4):
    """Per-channel (sum, sum of squares) of x4 (N, C, H, W) float32,
    bfloat16 or float16 -> two (C,) float32 (views of one (2, C) buffer),
    each value widened exactly and x * x rounded before it is added. One
    launch a call, the splits of each channel group one thread-block
    cluster whose partials are added in split order inside it (no float
    atomics, no workspace): repeated calls give the same bits."""
    if not _cpu_or_cuda("bn_stats", x4):
        return bn_stats_plain(x4)
    key = _instance("bn_stats", x4)
    _check("bn_stats", x=(x4, x4.dtype))
    _check_nchw("bn_stats", x4)
    n, c, h, w = x4.shape
    ptr = x4.data_ptr()
    dev = x4.get_device()
    pk = (dev, n, c, h * w, x4.element_size(), ptr % 16 == 0)
    plan = _BN_PLAN.get(pk)
    if plan is None:
        plan = _BN_PLAN[pk] = _bn_stats_plan(*pk[1:], _sm_count(dev))
    route, vec, group, stage, rows, splits = plan
    out = x4.new_empty((2, c), dtype=torch.float32)
    _launch("bn_stats", key, x4, ptr, out.data_ptr(), n, c, h * w, route,
            vec, group, stage, rows, splits)
    return out[0], out[1]


def bn_apply_relu_plain(x4, scale, shift):
    """``max(x4 * scale[c] + shift[c], 0)`` over x4 (N, C, H, W) in
    float32, the product and the sum rounded separately, stored in x4's
    type: ``_pl_apply_bn_relu``' function."""
    bshape = (1, -1, 1, 1)
    z = x4.to(torch.float32) * scale.reshape(bshape) + shift.reshape(bshape)
    return torch.maximum(z, torch.zeros((), dtype=z.dtype, device=z.device)
                         ).to(x4.dtype)


@_wrapper("bn_apply_relu")
def bn_apply_relu(x4, scale, shift):
    """``max(x4 * scale[c] + shift[c], 0)``: x4 (N, C, H, W) float32,
    bfloat16 or float16, scale and shift (C,) float32 -> (N, C, H, W) in
    x4's dtype, float32 arithmetic rounded once, bit for bit the plain
    version's."""
    if not _cpu_or_cuda("bn_apply_relu", x4):
        return bn_apply_relu_plain(x4, scale, shift)
    key = _instance("bn_apply_relu", x4)
    _check("bn_apply_relu", x=(x4, x4.dtype), scale=(scale, torch.float32),
           shift=(shift, torch.float32))
    _check_nchw("bn_apply_relu", x4)
    n, c, h, w = x4.shape
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise MXNetError(f"bn_apply_relu: scale and shift must be ({c},), "
                         f"got {tuple(scale.shape)}, {tuple(shift.shape)}")
    y = torch.empty_like(x4)
    _launch("bn_apply_relu", key, x4, x4.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), y.data_ptr(), n, c, h * w)
    return y


def _cbr_scale_shift(attrs, gamma, mean, var, beta):
    """The per-channel scale and shift of the apply pass, on (C,) vectors,
    float32: ``scale = gamma / sqrt(var + eps)``, ``shift = beta - mean *
    scale`` (gamma read as ones under ``fix_gamma``). Under
    ``compute_dtype`` the moving statistics arrive in bfloat16, and
    ``rsqrt(var + eps)`` is then taken in bfloat16 and widened, as in the
    JAX package's ``_cbr_scale_shift``."""
    if parse_bool(attrs.get("fix_gamma", True)):
        gamma = torch.ones_like(gamma)
    scale = torch.rsqrt(var + weak_scalar(
        parse_float(attrs.get("eps", 1e-3)), var)) * gamma.to(torch.float32)
    return scale, beta.to(torch.float32) - mean * scale


def conv_bn_relu(attrs, data, weight, gamma, beta, moving_mean, moving_var,
                 is_train):
    """FusedConvBNReLU's forward through the two kernels, as the JAX
    package's ``_cbr_pallas_impl``: the convolution (cuDNN on the card),
    then in training without ``use_global_stats`` ``bn_stats`` and the
    one-pass biased variance ``max(sq / cnt - mean^2, 0)`` with the
    momentum update of the moving statistics, else the moving statistics;
    then ``bn_apply_relu``. Returns (y, new_moving_mean, new_moving_var).
    bfloat16 data (``compute_dtype``) takes the kernels' bfloat16
    instances; the moving statistics then arrive in bfloat16 and move by
    ``momentum_update``, as ``BatchNorm``'s do."""
    conv = nn_convolution(attrs, data, weight).contiguous()
    if is_train and not parse_bool(attrs.get("use_global_stats", False)):
        n, _c, h, w = conv.shape
        cnt = float(n * h * w)
        s, sq = bn_stats(conv)
        mean = s / cnt
        var = torch.clamp(sq / cnt - mean * mean, min=0.0)
        momentum = parse_float(attrs.get("momentum", 0.9))
        new_mean = momentum_update(momentum, moving_mean, mean)
        new_var = momentum_update(momentum, moving_var, var)
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    scale, shift = _cbr_scale_shift(attrs, gamma, mean, var, beta)
    return bn_apply_relu(conv, scale, shift), new_mean, new_var


class _ConvBNReLUFn(torch.autograd.Function):
    """Forward: ``conv_bn_relu`` (the two kernels). Backward: the JAX
    package's ``bwd`` of ``_cbr_make`` — no backward kernel exists there,
    so the plain composition (``cbr_plain``: convolution, BatchNorm with
    its two-pass statistics, ReLU) is recomputed and differentiated with
    respect to data, weight, gamma and beta; the moving statistics get no
    gradient. Gradients are not materialized: the moving statistics'
    cotangents arrive as None, not as zeros filled on every backward (and
    y's as None where nothing reads y)."""

    @staticmethod
    def forward(ctx, data, weight, gamma, beta, moving_mean, moving_var,
                attrs, is_train):
        y, new_mean, new_var = conv_bn_relu(attrs, data, weight, gamma, beta,
                                            moving_mean, moving_var, is_train)
        ctx.save_for_backward(data, weight, gamma, beta, moving_mean,
                              moving_var)
        ctx.attrs, ctx.is_train = attrs, is_train
        ctx.mark_non_differentiable(new_mean, new_var)
        ctx.set_materialize_grads(False)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        if gy is None:
            return (None,) * 8
        data, weight, gamma, beta, mm, mv = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(r)
                      for t, r in zip((data, weight, gamma, beta), need)]
            y, _ = cbr_plain(ctx.attrs, *leaves, mm, mv, ctx.is_train)
            got = iter(torch.autograd.grad(
                y, [t for t, r in zip(leaves, need) if r], gy,
                allow_unused=True))
        return tuple(next(got) if r else None for r in need) + \
            (None,) * 4


def conv_bn_relu_fn(attrs, data, weight, gamma, beta, moving_mean,
                    moving_var, is_train):
    """Differentiable ``conv_bn_relu``: (y, new_moving_mean,
    new_moving_var)."""
    return _ConvBNReLUFn.apply(data, weight, gamma, beta, moving_mean,
                               moving_var, attrs, bool(is_train))


# ==========================================================================
# 17. threefry2x32: Dropout, and the uniform draws of the samplers and
#     initializers (no TPU kernel: jax.random's threefry in XLA)
# ==========================================================================
@_wrapper("dropout")
def dropout(x, key, keep):
    """Dropout's forward over ``x`` (float32, bfloat16 or float16) under
    the key ``key`` (two uint32 words), keeping each element with
    probability ``keep``: (y, mask) in x's dtype, one launch on the card
    that hashes each element's index with threefry2x32 and writes y and
    the mask, bit for bit ``dropout_plain``."""
    if not _cpu_or_cuda("dropout", x):
        return dropout_plain(x, key, keep)
    inst = _instance("dropout", x)
    _check("dropout", x=(x, x.dtype))
    y, mask = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        k0, k1 = _random.key_words(key)
        _launch("dropout", inst, x, x.data_ptr(), y.data_ptr(),
                mask.data_ptr(), x.numel(), k0, k1,
                float(np.float32(keep)), dropout_mask_value(keep, x.dtype))
    return y, mask


class _DropoutFn(torch.autograd.Function):
    """Forward: the Dropout kernel, (y, mask) with the mask not
    differentiable. Backward: ``ct * mask``, the forward's own mask (the
    backward never draws)."""

    @staticmethod
    def forward(ctx, x, key, keep):
        ctx.set_materialize_grads(False)
        y, mask = dropout(x, key, keep)
        ctx.save_for_backward(mask)
        ctx.mark_non_differentiable(mask)
        return y, mask

    @staticmethod
    def backward(ctx, ct, _ct_mask):
        if ct is None:
            return None, None, None
        mask, = ctx.saved_tensors
        return ct * mask, None, None


def dropout_fn(x, key, keep):
    """Differentiable ``dropout``: (y, mask)."""
    return _DropoutFn.apply(x, key, float(keep))


def uniform_plain(key, shape, lo=0.0, hi=1.0, transform=_random.UNIFORM,
                  device=None, dtype=torch.float32):
    """The draws of ``uniform``: ``mx.random.draw``."""
    return _random.draw(key, shape, transform, lo, hi, dtype, device)


@_wrapper("uniform")
def uniform(key, shape, lo=0.0, hi=1.0, transform=_random.UNIFORM,
            device=None, dtype=torch.float32):
    """Draws of ``shape`` under ``key`` on ``device`` (default the CPU), of
    ``dtype`` (float32, bfloat16 or float16): uniform in [lo, hi) (XLA's
    arithmetic in the type: ``max(lo, fma(u, hi - lo, lo))`` in float32),
    or ``mx.random.NORMAL`` (``sqrt(2) * erfinv`` of a draw in
    (nextafter(-1, 0), 1)) or ``EXPONENTIAL`` (``-log1p(-u)``), whose
    ranges are their own. One launch on the card, bit for bit
    ``mx.random.draw`` for uniform draws; the plain version on the CPU."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cpu":
        return uniform_plain(key, shape, lo, hi, transform, dtype=dtype)
    if device.type != "cuda":
        raise MXNetError(f"uniform: no kernel or plain version for device "
                         f"{device}")
    if transform == _random.NORMAL:
        lo, hi = _random.normal_lo(dtype), 1.0
    elif transform == _random.EXPONENTIAL:
        lo, hi = 0.0, 1.0
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    inst = _instance("uniform", out)
    if out.numel():
        k0, k1 = _random.key_words(key)
        if dtype == torch.float32:
            lo_t, hi_t = np.float32(lo), np.float32(hi)
            span = np.float32(hi_t - lo_t)
        else:       # the type's lo and hi - lo, as the plain version
            lo_t = torch.tensor(lo, dtype=dtype)
            span = torch.tensor(hi, dtype=dtype) - lo_t
        _launch("uniform", inst, out, out.data_ptr(), out.numel(), k0, k1,
                float(lo_t), float(span), int(transform))
    return out


def _sampler_cuda(name):
    """A sampler on the card (``tensor.sample``): its uniform, normal and
    exponential draws from the threefry kernel, on the current device."""
    def forward(attrs, inputs, aux, is_train, rng):
        dev = torch.device("cuda", torch.cuda.current_device())
        return [tensor_sample(
            name, attrs, rng, dev,
            lambda key, shape, lo, hi, transform, dtype: uniform(
                key, shape, lo, hi, transform, dev, dtype))], []
    return forward


def _dropout_cuda(attrs, inputs, aux, is_train, rng):
    """Dropout on the card: the threefry kernel's y and mask (an
    autograd.Function whose backward multiplies by the mask)."""
    x = inputs[0]
    p = parse_float(attrs.get("p", 0.5))
    if not is_train or p <= 0.0:
        return [x, torch.ones_like(x)], []
    y, mask = dropout_fn(x.contiguous(), rng, 1.0 - p)
    return [y, mask], []


def _counters():
    """(the launch counters in wrapper order, {counter: its kernel})."""
    kernel_of = {}
    for name, kernel in _WRAPPER_KERNEL.items():
        for key in _SPECS[kernel][1]:
            kernel_of.setdefault(_counter(name, key), kernel)
    return tuple(kernel_of), kernel_of


#: the launch counters: one per kernel and data type of its instances
#: (``decode_attention_fp8`` for the fp8-cache reads), and the kernel
#: (``_SPECS`` key) behind each
COUNTERS, _COUNTER_KERNEL = _counters()
_LAUNCHES = dict.fromkeys(COUNTERS, 0)


# ==========================================================================
# the "cuda" variants of the ops these kernels serve (attention_decode's
# and attention's variants live with the ops, in rtc.py)
# ==========================================================================
def _softmax_output_cuda(attrs, inputs, aux, is_train, rng):
    """SoftmaxOutput on the card: the softmax kernel forward, the
    cross-entropy kernel backward (an autograd.Function, so the variant
    trains). Labels go to the kernel as float32, as the TPU path casts
    them. ``multi_output`` (softmax over axis 1, a label a position) runs
    the same two kernels over the rows of the data with axis 1 moved last,
    (N * d..., C) (``loss.softmax_output``)."""
    data, label = inputs
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


def _qfc_cuda(attrs, inputs, aux, is_train, rng):
    """QuantizedFullyConnected on the card: the dequant-fused matmul
    kernel (its instance of the data's dtype), then the bias add in
    float32 and one rounding to the data's dtype (after the kernel, as in
    the JAX package's Pallas variant). Under ``compute_dtype`` the scale
    arrives in the compute dtype and is widened exactly."""
    data, weight, scale = inputs[:3]
    if data.ndim > 2 and parse_bool(attrs.get("flatten", True)):
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    out = qfc_matmul(data.reshape(-1, data.shape[-1]).contiguous(), weight,
                     scale.to(torch.float32))
    if len(inputs) > 3:
        out = out + inputs[3].to(torch.float32)
    return [out.reshape(tuple(lead) + (weight.shape[0],)).to(data.dtype)], []


def _qconv_cuda(attrs, inputs, aux, is_train, rng):
    """QuantizedConvolution on the card where the graph computes its
    weight: the row-dequant kernel rebuilds the float32 weight, then
    cuDNN convolves in the data's dtype (the weight cast to it, as the
    JAX package's convolution casts it; the convolution stays a library
    call, as it stays XLA's in the JAX package). Under ``compute_dtype``
    the scale arrives in the compute dtype and is widened exactly. A conv
    whose weight and scale are variables takes the op's prologue
    (``_qconv_prologue``) instead."""
    data, weight, scale = inputs[:3]
    wf = dequant_rows(weight.reshape(weight.shape[0], -1),
                      scale.to(torch.float32))
    return [nn_convolution(attrs, data, wf.reshape(weight.shape),
                           inputs[3] if len(inputs) > 3 else None)], []


def _qconv_prologue(groups):
    """QuantizedConvolution's per-forward prologue: the float32 weights of
    all the forward's nodes whose weight and scale are variables, from one
    ``dequant_rows_multi`` call (one launch on the card; the plain version
    on the CPU), each scale in a compute dtype widened exactly first."""
    return dequant_rows_multi(
        [w for w, _ in groups],
        [s if s.dtype is torch.float32 else s.to(torch.float32)
         for _, s in groups])


def _qconv_prepared(attrs, inputs, aux, is_train, rng):
    """QuantizedConvolution on the float32 weight its prologue made: the
    convolution alone, in the data's dtype (cuDNN on the card)."""
    return [nn_convolution(attrs, inputs[0], inputs[1],
                           inputs[2] if len(inputs) > 2 else None)], []


def _cbr_cuda(attrs, inputs, aux, is_train, rng):
    """FusedConvBNReLU on the card: the two BatchNorm kernels around a
    cuDNN convolution (the JAX package leaves the convolution to XLA too),
    as an autograd.Function whose backward recomputes the plain
    composition."""
    data, weight, gamma, beta = inputs
    if data.dtype not in _STORAGE:
        raise MXNetError(f"FusedConvBNReLU: the CUDA kernels take float32, "
                         f"bfloat16 or float16 data, got {data.dtype}")
    if data.ndim != 4:
        raise MXNetError(f"FusedConvBNReLU: the CUDA kernels take NCHW "
                         f"data, got {tuple(data.shape)}")
    y, new_mean, new_var = conv_bn_relu_fn(attrs, data, weight, gamma, beta,
                                           aux[0], aux[1], is_train)
    return [y], [new_mean, new_var]


_UPDATE_BWD = ("a gradient of the update itself, which the JAX package "
               "takes through its composition")
_QUANT_BWD = ("a gradient of a quantized op: quantized graphs are an "
              "inference tier, which the JAX package gives no gradient "
              "either")
get_op("FusedBiasGeLU").add_variant("cuda", _bias_gelu_cuda)
get_op("Dropout").add_variant("cuda", _dropout_cuda)
for _name in ("_random_uniform", "_random_normal", "_random_gamma",
              "_random_exponential", "_random_poisson",
              "_random_negative_binomial",
              "_random_generalized_negative_binomial"):
    get_op(_name).add_variant("cuda", _sampler_cuda(_name))
get_op("FusedConvBNReLU").add_variant("cuda", _cbr_cuda)
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
get_op("QuantizedConvolution").set_prologue((1, 2), _qconv_prologue,
                                            _qconv_prepared)
