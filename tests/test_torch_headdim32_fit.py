"""Attention at the head dims between the kernels' tiles (16, 32, 48, 80,
96 and 112): one ``Module`` training step of a small transformer
(2 heads of Dh, 2 layers) against ``mxnet_tpu`` on the CPU, the JAX side
lowered as its XLA composition and as its Pallas kernels: every
parameter's gradient within 2e-5 of the JAX package's
(``tests/test_torch_headdim32.py`` describes the kernels).
"""
import numpy as np

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jtfm

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import transformer as ttfm

from test_torch_headdim32 import CPU, _close, dh, jax_tier  # noqa: F401

V, L, H, T, B = 64, 2, 2, 32, 4


def test_fit_step_gradients_match_jax(jax_tier, dh):
    """One training step's gradients from the same Xavier start (carried
    across as numpy) at d_model 2 Dh, every parameter's within 2e-5."""
    D = H * dh
    it = jtfm.SyntheticLMIter(V, B, T, 1, seed=2)
    jmod = mx.mod.Module(jtfm.get_symbol(V, D, L, H, T), context=mx.cpu())
    jmod.bind(it.provide_data, it.provide_label)
    jmod.init_params(mx.initializer.Xavier())
    start = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    jbatch = next(iter(it))
    jmod.forward(jbatch, is_train=True)
    jmod.backward()
    jgrads = {k: v.asnumpy()
              for k, v in jmod._exec_group.executor.grad_dict.items()
              if k in start}

    tit = ttfm.SyntheticLMIter(V, B, T, 1, seed=2)
    tmod = mxt.mod.Module(ttfm.get_symbol(V, D, L, H, T), context=CPU)
    tmod.bind(tit.provide_data, tit.provide_label)
    tmod.init_params(arg_params=mxt.convert.params_from_numpy(start, CPU))
    tmod.forward(next(iter(tit)), is_train=True)
    tmod.backward()
    tgrads = tmod._exec_group.executor.grad_dict
    assert sorted(jgrads) == sorted(k for k in tgrads if k in start)
    for k, g in jgrads.items():
        assert np.abs(g).max() > 0, k
        _close(tgrads[k].asnumpy(), g, msg=k)
