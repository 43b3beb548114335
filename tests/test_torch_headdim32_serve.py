"""Attention at the head dims between the kernels' tiles (16, 32, 48, 80,
96 and 112): a small transformer (2 heads of Dh, 2 layers) through
``serve_decoder`` against ``mxnet_tpu`` on the CPU: the JAX package's
greedy token chains, the JAX side lowered as its XLA composition and as
its Pallas kernels (``tests/test_torch_headdim32.py`` describes the
kernels).
"""
import numpy as np

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.serve import FakeClock as JaxFakeClock

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serve import FakeClock

from test_torch_headdim32 import CPU, dh, jax_tier  # noqa: F401 (fixtures)

V, L, H, CAP, T, B = 64, 2, 2, 16, 32, 4


def _decode_params(D):
    sym = ttfm.get_decode_symbol(vocab_size=V, d_model=D, n_layer=L,
                                 n_head=H, capacity=CAP, per_slot=True)
    shapes, _, _ = sym.infer_shape(data=(1, 1))
    rs = np.random.RandomState(0)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        scale = 0.3 if name.endswith("weight") else 0.1
        base = 1.0 if name.endswith("gamma") else 0.0
        out[name] = (base + scale * rs.randn(*shape)).astype(np.float32)
    return out


def _drive(sched, clock, prompts):
    handles = []
    for i, (n, iters) in enumerate([(2, 3), (2, 2)]):
        for j in range(n):
            handles.append(sched.submit(prompts[2 * i + j],
                                        max_new_tokens=4 + 2 * i + j))
        sched.pump(max_iterations=iters)
        clock.advance(0.01)
    sched.pump()
    return [h.result(timeout=0).tolist() for h in handles]


def test_serve_decoder_chains_match_jax(jax_tier, dh):
    """Greedy chains of four staggered requests at ladder [1, 2, 4], d_model
    2 Dh."""
    D = H * dh
    decode_params = _decode_params(D)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V, rs.randint(1, 5)).tolist() for _ in range(4)]
    kw = dict(vocab_size=V, d_model=D, n_layer=L, n_head=H, capacity=CAP,
              per_slot=True)
    jclock, tclock = JaxFakeClock(), FakeClock()
    jsched = mx.serve.serve_decoder(
        jtfm.get_decode_symbol(**kw),
        {k: mx.nd.array(v) for k, v in decode_params.items()},
        name=f"dh{dh}", ladder=[1, 2, 4], clock=jclock, start=False,
        context=mx.cpu())
    tsched = mxt.serve.serve_decoder(
        ttfm.get_decode_symbol(**kw),
        mxt.convert.params_from_numpy(decode_params, CPU), name=f"dh{dh}",
        ladder=[1, 2, 4], clock=tclock, start=False, context=CPU)
    chains = _drive(tsched, tclock, prompts)
    assert chains == _drive(jsched, jclock, prompts)
    assert [len(c) for c in chains] == [4, 5, 6, 7]
