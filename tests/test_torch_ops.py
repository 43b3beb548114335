"""Per-op forward parity: the PyTorch port's registry against the JAX
package's, on the same numpy-seeded inputs (CPU, plain versions).

Covers every op the decode graph binds, plus ``attention_decode``'s
state contract: RoPE + cache write + cursor advance for the scalar and
per-slot layouts, S=1 and S>1 windows, with cache positions the step did
not write bit-identical to their old values and the written rows within
float32 tolerance (2e-5; the rotary trig is computed by each framework).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops.registry import get_op as jax_op
import mxnet_tpu  # noqa: F401 — registers attention / attention_decode

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import get_op as torch_op

TOL = 2e-5


def _run_both(name, kwargs, inputs, aux=()):
    """Forward ``name`` through both registries; returns (jax outs, jax
    new aux, torch outs, torch new aux) as numpy."""
    jop, top = jax_op(name), torch_op(name)
    j_out, j_aux = jop.forward(jop.normalize_attrs(kwargs),
                               [jnp.asarray(x) for x in inputs],
                               [jnp.asarray(a) for a in aux], False, None)
    t_out, t_aux = top.forward(top.normalize_attrs(kwargs),
                               [torch.tensor(x) for x in inputs],
                               [torch.tensor(a) for a in aux], False, None)
    return ([np.asarray(o) for o in j_out], [np.asarray(a) for a in j_aux],
            [o.numpy() for o in t_out], [a.numpy() for a in t_aux])


def _assert_same(name, kwargs, inputs, tol=TOL):
    j_out, _, t_out, _ = _run_both(name, kwargs, inputs)
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


RS = np.random.RandomState(0)
X4 = RS.randn(2, 3, 4, 6).astype(np.float32)


@pytest.mark.parametrize("shape", [(-3, 0, 0), (-1, 4, 6), (-3, -3), (0, -1),
                                   (-3, -2)])
def test_reshape_codes(shape):
    _assert_same("Reshape", {"shape": shape}, [X4])


@pytest.mark.parametrize("kwargs", [{"axes": (0, 2, 1, 3)}, {}])
def test_transpose(kwargs):
    _assert_same("transpose", kwargs, [X4])


@pytest.mark.parametrize("kwargs", [{"axis": 1, "begin": 1, "end": 3},
                                    {"axis": 3, "begin": 2, "end": None},
                                    {"axis": 2, "begin": 0, "end": -1}])
def test_slice_axis(kwargs):
    _assert_same("slice_axis", kwargs, [X4])


@pytest.mark.parametrize("kwargs", [{"transpose_b": True}, {}])
def test_dot(kwargs):
    a = RS.randn(5, 8).astype(np.float32)
    b = RS.randn(7, 8).astype(np.float32) if kwargs else \
        RS.randn(8, 7).astype(np.float32)
    _assert_same("dot", kwargs, [a, b])


@pytest.mark.parametrize("name", ["_plus", "elemwise_add"])
def test_elementwise_add(name):
    _assert_same(name, {}, [X4, X4 * 2])


def test_broadcast_add_and_expand_dims():
    _assert_same("broadcast_add", {}, [X4, X4[:1, :1]])
    _assert_same("expand_dims", {"axis": 0}, [X4[0]])


@pytest.mark.parametrize("kwargs", [{"start": 0, "stop": 8.0},
                                    {"start": 5.0}])
def test_arange(kwargs):
    _assert_same("_arange", kwargs, [])


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_embedding(scale):
    w = RS.randn(32, 16).astype(np.float32)
    ids = RS.randint(0, 32, (2, 3)).astype(np.int32)
    _assert_same("Embedding", {"input_dim": 32, "output_dim": 16,
                               "scale": scale}, [ids, w], tol=0)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected(no_bias):
    x = RS.randn(6, 16).astype(np.float32)
    w = RS.randn(12, 16).astype(np.float32)
    ins = [x, w] + ([] if no_bias else [RS.randn(12).astype(np.float32)])
    _assert_same("FullyConnected", {"num_hidden": 12, "no_bias": no_bias},
                 ins)


def test_layernorm_three_outputs():
    x = RS.randn(2, 5, 32).astype(np.float32)
    _assert_same("LayerNorm", {}, [x, RS.randn(32).astype(np.float32),
                                   RS.randn(32).astype(np.float32)])


def test_rope():
    _assert_same("RoPE", {"base": 10000.0, "offset": 3},
                 [RS.randn(2, 2, 5, 8).astype(np.float32)])


def test_fused_bias_gelu():
    _assert_same("FusedBiasGeLU", {}, [RS.randn(4, 3, 24).astype(np.float32),
                                       RS.randn(24).astype(np.float32)])


def test_attention_causal():
    q, k, v = (RS.randn(2, 2, 6, 8).astype(np.float32) for _ in range(3))
    _assert_same("attention", {"causal": True}, [q, k, v])


# ------------------------------------------------------- attention_decode
B, H, DH, C = 3, 2, 8, 16


def _decode_case(per_slot, S, cursors, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S, DH).astype(np.float32) for _ in range(3))
    kc, vc = (rs.randn(B, H, C, DH).astype(np.float32) for _ in range(2))
    cur = np.asarray(cursors, np.int32).reshape((B, 1) if per_slot
                                                else (1,))
    kwargs = {"capacity": C, "per_slot": per_slot, "rope": True}
    return kwargs, [q, k, v], [kc, vc, cur]


def _written(per_slot, S, cursors):
    """(b, position) pairs the step writes: cursor..cursor+S-1 per slot
    (the scalar layout writes the same positions in every row)."""
    cur = np.broadcast_to(np.asarray(cursors).reshape(-1), (B,))
    return {(b, int(p) + s) for b in range(B) for s in range(S)
            for p in [cur[b]] if int(p) + s < C}


@pytest.mark.parametrize("per_slot,S,cursors", [
    (True, 1, [0, 7, C - 1]),
    (True, 4, [0, 5, C - 4]),
    (False, 1, [6]),
    (False, 3, [C - 3]),
])
def test_attention_decode_write_read_and_cursor(per_slot, S, cursors):
    kwargs, ins, aux = _decode_case(per_slot, S, cursors, seed=S)
    j_out, j_aux, t_out, t_aux = _run_both("attention_decode", kwargs, ins,
                                           aux)
    np.testing.assert_allclose(j_out[0], t_out[0], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(j_aux[2], t_aux[2])       # cursor
    assert t_aux[2].dtype == np.int32
    np.testing.assert_array_equal(
        t_aux[2].reshape(-1), np.asarray(cursors).reshape(-1) + S)
    written = _written(per_slot, S, cursors)
    for new_j, new_t, old in zip(j_aux[:2], t_aux[:2], aux[:2]):
        for b in range(B):
            for p in range(C):
                if (b, p) in written:
                    np.testing.assert_allclose(new_j[b, :, p],
                                               new_t[b, :, p], atol=TOL,
                                               rtol=TOL)
                else:   # untouched: bit-identical to before the step
                    assert np.array_equal(new_t[b, :, p], old[b, :, p])
                    assert np.array_equal(new_j[b, :, p], old[b, :, p])


def test_attention_decode_cursor_past_capacity_writes_nothing():
    """A retired slot may advance past capacity; its S=1 one-hot write
    then matches no position (no clamped write), as in the JAX package."""
    top = torch_op("attention_decode")
    kwargs, ins, aux = _decode_case(True, 1, [0, 3, 2], seed=9)
    kc, vc, cur = (torch.tensor(a) for a in aux)
    old_k = kc.clone()
    cur[1, 0] = C + 2           # past capacity
    # the overflow check guards CPU cursors, so call the write helper
    from mxnet_tpu_torch.rtc import _decode_rope_write
    _decode_rope_write(top.normalize_attrs(kwargs),
                       *(torch.tensor(x) for x in ins), kc, vc,
                       cur.reshape(B), per_slot=True)
    assert torch.equal(kc[1], old_k[1])
    assert not torch.equal(kc[0], old_k[0])


@pytest.mark.parametrize("per_slot", [True, False])
def test_attention_decode_overflow_raises_on_host_cursor(per_slot):
    cursors = [0, C, 1] if per_slot else [C - 1]
    kwargs, ins, aux = _decode_case(per_slot, 2 if not per_slot else 1,
                                    cursors, seed=3)
    top = torch_op("attention_decode")
    with pytest.raises(MXNetError, match="overflow"):
        top.forward(top.normalize_attrs(kwargs),
                    [torch.tensor(x) for x in ins],
                    [torch.tensor(a) for a in aux], False, None)


def test_attention_decode_is_inference_only():
    kwargs, ins, aux = _decode_case(True, 1, [0, 0, 0], seed=4)
    top = torch_op("attention_decode")
    with pytest.raises(MXNetError, match="inference"):
        top.forward(top.normalize_attrs(kwargs),
                    [torch.tensor(x) for x in ins],
                    [torch.tensor(a) for a in aux], True, None)


def test_imperative_invoke_writes_aux_back():
    """mx.nd.attention_decode advances the cursor cell it was handed."""
    kwargs, ins, aux = _decode_case(True, 1, [0, 1, 2], seed=5)
    ctx = mxt.cpu()
    nd_in = [mxt.nd.array(x, ctx=ctx) for x in ins]
    nd_aux = [mxt.nd.array(a, ctx=ctx, dtype=a.dtype) for a in aux]
    out = mxt.nd.attention_decode(*nd_in, *nd_aux, **kwargs)
    assert out.shape == (B, H, 1, DH)
    np.testing.assert_array_equal(nd_aux[2].asnumpy().reshape(-1),
                                  [1, 2, 3])
