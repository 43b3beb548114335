"""The float32 flash-attention kernel's order of work (``csrc/flash_attention.cu``,
namespace ``cc``) in plain PyTorch, for the CPU tests
(``tests/test_torch_flash_f32.py``). Torch only.

For every (b, h) row and query tile of ``TILES[tile][0]`` rows, the key
tiles of ``TILES[tile][1]`` keys (``tile``: the smallest tile head dim that
holds Dh, whose columns past Dh are zeros) are walked in order from key
0, up to the tile's last live key under the causal mask (tiles wholly
above the diagonal are not visited); each tile's scores are (q * scale) .
k in float32, masked (-inf) where a key is past Tk or above the diagonal,
and go through the TPU kernel's online update with its guards (m_safe,
corr, p = 0 for a non-finite score); P . V adds the tile's keys. The
normalized mode returns acc / max(l, 1e-30), the partial mode (acc, m, l);
a normalized row that sees no key under the causal mask (q_off + t <
k_off, as Tq > Tk gives with q_off = Tk - Tq) is NaN. Above Dh 128 (the
wide route) the tiles are Dh 128's and a tile's scores the sum of their
128-column steps, in step order.
Every value is float32; a score or a tile's P . V is a float32 dot product
in torch's order, not the kernel's FMA order, so the two agree within a
float32 tolerance, not bit for bit.
"""
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck

#: the kernel's tiles, ``cc::Tile<Dh>``'s kBq and kBk: head dim -> (query
#: rows a block, keys a K / V tile); ``tests/test_torch_flash_f32.py``
#: holds them to the source
TILES = {32: (128, 64), 64: (64, 64), 128: (64, 32)}


def flash_f32(q, k, v, q_off=0, k_off=0, causal=False, scale=None,
              partial=False):
    """q (B, H, Tq, Dh), k and v (B, H, Tk, Dh) float32 CPU tensors -> the
    kernel's output: (B, H, Tq, Dh), or (acc, m, l) when ``partial``."""
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    bq, bk = TILES[ck.head_tile(Dh)]
    step = ck.HEAD_TILES[-1]
    if scale is None:
        scale = float(Dh) ** -0.5
    qs = (q.to(torch.float32) * scale).reshape(B * H, Tq, Dh)
    kf = k.to(torch.float32).reshape(B * H, Tk, Dh)
    vf = v.to(torch.float32).reshape(B * H, Tk, Dh)
    shift = q_off - k_off
    acc = torch.zeros(B * H, Tq, Dh)
    m = torch.full((B * H, Tq), float("-inf"))
    l = torch.zeros(B * H, Tq)
    for q0 in range(0, Tq, bq):
        rows = slice(q0, min(Tq, q0 + bq))
        qp = torch.arange(q0, min(Tq, q0 + bq))
        k_end = min(Tk, q0 + bq + shift) if causal else Tk
        mt, lt, at = m[:, rows], l[:, rows], acc[:, rows]
        for k0 in range(0, max(k_end, 0), bk):
            kp = torch.arange(k0, k0 + bk)
            kc = torch.clamp(kp, max=Tk - 1)
            s = sum(torch.einsum("bqd,bkd->bqk", qs[:, rows, c0:c0 + step],
                                 kf[:, kc, c0:c0 + step])
                    for c0 in range(0, Dh, step))
            live = (kp[None, :] < Tk) & \
                ((kp[None, :] <= qp[:, None] + shift) if causal else True)
            s = torch.where(live, s, float("-inf"))
            # fmaxf drops NaN: a NaN score does not move m
            mb = torch.where(torch.isnan(s), float("-inf"), s).amax(-1)
            m_new = torch.maximum(mt, mb)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            fin = torch.isfinite(mt)
            corr = torch.where(fin, torch.exp(torch.where(fin, mt - m_safe,
                                                          0.0)), 0.0)
            ok = torch.isfinite(s)
            p = torch.where(ok, torch.exp(torch.where(ok, s - m_safe[..., None],
                                                      0.0)), 0.0)
            lt = lt * corr + p.sum(-1)
            vc = torch.where((kp < Tk)[None, :, None], vf[:, kc], 0.0)
            at = at * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, vc)
            mt = m_new
        m[:, rows], l[:, rows], acc[:, rows] = mt, lt, at
    if partial:
        return (acc.reshape(B, H, Tq, Dh), m.reshape(B, H, Tq),
                l.reshape(B, H, Tq))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if causal:
        none = torch.arange(Tq) + shift < 0
        out[:, none] = float("nan")
    return out.reshape(B, H, Tq, Dh)
