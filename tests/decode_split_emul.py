"""The decode kernel's order of work (``csrc/decode_attention.cu``) in
plain PyTorch, for the CPU tests (``tests/test_torch_decode_split.py``)
and the card tests (``tests/test_torch_cuda.py``). Torch only: the card
machine has no JAX.

For each (b, h) row and query tile (one row at S = 1, else tiles of 16),
the key range is cut by the wrapper's own ``_decode_splits`` into splits
of whole 32-key chunks; inside a split, warp w of the block's warps
(``DECODE_WARPS``: 2 at S = 1, 4 for a window tile) takes chunks w,
w + warps, ... in order and runs the
online softmax of the TPU kernel over each chunk (masked keys p = 0, a
NaN or +inf score p = NaN, ``m_safe`` / ``corr`` guards); the warps'
states are merged in warp order, then the splits' in split order, each
merge the same online rule; out = acc / max(l, 1e-30). Every value is
float32; a score or a chunk's P . V is a float32 dot product in torch's
order, not the kernel's FMA order, so the two agree within a float32
tolerance, not bit for bit. A chunk wholly past a row's keys is a no-op
of the online rule (m unchanged, corr exactly 1 or 0), so the emulation
walks every chunk and masks.

Above Dh 128 (the kernel's wide route) a chunk's scores are the sum of
their 128-column steps, in step order, and the split plan counts the
route's column groups as rows (B*H * ceil(Dh / 128) blocks a query tile).
"""
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck


def _p(s, m_safe):
    """The kernel's p: exp(s - m_safe), 0 for a masked (-inf) score, NaN
    for a NaN or +inf one."""
    live = torch.isfinite(s)
    bad = torch.isnan(s) | (s == float("inf"))
    return torch.where(live, torch.exp(torch.where(live, s - m_safe, 0.0)),
                       torch.where(bad, float("nan"), 0.0))


def _rescale(m, m_safe):
    fin = torch.isfinite(m)
    return torch.where(fin, torch.exp(torch.where(fin, m - m_safe, 0.0)),
                       0.0)


def merge(a, b):
    """Merge online-softmax state b = (m, l, acc) into a: the kernel's
    ``merge``."""
    m, l, acc = a
    mb, lb, accb = b
    mn = torch.maximum(m, mb)
    ms = torch.where(torch.isfinite(mn), mn, 0.0)
    c0, c1 = _rescale(m, ms), _rescale(mb, ms)
    return mn, l * c0 + lb * c1, acc * c0[..., None] + accb * c1[..., None]


def empty(bh, rows, dh):
    return (torch.full((bh, rows), float("-inf")), torch.zeros(bh, rows),
            torch.zeros(bh, rows, dh))


def decode_attention_split(q, k_cache, v_cache, pos, sms=132):
    """The kernel's output for q (B, H, S, Dh), caches (B, H, C, Dh) of any
    type the kernel takes and pos (B,) int32, as float32 (B, H, S, Dh),
    split as on a card of ``sms`` SMs. CPU tensors."""
    B, H, S, Dh = q.shape
    C = k_cache.shape[2]
    bh = B * H
    splits, keys = ck._decode_splits(bh * ck.head_groups(Dh), S, C, sms)
    step = ck.HEAD_TILES[-1]
    rows = 1 if S == 1 else ck.DECODE_WIN_ROWS
    warps, chunk = ck.DECODE_WARPS[rows], ck.DECODE_CHUNK
    qf = q.to(torch.float32).reshape(bh, S, Dh) * (float(Dh) ** -0.5)
    kf = k_cache.to(torch.float32).reshape(bh, C, Dh)
    vf = v_cache.to(torch.float32).reshape(bh, C, Dh)
    cursor = pos.to(torch.int64).repeat_interleave(H)          # b-major
    out = torch.empty(bh, S, Dh)
    for s0 in range(0, S, rows):
        nrows = min(rows, S - s0)
        qt = qf[:, s0:s0 + nrows]
        n_keys = torch.clamp(cursor + s0 + nrows, 0, C)
        q_pos = cursor[:, None] + s0 + torch.arange(nrows)    # (bh, rows)
        total = empty(bh, nrows, Dh)
        for split in range(splits):
            k_lo = split * keys
            k_hi = torch.clamp(n_keys, max=k_lo + keys)
            block = empty(bh, nrows, Dh)
            for w in range(warps):
                m, l, acc = empty(bh, nrows, Dh)
                for c in range(w, keys // chunk, warps):
                    ks = k_lo + c * chunk
                    idx = ks + torch.arange(chunk)
                    if ks >= C:
                        break
                    idx_c = torch.clamp(idx, max=C - 1)
                    kc, vc = kf[:, idx_c], vf[:, idx_c]
                    sc = sum(torch.einsum("brd,bkd->brk",
                                          qt[..., c0:c0 + step],
                                          kc[..., c0:c0 + step])
                             for c0 in range(0, Dh, step))
                    copied = idx[None, :] < k_hi[:, None]         # (bh, k)
                    valid = copied[:, None, :] & \
                        (idx[None, None, :] <= q_pos[:, :, None])
                    sc = torch.where(valid, sc, float("-inf"))
                    # fmaxf drops NaN: a NaN score does not move m
                    mx = torch.where(torch.isnan(sc), float("-inf"),
                                     sc).amax(-1)
                    m_new = torch.maximum(m, mx)
                    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                    p = _p(sc, m_safe[..., None])
                    corr = _rescale(m, m_safe)
                    l = l * corr + p.sum(-1)
                    # keys past k_hi are not copied: their V rows unread;
                    # a copied row masked for one query row still takes
                    # its p = 0 (0 * NaN is NaN, as in the plain version)
                    vc = torch.where(copied[..., None], vc, 0.0)
                    acc = acc * corr[..., None] + torch.einsum(
                        "brk,bkd->brd", p, vc)
                    m = m_new
                block = merge(block, (m, l, acc))
            total = merge(total, block)
        m, l, acc = total
        out[:, s0:s0 + nrows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, S, Dh)
