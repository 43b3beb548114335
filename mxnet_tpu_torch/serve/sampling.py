"""Token sampling for the decode plane: greedy argmax, or temperature /
top-k / top-p on a recorded per-request rng chain, and the exact
speculative rejection rule (``speculative_verify``).

Sampling runs on the host on the logits row the step returned.
Determinism contract (the JAX package's, unchanged): every request owns
one numpy PCG64 chain seeded by ``SamplingParams.seed``; greedy decisions
consume no draws; the math is float64 end to end, so replaying the same
logits through the same chain gives the same tokens on any host.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["SamplingParams", "token_probs", "sample_from", "sample_token",
           "speculative_verify"]


class SamplingParams:
    """Per-request sampling policy. ``temperature=0`` is greedy-argmax
    (the default); ``top_k``/``top_p`` filter the distribution before the
    draw; ``seed`` seeds the request's rng chain."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=0):
        temperature = float(temperature)
        top_k = int(top_k)
        top_p = float(top_p)
        if temperature < 0.0:
            raise MXNetError(f"temperature {temperature} must be >= 0")
        if top_k < 0:
            raise MXNetError(f"top_k {top_k} must be >= 0 (0 = off)")
        if not 0.0 < top_p <= 1.0:
            raise MXNetError(f"top_p {top_p} must be in (0, 1]")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)

    @property
    def greedy(self):
        return self.temperature == 0.0

    def make_rng(self):
        """The request's recorded rng chain."""
        return np.random.Generator(np.random.PCG64(self.seed))

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


def token_probs(logits, params):
    """One logits row -> the float64 distribution ``params`` samples from
    (greedy: one-hot at the argmax; else tempered softmax, top-k then
    top-p filtered, renormalized)."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if params.greedy:
        probs = np.zeros(logits.shape[0], np.float64)
        probs[int(np.argmax(logits))] = 1.0
        return probs
    z = logits / params.temperature
    z -= z.max()
    probs = np.exp(z)
    probs /= probs.sum()
    if params.top_k and params.top_k < probs.shape[0]:
        keep = np.argsort(-probs, kind="stable")[:params.top_k]
        mask = np.zeros(probs.shape[0], bool)
        mask[keep] = True
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    if params.top_p < 1.0:
        order = np.argsort(-probs, kind="stable")
        csum = np.cumsum(probs[order])
        cut = int(np.searchsorted(csum, params.top_p, side="left")) + 1
        mask = np.zeros(probs.shape[0], bool)
        mask[order[:cut]] = True
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    return probs


def sample_from(probs, u):
    """Inverse-CDF draw of one uniform ``u`` in [0, 1) against a float64
    weight vector."""
    cdf = np.cumsum(np.asarray(probs, np.float64))
    total = cdf[-1]
    if total <= 0.0:
        raise MXNetError("sample_from: all-zero weight vector")
    return int(min(np.searchsorted(cdf, u * total, side="right"),
                   cdf.shape[0] - 1))


def sample_token(logits, params, rng):
    """Sample one token from a logits row. Greedy consumes no rng draw;
    everything else consumes exactly one uniform."""
    if params.greedy:
        return int(np.argmax(np.asarray(logits)))
    return sample_from(token_probs(logits, params), rng.random())


def speculative_verify(target_rows, draft_rows, proposals, params, rng):
    """Exact rejection sampling over one slot's K draft proposals.

    ``target_rows`` / ``draft_rows`` are (K, V) logits: row ``j`` is the
    distribution for the stream position proposal ``j`` fills (the
    target's from the S=K verify window, the draft's from proposal
    dispatch ``j``). Returns ``(accepted, tokens)``: the proposals kept,
    and what the slot commits — the accepted prefix plus, after a
    rejection, one token drawn from the residual ``max(p - q, 0)`` (so
    1 <= len(tokens) <= K). Under greedy this accepts while the draft's
    and the target's argmax agree and then emits the target's argmax:
    target-only greedy decode, token for token."""
    proposals = [int(d) for d in proposals]
    emitted = []
    for j, d in enumerate(proposals):
        p = token_probs(target_rows[j], params)
        q = token_probs(draft_rows[j], params)
        pd, qd = float(p[d]), float(q[d])
        if params.greedy:
            accept = pd > 0.0               # one-hot match, no draw
        elif qd <= 0.0:
            # the draft proposed d at q(d)=0 only if the filters diverged:
            # accept it only where the target admits it
            accept = pd > 0.0
        else:
            accept = rng.random() < min(1.0, pd / qd)
        if accept:
            emitted.append(d)
            continue
        resid = np.maximum(p - q, 0.0)
        if resid.sum() <= 0.0:
            resid = p                        # degenerate: q covers p
        if params.greedy:
            emitted.append(int(np.argmax(resid)))
        else:
            emitted.append(sample_from(resid, rng.random()))
        return j, emitted
    return len(proposals), emitted
