"""Token sampling: greedy, temperature, top-k, top-p — all per slot.

Counterpart of `paddle_tpu.generation.sampling`.  The knobs are [N]
tensors, so one call serves a batch that mixes greedy and sampled
requests.  The random stream of a request is a `torch.Generator`
seeded from ``(seed, step)`` alone: the token drawn depends only on the
request and its step, never on its slot, its batch or the device —
the property the engine-vs-`sequential_oracle` exactness rests on.

A sampled row draws ``argmax(scaled + Gumbel noise)`` (exactly a draw
from ``softmax(scaled)``), with the noise made on the host by the
row's generator and moved to the logits' device.  JAX's
``jax.random.categorical`` draws other numbers from the same seed, so
sampled streams are the port's own; greedy streams match the JAX
engine's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SamplingParams", "sample_tokens", "token_logprobs",
           "stream_generator"]

NEG_INF = -1e30


class SamplingParams:
    """Per-request sampling policy.

    * ``temperature <= 0`` — greedy (argmax; top_k/top_p ignored).
    * ``top_k > 0``  — keep only the k highest-logit tokens.
    * ``top_p < 1``  — nucleus: keep the smallest prefix of the sorted
      distribution whose mass reaches ``top_p`` (the argmax token is
      always kept, so ``top_p=0`` degrades to greedy-with-noise, never
      to an empty support).
    * ``seed`` — the request's random stream identity.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=1.0, top_k=0, top_p=1.0, seed=0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)

    @staticmethod
    def greedy():
        return SamplingParams(temperature=0.0)

    def to_dict(self):
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}


def stream_generator(seed, step):
    """The CPU generator of request ``seed`` at generated-token index
    ``step``: one distinct 64-bit seed per (seed, step) pair."""
    g = torch.Generator()
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def _gumbel(seed, step, vocab):
    u = torch.rand(vocab, generator=stream_generator(seed, step),
                   dtype=torch.float64)
    u = u.clamp(min=1e-300)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def sample_tokens(logits, seeds, steps, temperature, top_k, top_p):
    """Sample one token per row.

    logits [N, V] (any float dtype, any device); seeds / steps: [N]
    host ints (numpy or lists) — the request seed and its generated-
    token index; temperature / top_p [N] float and top_k [N] int, host
    arrays.  Returns an [N] int64 tensor on the logits' device."""
    device = logits.device
    logits = logits.float()
    n, v = logits.shape
    temperature = np.asarray(temperature, np.float32)
    top_k = np.asarray(top_k, np.int64)
    top_p = np.asarray(top_p, np.float32)
    greedy = temperature <= 0.0
    out = logits.argmax(dim=-1)
    if greedy.all():
        return out
    safe_t = torch.from_numpy(np.where(greedy, 1.0, temperature)).to(device)
    tk = torch.from_numpy(top_k).to(device)
    tp = torch.from_numpy(top_p).to(device)
    scaled = logits / safe_t[:, None]

    # top-k: mask strictly below the kth-largest logit (k <= 0: off)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (tk - 1).clamp(0, v - 1)
    kth = sorted_desc.gather(1, k_idx[:, None])
    scaled = torch.where((tk > 0)[:, None] & (scaled < kth), NEG_INF, scaled)

    # top-p over the (top-k-filtered) distribution
    sorted2 = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < tp[:, None]          # mass BEFORE the token
    keep[:, 0] = True                           # argmax always survives
    thresh = torch.where(keep, sorted2, torch.inf).amin(dim=-1)
    scaled = torch.where((tp < 1.0)[:, None] & (scaled < thresh[:, None]),
                         NEG_INF, scaled)

    rows = np.nonzero(~greedy)[0]
    noise = torch.stack([_gumbel(seeds[i], steps[i], v) for i in rows])
    idx = torch.from_numpy(rows).to(device)
    out[idx] = (scaled[idx] + noise.to(device)).argmax(dim=-1)
    return out


def token_logprobs(logits, tokens):
    """Per-row log-probability of ``tokens`` under the raw softmax
    (temperature 1, unfiltered): logits [N, V]; tokens [N] int."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(1, tokens.long()[:, None])[:, 0]
