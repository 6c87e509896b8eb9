"""Samplers over the logits and log-probs (counterpart of
``xalm_tpu/sampler.py``: ``sample_argmax``, ``sample``, ``_nucleus_keep``,
the per-row serving samplers ``sample_rows`` and ``split_rows``, and
``token_logprobs``).

The draws take threefry keys (``prng.py``), the JAX keys bit for bit, so a
seed gives the JAX package's tokens. Nothing here reads a value back to the
host, so a CUDA graph captures each function (``runtime/graphs.py``):
``sample``'s parameters are Python numbers, fixed for a graph as they are
static arguments of the JAX function; ``sample_rows`` takes them as
tensors, one a row.
"""

from __future__ import annotations

import math

import torch

from xalm_tpu_torch import prng

__all__ = ["sample_argmax", "sample", "filtered_logits", "sample_rows", "split_rows",
           "token_logprobs"]

# candidate-set width of the sort-free nucleus filter (the JAX package's
# ``_NUCLEUS_K``): the top-p threshold is found among the top-K logits
# whenever they cover the requested mass
_NUCLEUS_K = 256


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token over the last axis (lowest index on ties). -> int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _nucleus_keep(ls: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep-mask of the top-p (nucleus) filter without a full-vocab sort, as
    the JAX ``_nucleus_keep``: the top-K candidates' exact probabilities
    under the full-vocab normaliser, and the value threshold of the
    positional cumulative sum among them (keep a token iff the mass of the
    strictly higher-ranked tokens is below top_p; ties at the threshold all
    kept). Where the top-K mass does not cover top_p (a nucleus wider than
    K), every token is kept. ls: (..., V) scaled logits."""
    k = min(_NUCLEUS_K, ls.shape[-1])
    tv = torch.topk(ls, k, dim=-1).values  # (..., K) descending
    z = torch.logsumexp(ls, dim=-1, keepdim=True)
    m = torch.exp(tv - z)
    cum = torch.cumsum(m, dim=-1)
    keep = (cum - m) < top_p
    thresh = torch.amin(torch.where(keep, tv, math.inf), dim=-1, keepdim=True)
    covered = (cum[..., -1:] >= top_p) & (top_p < 1.0)
    thresh = torch.where(covered, thresh, -math.inf)
    return ls >= thresh


def filtered_logits(logits: torch.Tensor, *, temperature: float, top_k: int = 0,
                    top_p: float = 1.0) -> torch.Tensor:
    """The f32 logits ``sample`` draws from, in the JAX order: divided by
    ``temperature`` (> 0), then top-k (below the k-th largest -> -inf), then
    top-p by the nucleus filter. ``top_k == 0`` and ``top_p >= 1`` turn
    their filters off."""
    ls = logits.to(torch.float32) / temperature
    if top_k and top_k > 0:
        kth = torch.topk(ls, top_k, dim=-1).values[..., -1:]
        ls = torch.where(ls < kth, -math.inf, ls)
    if top_p < 1.0:
        ls = torch.where(_nucleus_keep(ls, top_p), ls, -math.inf)
    return ls


def sample(logits: torch.Tensor, key: torch.Tensor, *, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Stochastic token over the last axis: temperature, top-k, top-p
    (``filtered_logits``), then ``jax.random.categorical(key, ...)``: the
    argmax of the filtered logits plus Gumbel draws of their whole shape
    under the one (2,) ``key`` (``prng.gumbel``). ``temperature <= 0`` is
    ``sample_argmax``. (..., vocab) -> (...,) int32."""
    if temperature <= 0.0:
        return sample_argmax(logits)
    ls = filtered_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    return torch.argmax(prng.gumbel(key, ls.shape) + ls, dim=-1).to(torch.int32)


def sample_rows(logits: torch.Tensor, keys: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, *, return_logprobs: bool = False):
    """Per-row sampling of a mixed serving batch (the JAX ``sample_rows``):
    logits (B, V), keys (B, 2) (``prng``), temperature (B,) (rows at 0 or
    below are greedy) and top_p (B,) (1 or more: no nucleus filter). One
    top-K extraction serves the nucleus threshold, the greedy token (the
    lowest index on ties) and the raw top-5; a sampled row draws
    ``argmax(filtered + gumbel(its key))``. -> (B,) int32; with
    ``return_logprobs`` also the chosen token's log-prob (B,), and the raw
    (pre-temperature) distribution's top-5 log-probs (B, 5) and ids (B, 5)
    int32."""
    f32 = torch.float32
    l = logits.to(f32)
    ls = l / torch.clamp(temperature.to(f32), min=1e-6)[:, None]
    k = min(_NUCLEUS_K, l.shape[-1])
    tv, ti = torch.topk(ls, k, dim=-1)
    z = torch.logsumexp(ls, dim=-1, keepdim=True)
    m = torch.exp(tv - z)
    cum = torch.cumsum(m, dim=-1)
    tp = top_p.to(f32)[:, None]
    keep = (cum - m) < tp
    thresh = torch.amin(torch.where(keep, tv, math.inf), dim=-1, keepdim=True)
    covered = (cum[:, -1:] >= tp) & (tp < 1.0)
    thresh = torch.where(covered, thresh, -math.inf)
    lf = torch.where(ls < thresh, -math.inf, ls)
    draw = torch.argmax(prng.gumbel(keys, (l.shape[-1],)) + lf, dim=-1)
    # the greedy token: the first maximum (torch.topk orders ties freely)
    nxt = torch.where(temperature > 0.0, draw, torch.argmax(ls, dim=-1)).to(torch.int32)
    if not return_logprobs:
        return nxt
    z_raw = torch.logsumexp(l, dim=-1, keepdim=True)
    lp = torch.gather(l, -1, nxt.long()[:, None])[:, 0] - z_raw[:, 0]
    top5_ids = ti[:, :5]
    top5 = torch.gather(l, -1, top5_ids) - z_raw
    return nxt, lp, top5, top5_ids.to(torch.int32)


def split_rows(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2) keys -> (subkeys, carry), each (B, 2): ``jax.random.split``
    of each row's key, the first half drawn from, the second carried."""
    both = prng.split(keys, 2)
    return both[:, 0], both[:, 1]


def token_logprobs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[target], in f32. logits (..., vocab); targets (...)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, targets.to(torch.int64)[..., None])[..., 0]
