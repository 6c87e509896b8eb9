"""Samplers over the logits and log-probs (counterpart of
``xalm_tpu/sampler.py``'s ``sample_argmax``, ``sample``, ``_nucleus_keep``
and ``token_logprobs``; the per-row serving samplers ``sample_rows`` and
``split_rows`` belong to the serving slice).

Nothing here reads a value back to the host, so a CUDA graph captures each
function (``runtime/graphs.py``): the sampling parameters are Python numbers,
fixed for a graph as they are static arguments of the JAX functions.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sample_argmax", "sample", "filtered_logits", "token_logprobs"]

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


def sample(logits: torch.Tensor, generator: torch.Generator, *, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Stochastic token over the last axis: temperature, top-k, top-p
    (``filtered_logits``), then a Gumbel-max draw from ``generator`` (on
    the logits' device), which has the distribution of the JAX
    ``jax.random.categorical``. ``temperature <= 0`` is ``sample_argmax``.
    (..., vocab) -> (...,) int32."""
    if temperature <= 0.0:
        return sample_argmax(logits)
    ls = filtered_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    u = torch.rand(ls.shape, generator=generator, device=ls.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(ls + gumbel, dim=-1).to(torch.int32)


def token_logprobs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[target], in f32. logits (..., vocab); targets (...)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, targets.to(torch.int64)[..., None])[..., 0]
