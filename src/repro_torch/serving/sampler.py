"""Token sampling: greedy, temperature and top-k, per slot, batched, and
the fused step's sample-and-accept.

Counterpart of the JAX package's ``serving/sampler.py`` (``sample_token``,
``sample_tokens``, ``spec_accept``, ``fused_sample_accept``).  Greedy takes the argmax
(first index on ties, as ``jnp.argmax``); sampled rows draw from an
explicit ``torch.Generator``, so their bits differ from ``jax.random``.

The batched functions do no host work, so a CUDA graph can capture them:
a draw is ``torch.multinomial``'s own one-sample method (the argmax of
``probs / Exp(1)`` noise, the same bits from the same generator state)
without its checks, which read the probabilities back to the host.
"""

from __future__ import annotations

import torch


def _draw(probs: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One index per row of (..., V) ``probs``, drawn in proportion to them."""
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


def _scaled(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """(B, ..., V) logits tempered per row and cut to the row's top k (ties
    at the k-th largest survive; ``top_k <= 0`` keeps all).  Greedy rows are
    scaled by a benign 1.0 rather than a 1e-6 clamp, which would overflow
    large logits to inf in the lanes that ``where`` discards."""
    V = logits.shape[-1]
    lead = (-1,) + (1,) * (logits.dim() - 1)
    greedy = temperature <= 0.0
    safe_t = torch.where(greedy, torch.ones_like(temperature), torch.clamp(temperature, min=1e-6))
    scaled = logits / safe_t.view(lead)
    kth = (torch.clamp(top_k.long(), 1, V) - 1).view(lead).expand(*logits.shape[:-1], 1)
    thresh = torch.sort(scaled, dim=-1, descending=True).values.gather(-1, kth)
    cut = (top_k > 0).view(lead) & (scaled < thresh)
    return torch.where(cut, torch.full_like(scaled, float("-inf")), scaled)


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    temperature: torch.Tensor,  # (B,) fp32; <= 0 means greedy
    top_k: torch.Tensor,  # (B,) int; <= 0 means full softmax
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Whole-batch sampler, per-slot temperature / top-k carried as data.
    The top-k threshold is the k-th largest scaled logit (ties at the
    threshold survive).  Returns (B,) int64."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    sampled = _draw(torch.softmax(_scaled(logits, temperature, top_k), dim=-1), generator)
    return torch.where(temperature <= 0.0, greedy, sampled)


def sample_token(logits: torch.Tensor, temperature: float, generator: torch.Generator | None = None, *, top_k: int = 0) -> int:
    """logits: (V,) -> one token."""
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    t = torch.tensor([temperature], dtype=torch.float32, device=logits.device)
    k = torch.tensor([top_k], dtype=torch.int64, device=logits.device)
    return int(sample_tokens(logits[None], t, k, generator)[0])


def _target_probs(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """(R, W, V) logits -> per-row tempered, top-k'd probabilities; greedy
    rows one-hot at the argmax, so the accept rule below compares exactly."""
    probs = torch.softmax(_scaled(logits, temperature, top_k), dim=-1)
    onehot = torch.zeros_like(probs).scatter_(-1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.where((temperature <= 0.0)[:, None, None], onehot, probs)


def spec_accept(
    logits: torch.Tensor,  # (B, K+1, V) target logits at the verified positions
    drafts: torch.Tensor,  # (B, K) int drafted tokens
    draft_probs: torch.Tensor | None,  # (B, K, V) draft distributions, or None: one-hot(drafts)
    valid: torch.Tensor,  # (B, K) bool; False positions force-reject (no draft)
    temperature: torch.Tensor,  # (B,) fp32; <= 0 means greedy
    top_k: torch.Tensor,  # (B,) int; <= 0 means full softmax
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative accept / reject over a whole decode batch in one call.

    ``logits[:, i]`` is the target distribution after the i-th fed token
    (``[last_committed, d_1, ..., d_K]``), the one draft ``d_{i+1}`` is
    judged against.  Draft ``d_i`` is accepted with probability
    ``min(1, p_i(d_i) / q_i(d_i))`` (greedy rows: iff it is the argmax);
    the first rejection at j emits one token from ``norm(max(p_j - q_j,
    0))`` (an invalid position counts q as zero: a plain sample from p);
    with every draft accepted, a bonus token comes from lane K.  The
    emitted ``drafts[:n_acc] + [final]`` is distributed as n_acc + 1
    sequential samples of the target, and equal to them under greedy.

    It is ``fused_sample_accept`` with every row sampling from lane
    ``n_acc`` (``sample_lane`` 0).  Returns ``(n_acc (B,), final (B,))``,
    int32."""
    sample_lane = torch.zeros(logits.shape[0], dtype=torch.int32, device=logits.device)
    return fused_sample_accept(logits, drafts, draft_probs, valid, temperature, top_k, sample_lane, generator)


def fused_sample_accept(
    logits: torch.Tensor,  # (R, W, V) all-lane logits from models.unified_step
    drafts: torch.Tensor,  # (R, W-1) int drafted tokens (zeros on non-spec rows)
    draft_probs: torch.Tensor | None,  # (R, W-1, V) draft distributions, or None: one-hot(drafts)
    valid: torch.Tensor,  # (R, W-1) bool; all-False rows have no speculative window
    temperature: torch.Tensor,  # (R,) fp32; <= 0 means greedy
    top_k: torch.Tensor,  # (R,) int; <= 0 means full softmax
    sample_lane: torch.Tensor,  # (R,) int lane whose logits the row samples from
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative accept generalised to the fused mixed row batch, so the
    engine samples inside the one-dispatch step.

    Row types share one recurrence.  A spec-verify row passes
    ``sample_lane=0`` and its drafts / valid window: draft ``d_i`` is
    accepted with probability ``min(1, p_i(d_i) / q_i(d_i))`` (greedy rows:
    iff it is the argmax), ``n_acc`` counts the accepted prefix, and the
    correction or bonus token comes from lane ``n_acc``'s residual
    ``max(p - q, 0)``.  A decode row passes ``sample_lane=0`` with an
    all-invalid window (``n_acc`` is 0: it samples lane 0); a prefill-chunk
    row passes ``sample_lane = width - 1``.  The sampled lane is
    ``n_acc + sample_lane``, clamped for width-0 pad rows; an invalid lane's
    ``q`` is zero, so non-spec rows take a plain tempered / top-k sample,
    greedy rows the exact argmax.

    ``draft_probs=None`` is the one-hot proposal of ``drafts`` (the n-gram
    drafter and non-spec ticks), used without building the (R, W-1, V)
    tensor.  Returns ``(n_acc (R,), final (R,))``, int32.
    """
    R, W, V = logits.shape
    K = W - 1
    drafts = drafts.long()
    greedy = temperature <= 0.0
    p = _target_probs(logits, temperature, top_k)  # (R, W, V)
    argmax = torch.argmax(logits, dim=-1)  # (R, W)

    u = torch.rand((R, K), generator=generator, device=logits.device)
    p_draft = p[:, :K].gather(-1, drafts[..., None])[..., 0]
    if draft_probs is None:
        q_draft = torch.ones_like(p_draft)
    else:
        q_draft = draft_probs.gather(-1, drafts[..., None])[..., 0]
    accept_sampled = u < torch.clamp(p_draft / torch.clamp(q_draft, min=1e-20), max=1.0)
    accept_greedy = drafts == argmax[:, :K]
    accept = valid & torch.where(greedy[:, None], accept_greedy, accept_sampled)
    n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1)  # first rejection stops the window

    lane = torch.clamp(n_acc + sample_lane.long(), max=W - 1)  # (R,)
    p_fin = p.gather(1, lane[:, None, None].expand(R, 1, V))[:, 0]  # (R, V)
    if K:
        # q at lane n_acc; lane K (the bonus) and invalid lanes count as q = 0
        at = torch.clamp(lane, max=K - 1)[:, None]
        valid_j = valid.gather(1, at)[:, 0] & (lane < K)
        if draft_probs is None:
            q_fin = torch.zeros_like(p_fin).scatter_(-1, drafts.gather(1, at), 1.0)
        else:
            q_fin = draft_probs.gather(1, at[:, :, None].expand(R, 1, V))[:, 0].float()
        q_fin = torch.where(valid_j[:, None], q_fin, torch.zeros_like(q_fin))
    else:
        q_fin = torch.zeros_like(p_fin)
    resid = torch.clamp(p_fin - q_fin, min=0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(norm > 0, resid / torch.clamp(norm, min=1e-20), p_fin)
    fin_sampled = _draw(resid, generator)
    fin_greedy = argmax.gather(1, lane[:, None])[:, 0]
    final = torch.where(greedy, fin_greedy, fin_sampled)
    return n_acc.int(), final.int()
