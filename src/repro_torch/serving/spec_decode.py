"""Speculative decoding: the drafters of the paged serving engine.

Counterpart of the JAX package's ``serving/spec_decode.py``.  A cheap
drafter proposes ``k`` candidate tokens per slot, the target scores all of
them in ONE verify pass through the chunked-prefill machinery
(``models.verify_step``, K2), and ``sampler.spec_accept`` keeps the
longest prefix the target agrees with plus one correction or bonus token,
so a slot advances by 1 to ``k + 1`` tokens a step; under greedy the
emitted tokens equal one-at-a-time decoding's.

* ``ngram_draft``: prompt lookup, pure Python over the token list (a copy
  of the JAX package's).  It proposes nothing when the context never
  repeats, which degrades to a plain step.  Its proposal law is the
  one-hot of its tokens.
* ``DraftModel``: a smaller model of the same family
  (``make_draft_config``: the target at reduced depth, same vocabulary)
  decoded ``k`` times per step, one batch=1 dense ring cache per slot
  (``models.init_cache``, fp32).  After accept/reject, ``rollback``
  truncates its committed length and the next ``draft`` re-feeds the
  divergent tokens: stale ring entries hold future positions, so the
  causal mask hides them until they are overwritten.

Each draft feed is one eager ``decode_step`` and each drafted token one
host read of its distribution, as the reference's jitted ``_decode`` is one
dispatch per token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache
from repro_torch.serving.sampler import _draw, _target_probs


def make_draft_config(cfg, *, num_layers: Optional[int] = None):
    """A draft config from the same family: the target config at reduced
    depth (default: half, floor 1).  Width, heads and the vocabulary are
    inherited, so drafted token ids are target token ids."""
    if num_layers is None:
        num_layers = max(cfg.num_layers // 2, 1)
    return cfg.replace(name=f"{cfg.name}-draft{num_layers}l", num_layers=num_layers)


def ngram_draft(
    context: list[int],
    k: int,
    *,
    max_ngram: int = 3,
    min_ngram: int = 1,
) -> list[int]:
    """Prompt-lookup drafting: propose the tokens that followed the most
    recent earlier occurrence of the longest matching suffix n-gram.

    Tries suffix lengths ``max_ngram`` down to ``min_ngram``; the most
    recent earlier occurrence of the suffix wins.  A match at position ``s``
    witnesses period ``p = L - n - s``, and the proposal extrapolates that
    period forward: token ``L + j`` is predicted as token ``L + j - p``, so
    a run or cycle near the end proposes the whole window.  Returns ``[]``
    when the context never repeats.
    """
    L = len(context)
    if k <= 0 or L < min_ngram + 1:
        return []
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pat = context[L - n :]
        for s in range(L - n - 1, -1, -1):
            if context[s : s + n] == pat:
                p = L - n - s
                pred = list(context)
                for _ in range(k):
                    pred.append(pred[-p])
                return pred[L:]
    return []


class DraftModel:
    """Per-slot autoregressive drafter over private dense ring caches.

    ``draft`` first catches up on committed context tokens the slot's cache
    has not absorbed (the prompt on a fresh slot, at most two tokens a step
    after that: the correction and possibly the never-fed last draft), then
    rolls ``k`` tokens forward, recording the distribution each was drawn
    from: ``sampler.spec_accept`` needs the proposal law ``q`` for exact
    rejection sampling.  Sampled drafts draw from a ``torch.Generator``
    seeded ``seed ^ 0x5BEC`` (the JAX package draws from a key of that
    seed: the bits differ, the law does not)."""

    def __init__(self, cfg, params, *, max_batch: int, max_seq: int, seed: int = 0, metrics=None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.caches = [init_cache(cfg, 1, max_seq, torch.float32, device=self.device) for _ in range(max_batch)]
        self.lens = np.zeros((max_batch,), np.int32)  # committed tokens absorbed
        self._gen = torch.Generator(device=self.device).manual_seed(seed ^ 0x5BEC)
        self._m_calls = self._m_feeds = None
        if metrics is not None:
            self._m_calls = metrics.counter("spec_draft_calls_total", "draft() invocations")
            self._m_feeds = metrics.counter(
                "spec_draft_feeds_total", "draft-model decode calls (catch-up + window)"
            )

    def reset(self, slot: int) -> None:
        """New request in ``slot``: restart from position 0.  Stale entries
        hold positions at or past every future query until overwritten in
        feed order, so the causal mask hides them."""
        self.lens[slot] = 0

    def rollback(self, slot: int, committed: int) -> None:
        """Truncate the drafter's view to ``committed`` context tokens after
        the target's accept/reject; rejected feeds are re-fed (overwritten)
        by the next ``draft`` call's catch-up."""
        self.lens[slot] = min(int(self.lens[slot]), committed)

    def _feed(self, slot: int, token: int, pos: int) -> torch.Tensor:
        if self._m_feeds is not None:
            self._m_feeds.inc()
        tok = torch.tensor([[token]], dtype=torch.int32, device=self.device)
        p = torch.tensor([pos], dtype=torch.int32, device=self.device)
        logits, _ = decode_step(self.cfg, self.params, self.caches[slot], tok, p)
        return logits[0]

    def draft(
        self,
        slot: int,
        context: list[int],
        k: int,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
    ) -> tuple[list[int], np.ndarray]:
        """Propose up to ``k`` tokens for ``slot`` given the committed
        ``context``.  Returns ``(tokens, probs)`` with ``probs[i]`` the (V,)
        distribution token ``i`` was drawn from (one-hot under greedy), on
        the host."""
        if k <= 0:
            return [], np.zeros((0, 1), np.float32)
        if self._m_calls is not None:
            self._m_calls.inc()
        start = int(self.lens[slot])
        logits = None
        for i, t in enumerate(context[start:]):  # catch-up on committed tokens
            logits = self._feed(slot, int(t), start + i)
        pos = len(context)
        self.lens[slot] = pos
        drafts: list[int] = []
        probs: list[np.ndarray] = []
        temp = torch.tensor([temperature], dtype=torch.float32, device=self.device)
        tk = torch.tensor([top_k], dtype=torch.int32, device=self.device)
        for i in range(k):
            if pos + i >= self.max_seq:  # the draft cache is full
                break
            # q and the target's p share the sampler's tempered / top-k rule,
            # as exact rejection sampling needs
            q = _target_probs(logits[None, None], temp, tk)[0, 0]
            d = None if temperature <= 0.0 else int(_draw(q, self._gen))
            q_host = q.cpu().numpy()  # the host read of this drafted token
            drafts.append(int(np.argmax(q_host)) if d is None else d)  # greedy: the one-hot's index
            probs.append(q_host)
            if i < k - 1:
                logits = self._feed(slot, drafts[-1], pos + i)
        if len(drafts) > 1:
            # the provisional feeds past the context are rolled back by the
            # engine after accept/reject; record only what was fed
            self.lens[slot] = pos + len(drafts) - 1
        return drafts, np.stack(probs) if probs else np.zeros((0, 1), np.float32)
