"""Sequence packing: concatenate documents into fixed-length rows.

Packing removes pad waste (the difference between 40% and 95%+ token
efficiency on real corpora).  Cross-document attention is prevented by the
``positions`` array resetting at each document boundary — the model's RoPE
and causal mask consume positions directly, so a packed row behaves like
independent documents (segment-mask variant of T5/LLaMA packing).

A copy of the JAX package's ``data/packing.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def pack_sequences(docs: list[np.ndarray], seq_len: int, *, pad_id: int = 0):
    """Greedy first-fit packing.

    Returns (tokens (N, seq_len) int32, positions (N, seq_len) int32,
    segment_ids (N, seq_len) int32 — 0 = padding).
    """
    rows: list[list[np.ndarray]] = []
    space: list[int] = []
    for d in docs:
        d = np.asarray(d, np.int32)[:seq_len]
        placed = False
        for i, s in enumerate(space):
            if len(d) <= s:
                rows[i].append(d)
                space[i] -= len(d)
                placed = True
                break
        if not placed:
            rows.append([d])
            space.append(seq_len - len(d))

    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    segments = np.zeros((n, seq_len), np.int32)
    for i, row in enumerate(rows):
        off = 0
        for j, d in enumerate(row, start=1):
            tokens[i, off : off + len(d)] = d
            positions[i, off : off + len(d)] = np.arange(len(d))
            segments[i, off : off + len(d)] = j
            off += len(d)
    return tokens, positions, segments


def packing_efficiency(segments: np.ndarray) -> float:
    return float((segments > 0).mean())
