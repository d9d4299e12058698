"""Synthetic token corpora for federated LM training.

The port's copy of the token half of the reference's ``data/synthetic.py``
(the image-classification half comes with the CNN slice).  Token streams
are synthesized from per-topic generators; the topic of a sequence plays
the role of its label, so the non-IID machinery (Formulas 2-3) applies
with topics as labels.  Pure numpy, so equal seeds give equal arrays in
both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenSpec:
    vocab_size: int = 50304
    num_topics: int = 10       # topics double as "labels" for non-IID degrees
    seq_len: int = 512
    num_sequences: int = 2048
    ngram: int = 2
    seed: int = 0


def synthetic_tokens(spec: TokenSpec):
    """Topic-conditioned Markov token streams.

    Returns (tokens [N, S] int32, topics [N] int32).  Each topic owns a
    sparse bigram transition over a topic-specific vocabulary slice, so a
    model can reduce its loss by learning the transitions.
    """
    rng = np.random.default_rng(spec.seed)
    V, T = spec.vocab_size, spec.num_topics
    slice_size = max(64, V // (2 * T))
    starts = rng.integers(0, max(1, V - slice_size), T)
    # per-topic transition: next = (a * cur + b) % slice + start, with noise
    a = rng.integers(3, 97, T)
    b = rng.integers(1, slice_size, T)

    topics = rng.integers(0, T, spec.num_sequences).astype(np.int32)
    toks = np.empty((spec.num_sequences, spec.seq_len), np.int32)
    cur = rng.integers(0, slice_size, spec.num_sequences)
    noise = rng.random((spec.num_sequences, spec.seq_len)) < 0.1
    jumps = rng.integers(0, slice_size, (spec.num_sequences, spec.seq_len))
    for s in range(spec.seq_len):
        cur = np.where(noise[:, s], jumps[:, s],
                       (a[topics] * cur + b[topics]) % slice_size)
        toks[:, s] = starts[topics] + cur
    return toks, topics
