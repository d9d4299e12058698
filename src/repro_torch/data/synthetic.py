"""Synthetic datasets: the paper-repro image task and token corpora.

The port's copy of the reference's ``data/synthetic.py``.  Pure numpy, so
equal specs give equal arrays in both packages.

* ``synthetic_classification`` stands in for CIFAR (nothing is
  downloaded): each class has a random prototype on the unit sphere in
  pixel space, plus class-conditional low-rank structure and additive
  noise, reshaped to [H, W, C] images (NHWC) so the paper's CNNs run on it.
* ``synthetic_tokens`` synthesizes token streams from per-topic
  generators; the topic of a sequence plays the role of its label, so the
  non-IID machinery (Formulas 2-3) applies with topics as labels.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_classes: int = 10
    image_shape: tuple = (16, 16, 3)
    train_size: int = 50000
    test_size: int = 10000
    noise_scale: float = 0.9
    feature_rank: int = 12
    seed: int = 0


def synthetic_classification(spec: SyntheticSpec):
    """Returns (train_x, train_y, test_x, test_y): float32 NHWC images and
    int32 labels."""
    rng = np.random.default_rng(spec.seed)
    dim = int(np.prod(spec.image_shape))
    protos = rng.standard_normal((spec.num_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    basis = rng.standard_normal((spec.feature_rank, dim)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    coeff = rng.standard_normal(
        (spec.num_classes, spec.feature_rank)).astype(np.float32)

    def make(n, seed):
        r = np.random.default_rng(seed)
        y = r.integers(0, spec.num_classes, n).astype(np.int32)
        z = r.standard_normal((n, spec.feature_rank)).astype(np.float32) * 0.3
        x = (protos[y]
             + (coeff[y] + z) @ basis * 0.5
             + r.standard_normal((n, dim)).astype(np.float32)
             * spec.noise_scale)
        return x.reshape(n, *spec.image_shape), y

    train_x, train_y = make(spec.train_size, spec.seed + 1)
    test_x, test_y = make(spec.test_size, spec.seed + 2)
    return train_x, train_y, test_x, test_y


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
