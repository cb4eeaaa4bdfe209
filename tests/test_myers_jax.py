"""XLA Myers kernels (ops/myers_jax.py) vs the full-DP oracle: the
banded window kernel and the exact unbanded kernel that
``refine_mappings`` runs."""

import numpy as np
import pytest

from muchsalsa_tpu.ops.align import edit_distance_np, pack_problems
from muchsalsa_tpu.ops.myers_jax import W_BITS, myers_banded, myers_edit_distance
from muchsalsa_tpu.testing.simulate import random_genome
from tests.test_align import mutate


def banded(pairs, window_words=4):
    return np.asarray(myers_banded(*pack_problems(pairs),
                                   window_words=window_words))


def exact(pairs):
    return np.asarray(myers_edit_distance(*pack_problems(pairs)))


def banded_cases(seed, n_cases=24, max_len=400, rate=0.12):
    """Pairs whose edit path stays well inside a 4-word (128-diagonal)
    band."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_cases):
        m = int(rng.integers(40, max_len))
        q = random_genome(rng, m)
        t = mutate(rng, q, rate=float(rng.uniform(0, rate)))
        out.append((q, t if t else b"A"))
    return out


def _word_edge_pairs(seed, lengths, rate):
    rng = np.random.default_rng(seed)
    pairs = []
    for m in lengths:
        q = random_genome(rng, m)
        pairs.append((q, mutate(rng, q, rate)))
    return pairs


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_matches_oracle_in_band(seed):
    """One problem per call, so the shared band geometry is the
    problem's own: every refusal must be a length difference the band
    cannot hold."""
    for q, t in banded_cases(seed, n_cases=8):
        got = banded([(q, t)])[0]
        if got == -1:
            assert abs(len(t) - len(q)) > 4 * W_BITS - 2 * W_BITS
            continue
        assert got == edit_distance_np(q, t), (len(q), len(t))


@pytest.mark.parametrize("window_words", [2, 4, 8])
def test_banded_window_sizes_and_word_edges(window_words):
    pairs = _word_edge_pairs(5 + window_words,
                             (31, 32, 33, 64, 100, 257, 300), 0.08)
    got = banded(pairs, window_words=window_words)
    for i, (q, t) in enumerate(pairs):
        if got[i] != -1:
            assert got[i] == edit_distance_np(q, t), (window_words, len(q))


def test_banded_guard_refuses_large_diff():
    rng = np.random.default_rng(6)
    q = random_genome(rng, 100)
    t = random_genome(rng, 600)  # diff = 500 >> 2-word band
    assert banded([(q, t)], window_words=2)[0] == -1


def test_banded_mixed_batch():
    """Every problem the shared-geometry kernel accepts agrees with the
    oracle, and most of a mixed batch is accepted."""
    pairs = banded_cases(7, n_cases=40, max_len=600)
    got = banded(pairs, window_words=8)
    refused = 0
    for i, (q, t) in enumerate(pairs):
        if got[i] == -1:
            refused += 1
            continue
        assert got[i] == edit_distance_np(q, t), i
    assert refused < len(pairs) // 2


@pytest.mark.parametrize("kernel", [banded, exact])
def test_empty_and_degenerate(kernel):
    out = kernel([(b"A", b"A"), (b"ACGT" * 20, b"ACGT" * 20)])
    assert out[0] == 0
    assert out[1] == 0


def test_exact_matches_oracle():
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(20):
        m = int(rng.integers(1, 300))
        q = random_genome(rng, m)
        t = mutate(rng, q, rate=float(rng.uniform(0, 0.5)))
        pairs.append((q, t if t else b"A"))
    # wildly different lengths (no band to respect)
    pairs.append((random_genome(rng, 10), random_genome(rng, 500)))
    pairs.append((random_genome(rng, 500), random_genome(rng, 10)))
    got = exact(pairs)
    for i, (q, t) in enumerate(pairs):
        assert got[i] == edit_distance_np(q, t), (i, len(q), len(t))


def test_exact_word_edges():
    pairs = _word_edge_pairs(12, (31, 32, 33, 63, 64, 65, 96, 97), 0.2)
    got = exact(pairs)
    for i, (q, t) in enumerate(pairs):
        assert got[i] == edit_distance_np(q, t), (i, len(q))
