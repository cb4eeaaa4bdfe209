"""Banded edit-distance vs full-DP oracle."""

import numpy as np
import pytest

from muchsalsa_tpu.ops.align import banded_edit_distance, edit_distance_np, pack_problems
from muchsalsa_tpu.testing.simulate import random_genome
from muchsalsa_tpu.utils.seq import reverse_complement


def mutate(rng, seq: bytes, rate: float) -> bytes:
    out = bytearray()
    bases = b"ACGT"
    for b in seq:
        r = rng.random()
        if r < rate / 3:
            continue  # deletion
        if r < 2 * rate / 3:
            out.append(bases[rng.integers(0, 4)])  # substitution
            out.append(b) if rng.random() < 0.0 else None
        elif r < rate:
            out.append(b)
            out.append(bases[rng.integers(0, 4)])  # insertion
        else:
            out.append(b)
    return bytes(out)


def test_oracle_basics():
    assert edit_distance_np(b"", b"") == 0
    assert edit_distance_np(b"ACGT", b"ACGT") == 0
    assert edit_distance_np(b"ACGT", b"AGGT") == 1
    assert edit_distance_np(b"ACGT", b"ACG") == 1
    assert edit_distance_np(b"AAAA", b"TTTT") == 4


def test_banded_exact_match():
    rng = np.random.default_rng(1)
    s = random_genome(rng, 300)
    args = pack_problems([(s, s)])
    out = banded_edit_distance(*args, band=128)
    assert int(out[0]) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_matches_oracle_random(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    expected = []
    for _ in range(12):
        n = int(rng.integers(50, 400))
        q = random_genome(rng, n)
        t = mutate(rng, q, rate=0.1)
        pairs.append((q, t))
        expected.append(edit_distance_np(q, t))
    out = banded_edit_distance(*pack_problems(pairs), band=128)
    np.testing.assert_array_equal(np.asarray(out), np.array(expected))


def test_banded_unrelated_sequences():
    rng = np.random.default_rng(5)
    q = random_genome(rng, 200)
    t = random_genome(np.random.default_rng(99), 200)
    out = banded_edit_distance(*pack_problems([(q, t)]), band=256)
    # banded distance upper-bounds within the band; must equal oracle
    # when the band covers everything relevant... with band 256 > 2*200
    # the DP is exact
    assert int(out[0]) == edit_distance_np(q, t)


def test_banded_length_diff_exceeds_band():
    q = b"A" * 300
    t = b"A" * 10
    out = banded_edit_distance(*pack_problems([(q, t)]), band=128)
    assert int(out[0]) == -1


def test_banded_batch_mixed_sizes():
    rng = np.random.default_rng(8)
    pairs = [
        (random_genome(rng, 60), random_genome(rng, 70)),
        (b"ACGTACGT", b"ACGTACGT"),
        (random_genome(rng, 350), random_genome(rng, 340)),
    ]
    expected = [edit_distance_np(q, t) for q, t in pairs]
    out = banded_edit_distance(*pack_problems(pairs), band=1024)
    np.testing.assert_array_equal(np.asarray(out), np.array(expected))


def test_banded_revcomp_differs():
    rng = np.random.default_rng(9)
    s = random_genome(rng, 250)
    rc = reverse_complement(s)
    d_fwd = int(banded_edit_distance(*pack_problems([(s, s)]), band=128)[0])
    d_rc = int(banded_edit_distance(*pack_problems([(s, rc)]), band=640)[0])
    assert d_fwd == 0
    assert d_rc == edit_distance_np(s, rc)


@pytest.mark.parametrize("seed", [0, 3])
def test_banded_matches_oracle_short_high_error(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(6):
        n = int(rng.integers(40, 200))
        q = random_genome(rng, n)
        pairs.append((q, mutate(rng, q, rate=0.12)))
    out = np.asarray(banded_edit_distance(*pack_problems(pairs), band=128))
    expected = np.array([edit_distance_np(q, t) for q, t in pairs])
    np.testing.assert_array_equal(out, expected)


def test_banded_guard_at_band_edge():
    """A length difference of band-1 still fits the band; band does not."""
    q = b"A" * 200
    pairs = [(q, b"A" * (200 - 127)), (q, b"A" * (200 - 128))]
    out = np.asarray(banded_edit_distance(*pack_problems(pairs), band=128))
    assert out[0] == 127
    assert out[1] == -1
