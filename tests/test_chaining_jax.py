"""Equivalence: device-batched chaining DP vs the exact host oracle."""

import numpy as np
import pytest

from muchsalsa_tpu.assemble.driver import build_graph, chaining_phase
from muchsalsa_tpu.io.paf import PafRecords
from muchsalsa_tpu.io.registry import Registry
from muchsalsa_tpu.matching.edges import build_edges
from muchsalsa_tpu.matching.store import MatchStore
from muchsalsa_tpu.ops.chaining_jax import chaining_phase_device
from muchsalsa_tpu.testing.simulate import simulate


def random_records(rng, n_reads=30, n_units=12, n_rows=400):
    """Random (noisy, not necessarily consistent) match rows — stresses
    every branch of the compatibility check."""
    rows = []
    nano = rng.integers(0, n_reads, n_rows)
    illu = rng.integers(0, n_units, n_rows)
    for i in range(n_rows):
        ns = int(rng.integers(0, 15_000))
        nlen_span = int(rng.integers(450, 2_000))
        is_ = int(rng.integers(0, 300))
        ilen = int(rng.integers(420, 1_500))
        rows.append(
            dict(
                nano=int(nano[i]),
                illu=int(illu[i]),
                ns=ns,
                ne=ns + nlen_span,
                is_=is_,
                ie=is_ + ilen - 1,
                dir=bool(rng.integers(0, 2)),
                score=int(rng.integers(400, 1500)),
                primary=bool(rng.integers(0, 2)),
                line=i,
                nlen=20_000,
            )
        )
    from tests.test_matching import make_records

    return make_records(rows)


def snapshot(graph):
    out = {}
    for e in graph.edges():
        out[(e.v, e.w)] = (e.shadow, tuple(e.orders))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_equals_oracle_random(seed):
    rng = np.random.default_rng(seed)
    rec = random_records(rng)
    store = MatchStore.from_paf(rec)
    em = build_edges(store)
    if em.n_edges == 0:
        pytest.skip("no edges in random draw")

    g_host = build_graph(store, em)
    chaining_phase(g_host, store, em, 300)

    g_dev = build_graph(store, em)
    chaining_phase_device(g_dev, store, em, 300, min_device_batch=1)

    assert snapshot(g_host) == snapshot(g_dev)


def test_device_equals_oracle_simulated():
    rng = np.random.default_rng(99)
    sim = simulate(rng, genome_length=40_000, coverage=10.0)
    from muchsalsa_tpu.io.paf import read_paf
    import tempfile, pathlib

    from muchsalsa_tpu.testing.simulate import write_simulation

    d = pathlib.Path(tempfile.mkdtemp())
    paths = write_simulation(sim, d)
    rec = read_paf(paths["paf"])
    store = MatchStore.from_paf(rec)
    em = build_edges(store)

    g_host = build_graph(store, em)
    chaining_phase(g_host, store, em, 300)
    g_dev = build_graph(store, em)
    chaining_phase_device(g_dev, store, em, 300, min_device_batch=1)
    assert snapshot(g_host) == snapshot(g_dev)


def test_oversized_problems_fall_back():
    rng = np.random.default_rng(7)
    rec = random_records(rng, n_reads=4, n_units=40, n_rows=600)
    store = MatchStore.from_paf(rec)
    em = build_edges(store)
    g_host = build_graph(store, em)
    chaining_phase(g_host, store, em, 300)
    g_dev = build_graph(store, em)
    # tiny max bucket forces the host fallback path for big edges
    chaining_phase_device(g_dev, store, em, 300, chain_buckets=(4, 8), min_device_batch=1)
    assert snapshot(g_host) == snapshot(g_dev)


@pytest.mark.parametrize("K", [8, 16, 32, 64, 128])
def test_dp_batch_matches_host_oracle_every_bucket(K):
    """``chain_dp_batch`` equals the scalar host oracle's forward DP
    (``ops.chaining.check_compatibility`` in ``max_pairwise_paths``
    order) in scores and backpointers at every chaining bucket, over
    both strand classes."""
    import jax

    from __graft_entry__ import _example_batch
    from chip_smoke import oracle_dp
    from muchsalsa_tpu.ops.chaining_jax import chain_dp_batch

    B = 6
    batch = _example_batch(B, K, np.float64, seed=B + K)
    batch["cls_dir"] = jax.numpy.asarray(np.arange(B) % 2 == 0)
    scores, bps = (np.asarray(x) for x in chain_dp_batch(batch, 300))
    batch_np = {k: np.asarray(v) for k, v in batch.items()}
    for i in range(B):
        o_scores, o_bps = oracle_dp(batch_np, i, 300)
        np.testing.assert_array_equal(scores[i], o_scores)
        np.testing.assert_array_equal(bps[i], o_bps)
    assert (bps >= 0).any()  # some chains actually link
