"""Minimizer extraction + mapper tests (native minimap2-stage replacement)."""

import numpy as np
import pytest

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.ops.minimizer import fmix32, kmer_values, minimizers
from muchsalsa_tpu.pipeline.mapper import MinimizerIndex, map_read, map_all
from muchsalsa_tpu.testing.simulate import random_genome, simulate
from muchsalsa_tpu.utils.seq import encode_2bit, reverse_complement


def brute_force_kmers(seq: bytes, k: int):
    vals = []
    enc = {65: 0, 67: 1, 71: 2, 84: 3}
    for i in range(len(seq) - k + 1):
        window = seq[i : i + k]
        if any(b not in enc for b in window):
            vals.append(None)
            continue
        v = 0
        for b in window:
            v = (v << 2) | enc[b]
        vals.append(v)
    return vals


def test_kmer_values_against_bruteforce():
    rng = np.random.default_rng(3)
    seq = random_genome(rng, 200)
    k = 7
    fwd, rc, valid = kmer_values(encode_2bit(seq), k)
    expected = brute_force_kmers(seq, k)
    assert len(fwd) == len(expected)
    for i, e in enumerate(expected):
        assert valid[i]
        assert int(fwd[i]) == e
    # rc values equal forward values of the reverse complement sequence
    rc_seq = reverse_complement(seq)
    fwd_rc, _, _ = kmer_values(encode_2bit(rc_seq), k)
    np.testing.assert_array_equal(rc[::-1], fwd_rc)


def test_kmer_values_invalid_bases():
    fwd, rc, valid = kmer_values(encode_2bit(b"ACGTNACGT"), 4)
    # windows touching the N (positions 1..4) are invalid
    assert list(valid) == [True, False, False, False, False, True]


def test_minimizers_strand_symmetry():
    rng = np.random.default_rng(5)
    seq = random_genome(rng, 500)
    p1, h1, s1 = minimizers(seq, 15, 5)
    p2, h2, s2 = minimizers(reverse_complement(seq), 15, 5)
    # canonical hashing: same hash multiset on both strands
    assert sorted(h1.tolist()) == sorted(h2.tolist())


def test_fmix32_deterministic():
    x = np.array([0, 1, 2, 0xFFFFFFFF], dtype=np.uint32)
    out1 = fmix32(x)
    out2 = fmix32(x)
    np.testing.assert_array_equal(out1, out2)
    assert len(set(out1.tolist())) == 4  # no trivial collisions


def test_map_read_exact_substring():
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 10_000)
    store = SequenceStore()
    store.add("u0", genome[2000:3200])
    cfg = MapperConfig()
    index = MinimizerIndex.build(store, cfg)

    read = genome[1000:6000]
    maps = map_read(index, read, cfg)
    assert len(maps) == 1
    m = maps[0]
    assert m.strand
    # unitig sits at read offset 1000..2200
    assert abs(m.t_start - 1000) < 40
    assert abs(m.t_end - 2200) < 40
    assert m.q_start < 40 and m.q_end > 1160
    assert m.matches > 1000


def test_map_read_reverse_strand():
    rng = np.random.default_rng(13)
    genome = random_genome(rng, 8_000)
    store = SequenceStore()
    store.add("u0", genome[3000:4200])
    cfg = MapperConfig()
    index = MinimizerIndex.build(store, cfg)

    read = reverse_complement(genome[1000:6000])
    maps = map_read(index, read, cfg)
    assert len(maps) == 1
    m = maps[0]
    assert not m.strand
    # in fwd-read coords the unitig occupies [6000-4200, 6000-3000) - 1000
    assert abs(m.t_start - 1800) < 40
    assert abs(m.t_end - 3000) < 40
    assert m.matches > 1000


def test_map_read_no_hit():
    rng = np.random.default_rng(17)
    store = SequenceStore()
    store.add("u0", random_genome(rng, 1200))
    cfg = MapperConfig()
    index = MinimizerIndex.build(store, cfg)
    other = random_genome(np.random.default_rng(999), 3000)
    assert map_read(index, other, cfg) == []


def test_map_all_matches_ground_truth_pairs():
    rng = np.random.default_rng(23)
    sim = simulate(rng, genome_length=30_000, coverage=8.0, read_length=5_000)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = SequenceStore()
    for name, seq in sim.read_records():
        reads.add(name, seq)

    cfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, cfg)
    lines = map_all(
        index, reads, cfg,
        unitig_names=lambda u: unitigs.registry.name(u),
        read_names=lambda r: reads.registry.name(r),
    )

    ours = set()
    for line in lines:
        c = line.split("\t")
        if int(c[9]) >= 450:
            ours.add((c[0], c[5], c[4]))
    truth = set()
    for line in sim.paf_lines:
        c = line.split("\t")
        if int(c[9]) >= 600:
            truth.add((c[0], c[5], c[4]))
    # every confident true overlap is recovered with the right strand
    missing = truth - ours
    assert not missing, f"mapper missed {len(missing)} of {len(truth)}: {sorted(missing)[:5]}"


def test_refine_mappings_alignment_counts():
    rng = np.random.default_rng(71)
    genome = random_genome(rng, 12_000)
    unitigs = SequenceStore()
    unitigs.add("u0", genome[2000:3200])
    reads = SequenceStore()
    from muchsalsa_tpu.testing.simulate import add_noise

    noisy = add_noise(rng, genome[1000:6000], 0.05)
    rid = reads.add("r0", noisy)
    rc_rid = reads.add("r1", reverse_complement(genome[1000:6000]))

    cfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, cfg)
    per_read = [(rid, map_read(index, reads.sequence(rid), cfg)),
                (rc_rid, map_read(index, reads.sequence(rc_rid), cfg))]
    assert per_read[0][1] and per_read[1][1]

    from muchsalsa_tpu.pipeline.mapper import refine_mappings

    before = [m.matches for _, maps in per_read for m in maps]
    refine_mappings(per_read, reads, unitigs)
    after = [m.matches for _, maps in per_read for m in maps]
    # alignment-based counts exceed the merged-minimizer heuristic
    for b, a in zip(before, after):
        assert a >= b
    # the exact reverse-strand mapping should be near-perfect
    m_rc = per_read[1][1][0]
    span = max(m_rc.q_end - m_rc.q_start, m_rc.t_end - m_rc.t_start)
    assert m_rc.matches > 0.97 * span


def test_map_batch_matches_per_read():
    """Native multithreaded batch mapping returns exactly the per-read
    python-path results (same hits, same order)."""
    from muchsalsa_tpu import native
    from muchsalsa_tpu.pipeline.mapper import map_batch

    if not native.available():
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(31)
    sim = simulate(rng, genome_length=20_000, coverage=6.0, read_length=4_000)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = SequenceStore()
    for name, seq in sim.read_records():
        reads.add(name, seq)

    cfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, cfg)
    batch = map_batch(index, reads, cfg, threads=4)
    assert batch is not None

    ref = [(rid, map_read(index, seq, cfg)) for rid, seq in reads.items()]
    assert len(batch) == len(ref)
    for (rid_b, maps_b), (rid_r, maps_r) in zip(batch, ref):
        assert rid_b == rid_r
        assert maps_b == maps_r


def test_sketch_batch_matches_minimizers():
    from muchsalsa_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(37)
    seqs = [random_genome(rng, n) for n in (500, 14, 0, 2_000, 301)]
    out = native.sketch_batch_native(seqs, 15, 5, threads=3)
    assert out is not None
    read_offsets, pos, h, strand = out
    for i, seq in enumerate(seqs):
        lo, hi = int(read_offsets[i]), int(read_offsets[i + 1])
        p_ref, h_ref, s_ref = minimizers(seq, 15, 5)
        np.testing.assert_array_equal(pos[lo:hi], p_ref)
        np.testing.assert_array_equal(h[lo:hi], h_ref)
        np.testing.assert_array_equal(strand[lo:hi], s_ref)


def test_device_bucket_len_invariants():
    """Quarter-step buckets: cover n, within 25% of it (above 1024),
    256-aligned, monotone — the properties the budget scaling and the
    AOT-cache shape reuse rest on."""
    from muchsalsa_tpu.pipeline.mapper import device_bucket_len

    prev = 0
    for n in list(range(1, 4096, 37)) + list(range(4096, 200_000, 997)):
        L = device_bucket_len(n)
        assert L >= n
        assert L % 256 == 0 or L == 1024
        if n > 1024:
            assert L <= n * 1.25 + 256, (n, L)
        assert L >= prev or n < prev  # monotone in n
        prev = L


def test_device_bucket_budgets_invariants():
    """Budgets scale with the bucket and respect the structural caps."""
    from muchsalsa_tpu.pipeline.mapper import (
        device_bucket_budgets, device_bucket_len)

    for n in (900, 3_000, 9_000, 16_000, 60_000):
        L = device_bucket_len(n)
        for mph in (2, 4, 16):
            sel, pos, trim = device_bucket_budgets(L, 15, 2048, mph)
            Lk = L - 15 + 1
            assert sel % 128 == 0
            assert sel >= L // 3          # covers minimizer density 1/3
            assert sel <= Lk + 128        # never wider than the sketch
            assert pos <= min(2048, sel)
            if mph <= 2:
                assert trim is None
            elif mph <= 4:
                assert trim == pos
            else:
                assert trim == 2 * pos
        # tier-2 cap widens pos where sel allows
        _s1, p1, _t1 = device_bucket_budgets(L, 15, 2048, 4)
        _s2, p2, _t2 = device_bucket_budgets(L, 15, 4096, 16)
        assert p2 >= p1
