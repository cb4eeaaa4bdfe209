#!/usr/bin/env python3
"""Benchmark: the device kernels on the current accelerator.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Headline metric: exact edit-distance throughput of the batched Myers
bit-parallel kernel (``ops/myers_jax.py``) in GCUPS (billions of DP cell
updates per second), versus the identical computation on this host's
CPU in a child process that stays off the card.

Secondary numbers on stderr: the anchor-chaining DP, the mapping
seed+join stage, the full device mapping path, and a device-vs-host
parity check.  Every timing is warm, ends in
``block_until_ready``, and is printed beside the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

CHAIN_B, CHAIN_K = 2048, 64
ALIGN_P, ALIGN_L = 512, 2000
ITERS = 10
WIGGLE = 300


def _timed(fn, *args, iters: int = ITERS, reps: int = 3) -> float:
    """Best-of-``reps`` seconds per call of ``fn`` (compiled and warmed
    first; each rep runs ``iters`` calls and waits for the last)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _align_problems(n_problems: int = ALIGN_P):
    from muchsalsa_tpu.ops.align import pack_problems
    from muchsalsa_tpu.testing.simulate import random_genome

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(n_problems):
        q = random_genome(rng, ALIGN_L)
        t = np.frombuffer(q, dtype=np.uint8).copy()
        flip = rng.random(len(t)) < 0.1
        t[flip] = bases[rng.integers(0, 4, int(flip.sum()))]
        pairs.append((q, t.tobytes()))
    return pack_problems(pairs)


def _bench_myers(n_problems: int = ALIGN_P, iters: int = ITERS) -> float:
    """Exact edit-distance cells/s (full m*n matrix)."""
    from muchsalsa_tpu.ops.myers_jax import myers_edit_distance

    args = _align_problems(n_problems)
    dt = _timed(myers_edit_distance, *args, iters=iters)
    return n_problems * ALIGN_L * args[2].shape[1] / dt


SEED_R, SEED_L = 512, 10_240


def _bench_seeding() -> float:
    """Device mapping-lookup stage: minimizer sketch + replicated-index
    join; returns reads/s (10kb nanopore-length reads)."""
    import jax.numpy as jnp

    from muchsalsa_tpu.ops.minimizer_jax import anchor_counts_bitmap, build_hash_bitmap

    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, (SEED_R, SEED_L)).astype(np.uint8))
    lens = jnp.asarray(np.full(SEED_R, SEED_L, dtype=np.int32))
    bitmap = build_hash_bitmap(rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint32))
    return SEED_R / _timed(anchor_counts_bitmap, codes, lens, bitmap)


def _bench_full_mapping() -> float:
    """Full device mapping (sketch -> join -> chain -> Mapping tables)
    reads/s on 10 kb reads vs a 1M-entry index, via the production
    six-jit split (sketch | selcompact | probe | compact | expand |
    tail — what ``map_all_with_device`` dispatches), data
    device-resident."""
    import jax.numpy as jnp

    from muchsalsa_tpu.ops.mapping_jax import (
        anchors_to_hits_device_packed, build_device_tables,
        compact_candidates_device_v2, expand_anchors_device_v2,
        pack_codes, probe_candidates_device_v2, select_compact_device_v2,
        sketch_device_packed)
    from muchsalsa_tpu.pipeline.mapper import device_bucket_budgets

    rng = np.random.default_rng(0)
    R, L = 256, 10_240
    codes_np = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = jnp.asarray(np.full(R, L, dtype=np.int32))
    E = 1 << 20
    hashes = np.unique(np.sort(rng.integers(0, 1 << 32, E, dtype=np.uint32)))
    H = len(hashes)
    tables, hash_takes = build_device_tables(
        hashes, np.arange(H + 1, dtype=np.int64),
        rng.integers(0, 5000, H).astype(np.int32),
        rng.integers(0, 1000, H).astype(np.int32),
        rng.random(H) < 0.5,
    )
    packed_np, nmask_np = pack_codes(codes_np)
    packed = jnp.asarray(packed_np)
    nmask = jnp.asarray(nmask_np)
    max_sel, max_pos, trim = device_bucket_budgets(L, 15, 2048, 4)

    def chain(packed, nmask, lens):
        selected, h, strand = sketch_device_packed(packed, nmask, lens)
        skey, h_s, n_sel = select_compact_device_v2(
            selected, h, strand, max_sel=max_sel)
        rpv, cand = probe_candidates_device_v2(skey, h_s, tables.rp)
        sel = compact_candidates_device_v2(skey, h_s, rpv, cand, n_sel,
                                           max_pos=max_pos)
        anchors = expand_anchors_device_v2(
            *sel, tables.jrows, tables.erows, max_per_hit=4,
            hash_takes=hash_takes)
        return anchors_to_hits_device_packed(*anchors, trim=trim,
                                             per_hit_cap=4)

    return R / _timed(chain, packed, nmask, lens)


def _device_parity_check() -> str:
    """Tiny on-device regression: the device mapping (v2 join) must equal
    the host mapper on 64 simulated reads, and the device chaining DP
    must pick the same chains as the float64 host oracle.  Returns 'ok'
    or a failure description."""
    import tempfile

    from muchsalsa_tpu.assemble.driver import build_graph, chaining_phase
    from muchsalsa_tpu.config import MapperConfig
    from muchsalsa_tpu.io.fasta import SequenceStore
    from muchsalsa_tpu.io.paf import read_paf
    from muchsalsa_tpu.io.registry import Registry
    from muchsalsa_tpu.matching.edges import build_edges
    from muchsalsa_tpu.matching.store import MatchStore
    from muchsalsa_tpu.ops.chaining_jax import chaining_phase_device
    from muchsalsa_tpu.pipeline.mapper import (
        MinimizerIndex, map_all_with_device, map_read)
    from muchsalsa_tpu.testing.simulate import add_noise, simulate, write_simulation

    rng = np.random.default_rng(20260819)
    sim = simulate(rng, genome_length=60_000, coverage=5.0, read_length=2_000)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = SequenceStore()
    for i, (name, seq) in enumerate(sim.read_records()):
        if i >= 64:
            break
        reads.add(name, add_noise(rng, seq, 0.05))
    cfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, cfg)
    dev = map_all_with_device(index, reads, cfg, max_pos=1024, max_per_hit=4)
    if not dev:
        return "mapping parity check had no reads"
    for rid, maps in dev:
        if maps != map_read(index, reads.sequence(rid), cfg):
            return f"mapping device/host diverged on read {rid}"

    with tempfile.TemporaryDirectory() as td:
        paths = write_simulation(sim, td)
        records = read_paf(paths["paf"], registry_nanopore=Registry(),
                           registry_illumina=Registry())
    store = MatchStore.from_paf(records)
    em = build_edges(store)

    def run(phase):
        graph = build_graph(store, em)
        phase(graph, store, em, WIGGLE)
        return {(e.v, e.w): (e.shadow, tuple(e.orders)) for e in graph.edges()}

    if run(chaining_phase_device) != run(chaining_phase):
        return "device chaining diverged from the host float64 oracle"
    return "ok"


def _bench_chain_dp() -> float:
    """Anchor-pairs/s of the batched chaining DP."""
    import jax

    from __graft_entry__ import _example_batch
    from muchsalsa_tpu.ops.chaining_jax import chain_dp_batch

    dtype = np.float64 if jax.config.read("jax_enable_x64") else np.float32
    batch = _example_batch(CHAIN_B, CHAIN_K, dtype)
    return CHAIN_B * CHAIN_K * CHAIN_K / _timed(
        lambda b: chain_dp_batch(b, WIGGLE), batch)


def main() -> None:
    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if "--cpu-baseline" in sys.argv:
        # smaller workload: full-size Myers on a CPU takes ~30 s per call
        print(_bench_myers(n_problems=32, iters=2))
        return

    from muchsalsa_tpu.utils.device import (
        card_name_and_power_limit, device_summary)

    device = device_summary()
    backend = device["platform"]
    print(f"[bench] device: {device}; card: {card_name_and_power_limit()}",
          file=sys.stderr)

    myers_cells_per_s = _bench_myers()
    print(f"[bench] Myers exact DP on {backend}: "
          f"{myers_cells_per_s/1e9:.3f} GCUPS", file=sys.stderr)

    print(f"[bench] chain DP on {backend}: {_bench_chain_dp()/1e9:.3f} "
          f"G pairs/s (B={CHAIN_B}, K={CHAIN_K})", file=sys.stderr)

    print(f"[bench] mapping seed+join on {backend}: {_bench_seeding():.0f} "
          f"reads/s (10kb reads, 1M-entry index)", file=sys.stderr)
    print(f"[bench] full device mapping on {backend} (production 6-jit "
          f"split): {_bench_full_mapping():.0f} reads/s (10kb reads, "
          f"1M-entry index)", file=sys.stderr)
    print(f"[bench] device parity (mapping + chaining vs host oracle): "
          f"{_device_parity_check()}", file=sys.stderr)

    # CPU baseline in a child process that stays off the card
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cpu-baseline"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        cpu_cells_per_s = float(proc.stdout.strip().splitlines()[-1])
        print(f"[bench] Myers exact DP on cpu: {cpu_cells_per_s/1e9:.3f} GCUPS",
              file=sys.stderr)
        vs_baseline = myers_cells_per_s / cpu_cells_per_s
    except Exception as exc:  # baseline failure shouldn't kill the bench
        print(f"[bench] cpu baseline failed: {exc}", file=sys.stderr)
        vs_baseline = None

    print(json.dumps({
        "metric": "myers_edit_distance_gcups",
        "value": myers_cells_per_s,
        "unit": "cells/s",
        "vs_baseline": vs_baseline,
        "device": device,
    }))


if __name__ == "__main__":
    main()
