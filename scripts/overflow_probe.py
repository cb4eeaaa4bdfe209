"""Device-mapping overflow rate on a REPEAT-RICH genome .

Round 4 measured 0.00% overflow on clean simulated genomes; the static
budgets' real risk is repetitive sequence, where one minimizer indexes
many unitig positions (``max_per_hit``), candidate counts inflate
(``max_pos``) and anchor counts inflate (``trim``).  This probe builds
a genome with a configurable duplicated fraction (segmental
duplications: 5-40 kb blocks re-inserted elsewhere, plus tandem
repeats), indexes its unitigs, maps noisy reads through
``map_all_with_device`` budgets on the CPU backend (budgets are
backend-independent), and reports the per-budget overflow breakdown
plus the host-fallback wall share.

Usage: python scripts/overflow_probe.py [genome_mb=40] [dup_frac=0.15] \
    [n_reads=2000]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def repeat_rich_genome(rng, length: int, dup_frac: float) -> bytes:
    """A genome where ~``dup_frac`` of the final sequence is duplicated
    material: 70% segmental duplications (5-40 kb blocks copied to a
    random position, 2% divergence), 30% tandem repeats (0.5-4 kb unit
    repeated 3-10x, 1% divergence)."""
    from muchsalsa_tpu.testing.simulate import add_noise, random_genome

    base_len = int(length * (1.0 - dup_frac))
    genome = bytearray(random_genome(rng, base_len))
    target_dup = length - base_len
    added = 0
    while added < target_dup:
        if rng.random() < 0.7:
            blk = int(rng.integers(5_000, 40_000))
            src = int(rng.integers(0, max(1, len(genome) - blk)))
            copy = add_noise(rng, bytes(genome[src : src + blk]), 0.02)
        else:
            unit_len = int(rng.integers(500, 4_000))
            src = int(rng.integers(0, max(1, len(genome) - unit_len)))
            unit = bytes(genome[src : src + unit_len])
            n = int(rng.integers(3, 10))
            copy = b"".join(
                add_noise(rng, unit, 0.01) for _ in range(n))
        pos = int(rng.integers(0, len(genome)))
        genome[pos:pos] = copy
        added += len(copy)
    return bytes(genome[:length])


def main() -> None:
    genome_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 40.0
    dup_frac = float(sys.argv[2]) if len(sys.argv) > 2 else 0.15
    n_reads = int(sys.argv[3]) if len(sys.argv) > 3 else 2000

    import jax

    jax.config.update("jax_platforms", "cpu")  # budgets are backend-free

    from muchsalsa_tpu.config import MapperConfig
    from muchsalsa_tpu.io.fasta import SequenceStore
    from muchsalsa_tpu.pipeline.mapper import (
        DEVICE_MAP_STATS, MinimizerIndex, map_all_with_device)
    from muchsalsa_tpu.testing.simulate import add_noise

    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    L = int(genome_mb * 1e6)
    genome = repeat_rich_genome(rng, L, dup_frac)
    print(f"[overflow] {genome_mb} Mb genome, dup_frac={dup_frac} "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)

    # unitigs tile the genome like the pipeline's DBG output (1 kb
    # every 1.3 kb); repeats make many of them multi-copy
    unitigs = SequenceStore()
    step, ulen = 1_300, 1_000
    for i in range(0, L - ulen, step):
        unitigs.add(f"u{i}", genome[i : i + ulen])
    cfg = MapperConfig()
    t0 = time.perf_counter()
    index = MinimizerIndex.build(unitigs, cfg)
    print(f"[overflow] index: {len(index.hashes)} hashes, "
          f"{len(index.entry_pos)} entries ({time.perf_counter()-t0:.0f}s)",
          flush=True)

    # per-entry-count histogram: how hot are the repeat minimizers
    counts = np.diff(index.offsets)
    for thr in (4, 8, 16):
        frac = float((counts > thr).mean())
        print(f"[overflow] minimizers with >{thr} entries: {100*frac:.2f}%",
              flush=True)

    reads = SequenceStore()
    for i in range(n_reads):
        s = int(rng.integers(0, L - 9_000))
        reads.add(f"r{i}", add_noise(rng, genome[s : s + 9_000], 0.05))

    t0 = time.perf_counter()
    out = map_all_with_device(index, reads, cfg)
    wall = time.perf_counter() - t0
    ovf = DEVICE_MAP_STATS.get("overflow_reads", 0)
    print(f"[overflow] device-path map of {n_reads} reads: {wall:.1f}s; "
          f"overflow {ovf}/{n_reads} = {100.0*ovf/n_reads:.2f}% "
          f"(stats={DEVICE_MAP_STATS})", flush=True)

    # host-fallback wall share: time the host mapper on JUST the
    # overflowed read set
    if ovf:
        from muchsalsa_tpu.pipeline.mapper import map_read

        # per-read host cost from a sample -> fallback wall estimate
        sample = [seq for _rid, seq in list(reads.items())[:200]]
        t0 = time.perf_counter()
        for seq in sample:
            map_read(index, seq, cfg)
        per_read = (time.perf_counter() - t0) / len(sample)
        print(f"[overflow] host map_read ~{per_read*1e3:.1f} ms/read -> "
              f"fallback wall ≈ {ovf*per_read:.1f}s of the {wall:.1f}s pass",
              flush=True)


if __name__ == "__main__":
    main()
