"""S. cerevisiae-scale full-pipeline run (BASELINE.json config ladder).

Simulates a 12 Mb genome at 12x coverage with 7% read error and 20%
junk-tailed reads, then drives the `full` pipeline (map -> unitig-filter
-> map -> scrub -> map -> core) and reports per-stage wall time and
contig stats.  Usage: python scripts/scale_run.py [genome_mb] [coverage]
"""

import sys
import time
from pathlib import Path

import numpy as np

from muchsalsa_tpu.io.fasta import write_fasta
from muchsalsa_tpu.testing.simulate import (
    illumina_pairs, nanopore_reads, simulate,
)


def main():
    genome_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 12.0
    coverage = float(sys.argv[2]) if len(sys.argv) > 2 else 12.0
    out = Path(sys.argv[3]) if len(sys.argv) > 3 else Path("scratch_runs/scale_run")
    illu_cov = float(sys.argv[4]) if len(sys.argv) > 4 else 30.0
    # tri-state device placement: default auto (device stages when an
    # accelerator is attached); --host forces the all-host pipeline,
    # --device-map forces just the map stages on
    device_map = True if "--device-map" in sys.argv else None
    device_all_off = "--host" in sys.argv
    out.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(1234)
    t0 = time.perf_counter()
    sim = simulate(
        rng,
        genome_length=int(genome_mb * 1e6),
        coverage=coverage,
        read_length=9_000,
        unitig_length=1_000,
        unitig_gap=300,
    )

    # 7% error; 20% of reads get a junk tail, as real nanopore data has
    # adapter/chimeric ends the scrubber trims
    nano = out / "nanopore.fa"
    write_fasta(nano, nanopore_reads(rng, sim, 0.07, 0.2))
    pairs = illumina_pairs(rng, sim.genome, coverage=illu_cov)
    illu1, illu2 = out / "illu1.fa", out / "illu2.fa"
    write_fasta(illu1, ((f"p{i}/1", a) for i, (a, b) in enumerate(pairs)))
    write_fasta(illu2, ((f"p{i}/2", b) for i, (a, b) in enumerate(pairs)))
    print(f"[scale_run] simulation written in {time.perf_counter()-t0:.1f}s")

    from muchsalsa_tpu.config import Config
    from muchsalsa_tpu.pipeline.full import run_full_pipeline
    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    t0 = time.perf_counter()
    final = run_full_pipeline(
        str(illu1), str(illu2), str(nano), str(out / "full_out"), Config(),
        device_map=False if device_all_off else device_map,
        device_kmer=False if device_all_off else None,
        device_scrub=False if device_all_off else None,
    )
    total = time.perf_counter() - t0
    print(f"[scale_run] full pipeline: {total:.1f}s")

    lens = []
    cur = 0
    for line in open(final):
        if line.startswith(">"):
            if cur:
                lens.append(cur)
            cur = 0
        else:
            cur += len(line.strip())
    if cur:
        lens.append(cur)
    lens.sort(reverse=True)
    tot = sum(lens)
    acc, n50 = 0, 0
    for L in lens:
        acc += L
        if acc >= tot / 2:
            n50 = L
            break
    print(f"[scale_run] contigs={len(lens)} total={tot/1e6:.2f}Mb "
          f"N50={n50/1e6:.2f}Mb longest={lens[0]/1e6:.2f}Mb")


if __name__ == "__main__":
    main()
