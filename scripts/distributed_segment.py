"""One process of a scrub -> map -> core PIPELINE SEGMENT across
jax.distributed processes (widen the distributed
evidence beyond single stages — scrub and core share one process group
in one run).

Stage sharding within the segment:

- scrub: BFS subsets round-robin across processes, per-subset overlap
  records allgathered, merge/emit replayed identically everywhere
  (``pipeline/scrubber.py``);
- map (scrubbed reads vs unitigs): deterministic replicated work — the
  mapper has no cross-record state, every process computes the same
  PAF (the reference's equivalent step is a per-host minimap2 fork,
  pipeline.sh:163);
- core: connected components round-robin across processes, path lists
  and output buffers allgathered (``assemble/driver.py``).

Every process writes byte-identical output; the caller keeps one.

Usage:
  python scripts/distributed_segment.py <pid> <nprocs> <coordinator> \
      <reads.fa> <anchors.paf> <unitigs.fa> <outdir> [subset_size]
"""

from __future__ import annotations

import sys
from pathlib import Path


def main() -> None:
    pid, n = int(sys.argv[1]), int(sys.argv[2])
    coordinator = sys.argv[3]
    reads_fa, paf_path, unitigs_fa = sys.argv[4], sys.argv[5], sys.argv[6]
    outdir = Path(sys.argv[7])
    subset_size = int(sys.argv[8]) if len(sys.argv) > 8 else 60_000

    import jax

    jax.config.update("jax_platforms", "cpu")
    from muchsalsa_tpu.parallel.mesh import init_distributed

    init_distributed(coordinator, n, pid)
    assert jax.process_count() == n, jax.process_count()

    import dataclasses

    from muchsalsa_tpu.assemble.driver import assemble
    from muchsalsa_tpu.config import MapperConfig, ScrubConfig
    from muchsalsa_tpu.io.fasta import SequenceStore, write_fasta
    from muchsalsa_tpu.pipeline.mapper import (
        MinimizerIndex, map_all, write_paf)
    from muchsalsa_tpu.pipeline.scrubber import (
        jax_record_allgather, scrub_reads)

    outdir.mkdir(parents=True, exist_ok=True)

    # -- scrub (subset-sharded + allgather; identical output everywhere)
    reads = SequenceStore()
    reads.load(reads_fa)
    lines = Path(paf_path).read_text().splitlines()
    scfg = dataclasses.replace(ScrubConfig(), subset_size=subset_size)
    scrubbed = scrub_reads(
        lines, reads, scfg, MapperConfig(),
        process_index=pid, process_count=n, allgather=jax_record_allgather)
    scrubbed_fa = outdir / "scrubbed.fa"
    write_fasta(scrubbed_fa, scrubbed)

    # -- map scrubbed reads vs unitigs (deterministic replicated work)
    unitigs = SequenceStore()
    unitigs.load(unitigs_fa)
    sreads = SequenceStore()
    sreads.load(scrubbed_fa)
    mcfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, mcfg)
    paf = map_all(index, sreads, mcfg,
                  unitig_names=unitigs.registry.name,
                  read_names=sreads.registry.name)
    scrubbed_paf = outdir / "scrubbed.paf"
    # sentinel line: the core parser drops the final PAF line
    write_paf(paf + ["__sentinel__\t1\t0\t1\t+\t__sentinel__\t1\t0\t1\t0\t1\t0"], scrubbed_paf)

    # -- core (component-sharded + allgather)
    summary = assemble(
        scrubbed_paf, unitigs_fa, scrubbed_fa, outdir,
        process_index=pid, process_count=n,
        allgather=jax_record_allgather)
    print(f"[distributed_segment] p{pid}/{n}: scrubbed={len(scrubbed)} "
          f"components={summary['components']} paths={summary['paths']}",
          flush=True)


if __name__ == "__main__":
    main()
