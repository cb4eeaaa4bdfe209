"""Full end-to-end pipeline: raw reads -> unpolished assembly.

Native equivalent of ``pipeline/pipeline.sh:104-186`` with every
external tool replaced:

  ① jellyfish+bbduk  -> pipeline.kmer        (k-mer filter of Illumina)
  ② abyss-pe + awk   -> pipeline.dbg          (unitigs, >= min length)
  ③ minimap2 #1      -> pipeline.mapper       (unitigs -> long reads)
  ④ unitig_filter.py -> pipeline.unitig_filter
  ⑤ minimap2 #2      -> pipeline.mapper
  ⑥ scrubber_bfs.py  -> pipeline.scrubber     (native ava overlaps)
  ⑦ minimap2 #3      -> pipeline.mapper       (corrected -> scrubbed)
  ⑧ muchsalsa        -> assemble.driver
  ⑨ copy target      -> 03.assembly.unpolished.fa

Stages checkpoint through :class:`StageRunner` manifests (resumable).
"""

from __future__ import annotations

import shutil
from pathlib import Path

from muchsalsa_tpu.config import Config, DEFAULT_CONFIG
from muchsalsa_tpu.io.fasta import SequenceStore, write_fasta
from muchsalsa_tpu.pipeline.stages import StageRunner


def accelerator_attached() -> bool:
    """True when JAX's default backend is an accelerator (not the host
    CPU).  Device stage placement defaults to this."""
    import jax

    return jax.default_backend() != "cpu"


def _read_pairs(path1: Path, path2: Path | None):
    s1 = SequenceStore.from_file(path1)
    seqs1 = [s1.sequence(i) for i in s1.ids()]
    if path2 is None:
        return [(s, b"") for s in seqs1]
    s2 = SequenceStore.from_file(path2)
    seqs2 = [s2.sequence(i) for i in s2.ids()]
    if len(seqs2) < len(seqs1):
        seqs2 += [b""] * (len(seqs1) - len(seqs2))
    return list(zip(seqs1, seqs2))


def run_full_pipeline(
    illumina1: str | Path,
    illumina2: str | Path | None,
    nanopore: str | Path,
    outdir: str | Path,
    config: Config = DEFAULT_CONFIG,
    kmer_filter_k: int | None = None,
    unitig_k: int = 31,
    device_map: bool | None = None,
    device_kmer: bool | None = None,
    device_scrub: bool | None = None,
    device_dbg: bool | None = None,
) -> Path:
    # tri-state placement flags: None = auto (device when an accelerator
    # is attached), True/False = forced by the caller/CLI
    auto = accelerator_attached()
    device_map = auto if device_map is None else device_map
    device_kmer = auto if device_kmer is None else device_kmer
    device_scrub = auto if device_scrub is None else device_scrub
    device_dbg = auto if device_dbg is None else device_dbg

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    runner = StageRunner(out)
    report = out / "report.txt"
    with open(report, "a") as fh:
        fh.write(
            f"device placement: map={device_map} kmer={device_kmer} "
            f"scrub={device_scrub} dbg={device_dbg} "
            f"(accelerator_attached={auto})\n"
        )

    illumina1 = Path(illumina1)
    illumina2 = Path(illumina2) if illumina2 else None
    nanopore = Path(nanopore)
    k_filter = kmer_filter_k or config.pipeline.kmer_k_filter

    filtered_fa = out / "01_illu_filtered.fa"
    unitigs_fa = out / "01_unitigs.fa"
    paf1 = out / "01_unitigs.paf"
    corrected_fa = out / "01_unitigs_corrected.fa"
    paf2 = out / "01_contigs_corrected.paf"
    scrubbed_fa = out / "02_scrubbed.fa"
    paf3 = out / "02_contigs_corrected.scrubbed.paf"
    core_out = out / "core"
    final_fa = out / "03.assembly.unpolished.fa"

    # ① k-mer filter of Illumina reads
    def stage_kmer():
        from muchsalsa_tpu.pipeline.kmer import (
            abundance_threshold,
            count_kmers,
            filter_read_pairs,
            high_abundance_kmers,
            histogram,
        )

        pairs = _read_pairs(illumina1, illumina2)
        seqs = [s for p in pairs for s in p if s]
        if device_kmer:
            from muchsalsa_tpu.ops.kmer_jax import count_kmers_device

            uniq, counts = count_kmers_device(seqs, k_filter)
        else:
            uniq, counts = count_kmers(seqs, k_filter)
        th = abundance_threshold(histogram(counts))
        bad = high_abundance_kmers(uniq, counts, max(th, 2))
        kept = filter_read_pairs(pairs, bad, k_filter)
        with open(report, "a") as fh:
            fh.write(f"abundance threshold for k-mer filtering: {th}\n")
            fh.write(f"read pairs kept: {len(kept)}/{len(pairs)}\n")
        records = []
        for i, (a, b) in enumerate(kept):
            records.append((f"pair{i}/1", a))
            if b:
                records.append((f"pair{i}/2", b))
        write_fasta(filtered_fa, records)

    runner.run(
        "kmer_filter",
        [p for p in (illumina1, illumina2) if p],
        [filtered_fa],
        stage_kmer,
        {"k": k_filter},
    )

    # ② unitig construction
    def stage_unitigs():
        from muchsalsa_tpu.pipeline.dbg import build_unitigs

        store = SequenceStore.from_file(filtered_fa)
        seqs = [store.sequence(i) for i in store.ids()]
        unitigs = build_unitigs(
            seqs, k=unitig_k, min_count=2,
            min_length=config.pipeline.min_unitig_length,
            device=device_dbg,
        )
        write_fasta(unitigs_fa, ((f"unitig_{i}", u) for i, u in enumerate(unitigs)))

    runner.run("unitigs", [filtered_fa], [unitigs_fa], stage_unitigs, {"k": unitig_k})

    # helper: native mapping stage.  Stores load once per path so the
    # device mapper's resident read batches survive across the three
    # map stages (reads cross the host->device link once, not thrice)
    _stores: dict[Path, SequenceStore] = {}

    def load_store(path: Path) -> SequenceStore:
        store = _stores.get(path)
        if store is None:
            store = SequenceStore.from_file(path)
            _stores[path] = store
        return store

    def map_stage(query_fa: Path, target_fa: Path, out_paf: Path):
        from muchsalsa_tpu.pipeline.mapper import (
            DEVICE_MAP_STATS, MinimizerIndex, map_all, write_paf)

        unitigs = load_store(query_fa)
        reads = load_store(target_fa)
        index = MinimizerIndex.build(unitigs, config.mapper)
        lines = map_all(
            index, reads, config.mapper,
            unitig_names=lambda u: unitigs.registry.name(u),
            read_names=lambda r: reads.registry.name(r),
            unitigs=unitigs,
            device=device_map,
        )
        if device_map and "total_reads" in DEVICE_MAP_STATS:
            # overflow reads fell back to the exact host mapper — a high
            # rate means the "device run" quietly became a host run
            tot = DEVICE_MAP_STATS["total_reads"]
            ovf = DEVICE_MAP_STATS["overflow_reads"]
            with open(report, "a") as fh:
                fh.write(
                    f"device map {out_paf.name}: {tot - ovf}/{tot} reads on "
                    f"device, {ovf} overflow->host "
                    f"({100.0 * ovf / max(tot, 1):.1f}%)\n"
                )
        # the core parser drops the final PAF line by reference parity:
        # terminate with a sentinel so no real mapping is lost
        write_paf(lines + ["__sentinel__\t1\t0\t1\t+\t__sentinel__\t1\t0\t1\t0\t1\t0"], out_paf)

    # ③ map unitigs onto long reads
    runner.run(
        "map_unitigs",
        [unitigs_fa, nanopore],
        [paf1],
        lambda: map_stage(unitigs_fa, nanopore, paf1),
    )

    # ④ unitig coverage filter
    def stage_unitig_filter():
        from muchsalsa_tpu.pipeline.unitig_filter import filter_unitigs

        store = SequenceStore.from_file(unitigs_fa)
        seqs = {store.registry.name(i): store.sequence(i) for i in store.ids()}
        lines = [l for l in paf1.read_text().splitlines() if l and "__sentinel__" not in l]
        corrected, stats = filter_unitigs(
            lines, seqs, config.pipeline.unitig_iqr_multiplier,
            config.pipeline.min_unitig_length,
        )
        with open(report, "a") as fh:
            fh.write(">>> unitig filter\n")
            fh.write(f"upper_outlier: {stats.cutoff}\nQ3: {stats.q3}\n")
            fh.write(f"#all unitigs: {stats.all_count}\n#outliers: {stats.outlier_count}\n")
            fh.write(f"#rescued outliers: {stats.rescued_count}\n")
        write_fasta(corrected_fa, corrected)

    runner.run("unitig_filter", [paf1, unitigs_fa], [corrected_fa], stage_unitig_filter)

    # ⑤ re-map corrected unitigs
    runner.run(
        "map_corrected",
        [corrected_fa, nanopore],
        [paf2],
        lambda: map_stage(corrected_fa, nanopore, paf2),
    )

    # ⑥ scrub long reads
    def stage_scrub():
        from muchsalsa_tpu.pipeline.scrubber import (
            DEVICE_SCRUB_STATS, scrub_reads)

        reads = SequenceStore.from_file(nanopore)
        lines = [l for l in paf2.read_text().splitlines() if l and "__sentinel__" not in l]
        scrubbed = scrub_reads(lines, reads, config.scrub, config.mapper,
                               device=device_scrub)
        if device_scrub:
            # the multiplicity guard sends a subset's all-vs-all back to
            # the host; say so, or a declined stage reads as a device run
            with open(report, "a") as fh:
                fh.write(
                    f"device scrub: {DEVICE_SCRUB_STATS['declined']}/"
                    f"{DEVICE_SCRUB_STATS['subsets']} subsets declined "
                    f"to host\n")
        write_fasta(scrubbed_fa, scrubbed)

    runner.run("scrub", [paf2, nanopore], [scrubbed_fa], stage_scrub)

    # ⑦ map corrected unitigs onto scrubbed reads
    runner.run(
        "map_scrubbed",
        [corrected_fa, scrubbed_fa],
        [paf3],
        lambda: map_stage(corrected_fa, scrubbed_fa, paf3),
    )

    # mapping stages done: release host stores + device-resident batches
    _stores.clear()

    # ⑧ core assembly
    def stage_core():
        from muchsalsa_tpu.assemble.driver import assemble

        assemble(paf3, corrected_fa, scrubbed_fa, core_out, config)

    runner.run(
        "core_assembly",
        [paf3, corrected_fa, scrubbed_fa],
        [core_out / "temp_1.target.fa"],
        stage_core,
    )

    # ⑨ final copy (pipeline.sh:181)
    shutil.copyfile(core_out / "temp_1.target.fa", final_fa)
    return final_fa
