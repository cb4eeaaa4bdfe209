"""Raw reads -> assembly through every native stage (no external tools,
no ground-truth PAF) + manifest resume."""

import json

import numpy as np

from muchsalsa_tpu.io.fasta import write_fasta
from muchsalsa_tpu.pipeline.full import run_full_pipeline
from muchsalsa_tpu.testing.simulate import illumina_pairs, random_genome
from muchsalsa_tpu.utils.seq import reverse_complement
from tests.test_end_to_end import kmer_hit_fraction, read_contigs


def make_inputs(tmp_path, genome_len=20_000, seed=123):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)

    pairs = illumina_pairs(rng, genome, coverage=25.0)
    illu1 = tmp_path / "illu_1.fa"
    illu2 = tmp_path / "illu_2.fa"
    write_fasta(illu1, ((f"p{i}/1", a) for i, (a, b) in enumerate(pairs)))
    write_fasta(illu2, ((f"p{i}/2", b) for i, (a, b) in enumerate(pairs)))

    # long reads, both strands, error-free
    reads = []
    read_len = 5000
    n_reads = int(10.0 * genome_len / read_len)
    for r in range(n_reads):
        start = int(rng.integers(0, max(1, genome_len - read_len)))
        seq = genome[start : start + read_len]
        if rng.integers(0, 2):
            seq = reverse_complement(seq)
        reads.append((f"read_{r}", seq))
    nano = tmp_path / "nano.fa"
    write_fasta(nano, reads)
    return genome, illu1, illu2, nano


def test_full_pipeline_end_to_end(tmp_path):
    genome, illu1, illu2, nano = make_inputs(tmp_path)
    out = tmp_path / "out"

    final = run_full_pipeline(illu1, illu2, nano, out)
    assert final.exists()

    contigs = read_contigs(final)
    assert contigs, "no contigs"
    total = sum(len(c) for c in contigs.values())
    assert total > 0.4 * len(genome), f"assembled only {total} of {len(genome)}"
    for name, contig in contigs.items():
        frac = kmer_hit_fraction(contig, genome)
        assert frac > 0.8, f"{name}: {frac:.2%}"

    # report has the stage stats
    report = (out / "report.txt").read_text()
    assert "abundance threshold" in report
    assert "unitig filter" in report


def test_full_pipeline_resume(tmp_path):
    _, illu1, illu2, nano = make_inputs(tmp_path, genome_len=12_000, seed=5)
    out = tmp_path / "out"
    run_full_pipeline(illu1, illu2, nano, out)

    manifest1 = json.loads((out / "manifest.json").read_text())
    stamp1 = {k: v["elapsed_s"] for k, v in manifest1.items()}
    assert len(stamp1) >= 7

    # second run: all stages skipped (manifest unchanged)
    run_full_pipeline(illu1, illu2, nano, out)
    manifest2 = json.loads((out / "manifest.json").read_text())
    assert manifest1 == manifest2


def test_full_pipeline_device_map_matches_host(tmp_path):
    """`--device-map` through the full pipeline (meshed over the 8
    virtual CPU devices) must produce a byte-identical assembly to the
    all-host run — the pipeline-level form of the mapper parity
    contract."""
    _genome, illu1, illu2, nano = make_inputs(tmp_path, seed=321)

    host_out = tmp_path / "host"
    dev_out = tmp_path / "dev"
    host_final = run_full_pipeline(illu1, illu2, nano, host_out,
                                   device_map=False)
    dev_final = run_full_pipeline(illu1, illu2, nano, dev_out,
                                  device_map=True)
    assert dev_final.read_bytes() == host_final.read_bytes()
    # the three PAF stages must match too (the maps are where the
    # device path actually ran)
    for name in ("01_unitigs.paf", "01_contigs_corrected.paf",
                 "02_contigs_corrected.scrubbed.paf"):
        assert (dev_out / name).read_bytes() == (
            host_out / name).read_bytes(), name


def test_auto_placement_is_host_on_cpu(tmp_path):
    """On the CPU backend auto placement keeps every stage on the host."""
    from muchsalsa_tpu.pipeline import full

    assert full.accelerator_attached() is False
    _, illu1, illu2, nano = make_inputs(tmp_path, genome_len=12_000, seed=9)
    run_full_pipeline(illu1, illu2, nano, tmp_path / "out")
    report = (tmp_path / "out" / "report.txt").read_text()
    assert ("device placement: map=False kmer=False scrub=False dbg=False "
            "(accelerator_attached=False)") in report


def test_auto_placement_follows_accelerator_alone(tmp_path, monkeypatch):
    """An attached accelerator puts all four stages on the device — no
    link probe or other measurement can veto it — and the assembly is
    byte-identical to the all-host run.  The scrub's decline counter is
    written to the report."""
    from muchsalsa_tpu.pipeline import full

    _, illu1, illu2, nano = make_inputs(tmp_path, genome_len=12_000, seed=9)
    host_final = run_full_pipeline(
        illu1, illu2, nano, tmp_path / "host", device_map=False,
        device_kmer=False, device_scrub=False, device_dbg=False)

    monkeypatch.setattr(full, "accelerator_attached", lambda: True)
    dev_final = run_full_pipeline(illu1, illu2, nano, tmp_path / "dev")
    report = (tmp_path / "dev" / "report.txt").read_text()
    assert ("device placement: map=True kmer=True scrub=True dbg=True "
            "(accelerator_attached=True)") in report
    assert "device map 01_unitigs.paf:" in report
    assert "subsets declined to host" in report
    assert dev_final.read_bytes() == host_final.read_bytes()
