"""Reference-binary parity + throughput at scale.

Simulates a genome (clean truth PAF, same generator as the parity
tests), runs the REAL reference C++ assembler (built offline by
scripts/build_reference.sh) and this repo's assembler on identical
inputs, asserts output parity (target byte-equal; query/PAF multiset
equal modulo incidental record numbering, ap.cpp:1052), and prints the
reads/s through core assembly of both.

Usage: python scripts/parity_scale_run.py [genome_mb=12] [coverage=15]
         [threads=2] [--skip-ref]
"""

from __future__ import annotations

import collections
import json
import re
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
REF_BIN = REPO / "build_ref" / "muchsalsa"


def _strip_idx(name: bytes) -> bytes:
    if re.match(rb"^(Left|Right|Middle|Contain_[A-Za-z_]+)\.", name):
        return re.sub(rb"\.\d+$", b"", name)
    return name


def _fasta_multiset(path: Path) -> collections.Counter:
    recs: collections.Counter = collections.Counter()
    name, seq = None, []
    for line in path.read_bytes().split(b"\n"):
        if line.startswith(b">"):
            if name is not None:
                recs[(_strip_idx(name), b"".join(seq))] += 1
            name, seq = line[1:], []
        elif line:
            seq.append(line)
    if name is not None:
        recs[(_strip_idx(name), b"".join(seq))] += 1
    return recs


def _paf_multiset(path: Path) -> collections.Counter:
    rows: collections.Counter = collections.Counter()
    for line in path.read_bytes().split(b"\n"):
        if not line:
            continue
        f = line.split(b"\t")
        rows[(_strip_idx(f[0]), *f[1:])] += 1
    return rows


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    genome_mb = float(args[0]) if args else 12.0
    coverage = float(args[1]) if len(args) > 1 else 15.0
    threads = int(args[2]) if len(args) > 2 else 2
    skip_ref = "--skip-ref" in sys.argv

    from muchsalsa_tpu.testing.simulate import simulate, write_simulation
    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    rng = np.random.default_rng(20260820)
    print(f"[parity] simulating {genome_mb} Mb, {coverage}x ...", flush=True)
    sim = simulate(
        rng, genome_length=int(genome_mb * 1e6), coverage=coverage,
        read_length=9_000, unitig_length=1_000, unitig_gap=300,
        both_strands=True,
    )
    td = Path(tempfile.mkdtemp(prefix="parity_scale_"))
    paths = write_simulation(sim, td / "data")
    n_reads = sum(1 for _ in open(paths["reads"], "rb") if _.startswith(b">"))
    print(f"[parity] {n_reads} reads, dir={td}", flush=True)

    result = {"genome_mb": genome_mb, "coverage": coverage,
              "n_reads": n_reads, "threads": threads}

    if not skip_ref and REF_BIN.exists():
        refout = td / "refout"
        refout.mkdir()
        t0 = time.perf_counter()
        r = subprocess.run(
            [str(REF_BIN), str(paths["paf"]), str(paths["unitigs"]),
             str(paths["reads"]), str(refout), str(threads)],
            capture_output=True, text=True, timeout=7200,
        )
        ref_s = time.perf_counter() - t0
        assert r.returncode == 0, r.stderr[-2000:]
        ref_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6
        result["reference_wall_s"] = round(ref_s, 1)
        result["reference_reads_per_s"] = round(n_reads / ref_s, 1)
        result["reference_peak_rss_gb"] = round(ref_rss, 2)
        print(f"[parity] reference binary: {ref_s:.1f}s "
              f"({n_reads/ref_s:.0f} reads/s)", flush=True)

    from muchsalsa_tpu.assemble.driver import assemble

    myout = td / "myout"
    t0 = time.perf_counter()
    res = assemble(paths["paf"], paths["unitigs"], paths["reads"], myout,
                   workers=threads)
    my_s = time.perf_counter() - t0
    result["repo_wall_s"] = round(my_s, 1)
    result["repo_reads_per_s"] = round(n_reads / my_s, 1)
    timer = res["timer"]
    result["repo_stages"] = {k: round(v, 1) for k, v in timer.stages.items()}
    print(f"[parity] muchsalsa_tpu: {my_s:.1f}s ({n_reads/my_s:.0f} reads/s)",
          flush=True)

    if not skip_ref and REF_BIN.exists():
        ref_t = (refout / "temp_1.target.fa").read_bytes()
        my_t = (myout / "temp_1.target.fa").read_bytes()
        assert my_t == ref_t, "assembly FASTA differs from reference"
        assert _fasta_multiset(myout / "temp_1.query.fa") == _fasta_multiset(
            refout / "temp_1.query.fa"), "query multiset differs"
        assert _paf_multiset(myout / "temp_1.align.paf") == _paf_multiset(
            refout / "temp_1.align.paf"), "paf multiset differs"
        result["parity"] = "byte-identical target; query/paf multiset-equal"
        result["speedup_vs_reference"] = round(
            result["reference_wall_s"] / my_s, 2)
        print(f"[parity] PARITY PASS; speedup {result['speedup_vs_reference']}x",
              flush=True)

    print(json.dumps(result))


if __name__ == "__main__":
    main()
