#!/usr/bin/env python3
"""GPU smoke run: the assembler's main path, end to end, on one card.

Run from the root of a checkout:

    python chip_smoke.py                 # one card, phases 1-6
    python chip_smoke.py --four-cards    # four cards, phase 7 only

Phases (each one fails the run; nothing is caught and passed over):

1. device — JAX's default device must be a GPU; prints its kind, the
   card's name and power limit, and the JAX/jaxlib versions.
2. workload — an E. coli K-12-class deployment simulated from a fixed
   seed with the read profile of ``scripts/scale_run.py``: a 4.6 Mb
   genome, 9 kb nanopore reads with 7% error and 20% junk tails, 30x
   Illumina pairs.  Nanopore coverage is 12x (reduced from the ~50x of
   BASELINE.json's config ladder so the smoke fits in minutes).
3. main path — ``cli.main(["full", ...])`` with auto placement; the
   report must place map, kmer, dbg and scrub on the device.  Prints
   each stage's wall, each map pass's overflow->host share, and whether
   the scrub's multiplicity guard declined subsets to the host.
4. host oracle — the same ``full`` with every ``--no-device-*`` flag and
   ``DeviceConfig.use_device=False``; ``03.assembly.unpolished.fa`` must
   be byte-identical to phase 3's.
5. forced device core — ``assemble()`` on phase 3's core inputs with the
   edges and chaining size gates at 0, against ``use_device=False``; the
   three ``temp_1.*`` outputs must be byte-identical.  Device chaining
   runs in float32 (x64 is off) and the oracle in float64; the outputs
   are chain choices, not scores, so equality is exact.  No matrix
   product exists in the package (no dot, matmul or einsum), so TF32
   cannot enter.
6. kernel check — the chaining DP production runs (``chain_dp_batch``,
   compiled for the card) at every bucket K of
   ``DeviceConfig.chain_buckets`` on 2^16 problems: scores and
   backpointers bit-equal in float32 to the float64 host oracle
   ``ops.chaining`` on a sample of problems spread over the batch;
   prints the first-call and warm median times.
7. ``--four-cards`` — mapping (``map_all_with_device``) and the core
   (``assemble()``, gates at 0) over a 4-card mesh on the phase-2
   workload; PAF and core outputs byte-equal to the host runs.

The last line of standard output is one JSON object, printed only when
every phase passed:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from muchsalsa_tpu.config import DEFAULT_CONFIG, Config
from muchsalsa_tpu.utils.compile_cache import CHECKOUT, enable_compile_cache
from muchsalsa_tpu.utils.device import card_name_and_power_limit, device_summary

WORKDIR = CHECKOUT / "scratch_runs" / "chip_smoke"
WORKLOAD = dict(genome_mb=4.6, nano_cov=12.0, illu_cov=30.0, read_length=9_000,
                error_rate=0.07, junk_fraction=0.2, seed=1234)
DEVICE_STAGES = ("map", "kmer", "scrub", "dbg")
CORE_OUTPUTS = ("temp_1.target.fa", "temp_1.query.fa", "temp_1.align.paf")
KERNEL_BATCH = 1 << 16
ORACLE_SAMPLE = 128
WIGGLE = DEFAULT_CONFIG.graph.wiggle_room


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def host_config() -> Config:
    return dataclasses.replace(DEFAULT_CONFIG, device=dataclasses.replace(
        DEFAULT_CONFIG.device, use_device=False))


def forced_core_config() -> Config:
    return dataclasses.replace(DEFAULT_CONFIG, device=dataclasses.replace(
        DEFAULT_CONFIG.device, edges_device_min_rows=0,
        chain_device_min_problems=0))


# -- phase 1 ----------------------------------------------------------------

def phase_device(n_cards: int) -> dict:
    import jax
    import jaxlib

    dev = device_summary()
    log(f"[device] platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    require(dev["platform"] == "gpu",
            f"JAX's default device is {dev['platform']!r}, not a GPU")
    require(dev["count"] >= n_cards,
            f"{n_cards} cards needed, JAX sees {dev['count']}")
    log("[device] nvidia-smi --query-gpu=name,power.limit:")
    log(card_name_and_power_limit())
    log(f"[device] jax {jax.__version__} jaxlib {jaxlib.__version__}")
    from muchsalsa_tpu import native

    log(f"[device] native host runtime built: {native.available()}")
    return dev


# -- phase 2 ----------------------------------------------------------------

def make_workload(outdir: Path, genome_mb: float, nano_cov: float,
                  illu_cov: float, read_length: int, error_rate: float,
                  junk_fraction: float, seed: int) -> dict:
    """Simulated deployment files: nanopore reads, Illumina pairs, and
    the simulation's exact unitig tiling (for the mesh phase)."""
    from muchsalsa_tpu.io.fasta import write_fasta
    from muchsalsa_tpu.testing.simulate import (
        illumina_pairs, nanopore_reads, simulate)

    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sim = simulate(rng, genome_length=int(genome_mb * 1e6),
                   coverage=nano_cov, read_length=read_length,
                   unitig_length=1_000, unitig_gap=300)
    paths = {name: outdir / f"{name}.fa"
             for name in ("nanopore", "illu1", "illu2", "unitigs")}
    write_fasta(paths["nanopore"],
                nanopore_reads(rng, sim, error_rate, junk_fraction))
    pairs = illumina_pairs(rng, sim.genome, coverage=illu_cov)
    write_fasta(paths["illu1"], ((f"p{i}/1", a) for i, (a, _b) in enumerate(pairs)))
    write_fasta(paths["illu2"], ((f"p{i}/2", b) for i, (_a, b) in enumerate(pairs)))
    write_fasta(paths["unitigs"], sim.unitig_records())
    log(f"[workload] {genome_mb} Mb genome, {len(sim.reads)} nanopore reads "
        f"({nano_cov}x, {read_length} bp, {error_rate:.0%} error, "
        f"{junk_fraction:.0%} junk tails), {len(pairs)} Illumina pairs "
        f"({illu_cov}x)")
    return paths


# -- phases 3 and 4 -----------------------------------------------------------

def run_full(paths: dict, out: Path, host: bool) -> float:
    from muchsalsa_tpu.pipeline import cli

    argv = ["full", "--illumina1", str(paths["illu1"]),
            "--illumina2", str(paths["illu2"]),
            "--nanopore", str(paths["nanopore"]), "--out", str(out)]
    if host:
        cfg_path = out.parent / f"{out.name}.config.json"
        host_config().save(cfg_path)
        argv = ["--config", str(cfg_path), *argv,
                *(f"--no-device-{s}" for s in DEVICE_STAGES)]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    require(rc == 0, f"cli full exited {rc}")
    return wall


def report_stages(out: Path, label: str) -> None:
    manifest = json.loads((out / "manifest.json").read_text())
    for stage, entry in manifest.items():
        log(f"[{label}] stage {stage}: {entry['elapsed_s']} s")


def phase_main_path(paths: dict, out: Path) -> None:
    wall = run_full(paths, out, host=False)
    log(f"[main path] cli full wall: {wall} s")
    report = (out / "report.txt").read_text()
    placement = next(l for l in report.splitlines()
                     if l.startswith("device placement:"))
    log(f"[main path] {placement}")
    for stage in DEVICE_STAGES:
        require(f"{stage}=True" in placement,
                f"stage {stage} was not placed on the device: {placement}")
    map_lines = [l for l in report.splitlines() if l.startswith("device map ")]
    require(len(map_lines) == 3, f"expected 3 device map passes: {map_lines}")
    for line in map_lines:
        log(f"[main path] {line}")
    scrub = [l for l in report.splitlines() if l.startswith("device scrub:")]
    require(len(scrub) == 1, "report lacks the device scrub line")
    declined, subsets = (int(x) for x in
                         scrub[0].split()[2].split("/"))
    log(f"[main path] {scrub[0]} — multiplicity guard "
        + (f"DECLINED {declined} of {subsets} subsets: their all-vs-all "
           f"ran on the host" if declined else "did not decline"))
    report_stages(out, "main path")


def phase_host_oracle(paths: dict, dev_out: Path, host_out: Path) -> None:
    wall = run_full(paths, host_out, host=True)
    log(f"[host oracle] cli full wall: {wall} s")
    report_stages(host_out, "host oracle")
    placement = (host_out / "report.txt").read_text().splitlines()[0]
    require("map=False kmer=False scrub=False dbg=False" in placement,
            f"host oracle placed a stage on the device: {placement}")
    for name in ("01_unitigs.fa", "01_unitigs.paf", "01_unitigs_corrected.fa",
                 "01_contigs_corrected.paf", "02_scrubbed.fa",
                 "02_contigs_corrected.scrubbed.paf"):
        same = (dev_out / name).read_bytes() == (host_out / name).read_bytes()
        log(f"[host oracle] {name}: {'identical' if same else 'DIFFERS'}")
    final = "03.assembly.unpolished.fa"
    require((dev_out / final).read_bytes() == (host_out / final).read_bytes(),
            f"{final} differs between the device and host runs")
    n_contigs = (dev_out / final).read_text().count(">")
    require(n_contigs > 0, "the assembly has no contigs")
    log(f"[host oracle] {final}: byte-identical ({n_contigs} contigs)")


# -- phase 5 ----------------------------------------------------------------

def run_core(paf: Path, unitigs: Path, reads: Path, out: Path,
             config: Config) -> dict:
    from muchsalsa_tpu.assemble.driver import assemble

    t0 = time.perf_counter()
    result = assemble(paf, unitigs, reads, out, config, workers=1)
    result["wall"] = time.perf_counter() - t0
    return result


def compare_core(a: Path, b: Path, label: str) -> None:
    for name in CORE_OUTPUTS:
        require((a / name).read_bytes() == (b / name).read_bytes(),
                f"{label}: {name} differs from the host run")
    log(f"[{label}] {', '.join(CORE_OUTPUTS)}: byte-identical")


def phase_forced_core(full_out: Path, work: Path) -> None:
    inputs = (full_out / "02_contigs_corrected.scrubbed.paf",
              full_out / "01_unitigs_corrected.fa", full_out / "02_scrubbed.fa")
    dev = run_core(*inputs, work / "core_device", forced_core_config())
    host = run_core(*inputs, work / "core_host", host_config())
    counters = dev["timer"].counters
    require(counters.get("edges_on_device") == 1
            and counters.get("chaining_on_device") == 1,
            f"forced core stayed on the host: {counters}")
    for label, res in (("device", dev), ("host", host)):
        stages = res["timer"].stages
        log(f"[forced core] {label}: wall {res['wall']} s, edges "
            f"{stages['edges']} s, chaining {stages['chaining']} s, "
            f"graph_size {res['timer'].counters['graph_size']}")
    compare_core(work / "core_device", work / "core_host", "forced core")


# -- phase 6 ----------------------------------------------------------------

def oracle_dp(batch_np: dict, i: int, wiggle_room: int):
    """Scores + backpointers of problem ``i`` (every anchor valid, as
    ``__graft_entry__._example_batch`` builds them) from the float64
    host oracle's compatibility test (``ops.chaining.check_compatibility``)
    and its forward DP order (``max_pairwise_paths``)."""
    from muchsalsa_tpu.ops.chaining import EdgeContext, check_compatibility

    f = {k: np.asarray(v[i], dtype=np.float64) for k, v in batch_np.items()
         if k not in ("cls_dir", "valid", "v_dir", "w_dir")}
    K = len(f["score"])
    ctx = EdgeContext(
        v=0, w=1, illu_ids=np.arange(K), ov_start=f["ov_s"], ov_end=f["ov_e"],
        em_dir=np.full(K, bool(batch_np["cls_dir"][i])), em_score=f["score"],
        em_primary=np.zeros(K, bool),
        v_ns=f["v_ns"], v_ne=f["v_ne"], v_is=f["v_is"], v_ie=f["v_ie"],
        v_rr=f["v_rr"], v_dir=batch_np["v_dir"][i],
        w_ns=f["w_ns"], w_ne=f["w_ne"], w_is=f["w_is"], w_ie=f["w_ie"],
        w_rr=f["w_rr"], w_dir=batch_np["w_dir"][i])
    scores = list(f["score"])
    bps = [-1] * K
    for k in range(K - 1):
        for l in range(k + 1, K):
            s = scores[k] + f["score"][l]
            if s > scores[l] and check_compatibility(ctx, k, l, wiggle_room):
                scores[l], bps[l] = s, k
    return np.asarray(scores), np.asarray(bps)


def _median_time(fn, batch, reps: int = 5) -> float:
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(batch, WIGGLE))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_kernel_check(batch_size: int = KERNEL_BATCH,
                       oracle_sample: int = ORACLE_SAMPLE) -> None:
    import jax

    from __graft_entry__ import _example_batch
    from muchsalsa_tpu.ops.chaining_jax import chain_dp_batch

    log(f"[kernel] chain_dp_batch on {device_summary()['kind']}; card: "
        f"{card_name_and_power_limit()}")
    dtype = np.float64 if jax.config.read("jax_enable_x64") else np.float32
    for K in DEFAULT_CONFIG.device.chain_buckets:
        batch = _example_batch(batch_size, K, dtype, seed=K)
        t0 = time.perf_counter()
        scores, bps = jax.block_until_ready(chain_dp_batch(batch, WIGGLE))
        first = time.perf_counter() - t0
        scores, bps = np.asarray(scores), np.asarray(bps)
        batch_np = {k: np.asarray(v) for k, v in batch.items()}
        for i in np.linspace(0, batch_size - 1, oracle_sample).astype(int):
            o_scores, o_bps = oracle_dp(batch_np, int(i), WIGGLE)
            require(np.array_equal(scores[i], o_scores.astype(dtype))
                    and np.array_equal(bps[i], o_bps),
                    f"K={K}: problem {i} differs from the host oracle")
        warm = _median_time(chain_dp_batch, batch)
        log(f"[kernel] K={K} B={batch_size}: bit-equal to the host oracle "
            f"({oracle_sample} problems); warm median {warm * 1e3} ms, "
            f"first call {first} s; linked share {float((bps >= 0).mean())}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[kernel] peak device bytes in use: {stats.get('peak_bytes_in_use')}")


# -- phase 7 ----------------------------------------------------------------

def phase_four_cards(paths: dict, work: Path) -> None:
    from muchsalsa_tpu.config import MapperConfig
    from muchsalsa_tpu.io.fasta import SequenceStore
    from muchsalsa_tpu.pipeline.mapper import (
        DEVICE_MAP_STATS, MinimizerIndex, map_all, write_paf)

    cfg = MapperConfig()
    unitigs = SequenceStore.from_file(paths["unitigs"])
    reads = SequenceStore.from_file(paths["nanopore"])
    index = MinimizerIndex.build(unitigs, cfg)
    names = dict(unitig_names=lambda u: unitigs.registry.name(u),
                 read_names=lambda r: reads.registry.name(r))
    t0 = time.perf_counter()
    host_lines = map_all(index, reads, cfg, **names)
    host_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_lines = map_all(index, reads, cfg, device=True, **names)
    dev_wall = time.perf_counter() - t0
    require(DEVICE_MAP_STATS.get("meshed")
            and DEVICE_MAP_STATS.get("n_devices") == 4,
            f"mapping did not shard over 4 cards: {DEVICE_MAP_STATS}")
    require(dev_lines == host_lines, "4-card mapping PAF differs from the host")
    log(f"[four cards] mapping: {len(dev_lines)} PAF lines byte-equal to the "
        f"host; wall {dev_wall} s on 4 cards, {host_wall} s host; "
        f"overflow->host {DEVICE_MAP_STATS['overflow_reads']}/"
        f"{DEVICE_MAP_STATS['total_reads']}")

    paf = work / "mapped.paf"
    write_paf(dev_lines + ["__sentinel__\t1\t0\t1\t+\t__sentinel__\t1\t0\t1\t0\t1\t0"],
              paf)
    inputs = (paf, paths["unitigs"], paths["nanopore"])
    dev = run_core(*inputs, work / "core_mesh", forced_core_config())
    host = run_core(*inputs, work / "core_host", host_config())
    counters = dev["timer"].counters
    require(counters.get("mesh_devices") == 4
            and counters.get("chaining_on_device") == 1,
            f"core did not run over a 4-card mesh: {counters}")
    log(f"[four cards] core: wall {dev['wall']} s on the mesh (chaining "
        f"{dev['timer'].stages['chaining']} s), {host['wall']} s host")
    compare_core(work / "core_mesh", work / "core_host", "four cards")


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card mesh phase")
    args = parser.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    enable_compile_cache()
    t_start = time.perf_counter()
    dev = phase_device(n_cards)
    work = WORKDIR / ("four_cards" if args.four_cards else "one_card")
    shutil.rmtree(work, ignore_errors=True)  # `full` resumes from manifests
    phases = []

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        log(f"== phase {name}")
        out = fn(*a, **kw)
        phases.append((name, time.perf_counter() - t0))
        log(f"== phase {name}: passed in {phases[-1][1]} s")
        return out

    paths = phase("workload", make_workload, work / "data", **WORKLOAD)
    if args.four_cards:
        phase("four cards", phase_four_cards, paths, work)
    else:
        phase("main path", phase_main_path, paths, work / "full_device")
        phase("host oracle", phase_host_oracle, paths, work / "full_device",
              work / "full_host")
        phase("forced core", phase_forced_core, work / "full_device", work)
        phase("kernel check", phase_kernel_check)
    log(f"[done] all phases passed in {time.perf_counter() - t_start} s")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
