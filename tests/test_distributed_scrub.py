"""True multi-process streaming scrub: 2 jax.distributed CPU processes
sharing the per-subset overlap work, output identical to single-host
(the multi-process analog of the reference's out-of-core scrubber,
scrubber_bfs.py:163-248)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from muchsalsa_tpu.config import MapperConfig, ScrubConfig
from muchsalsa_tpu.io.fasta import SequenceStore, write_fasta
from muchsalsa_tpu.pipeline.mapper import MinimizerIndex, map_all
from muchsalsa_tpu.pipeline.scrubber import scrub_reads
from muchsalsa_tpu.testing.simulate import random_genome

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_scrub_matches_single(tmp_path):
    rng = np.random.default_rng(77)
    genome = random_genome(rng, 40_000)
    reads = SequenceStore()
    unitigs = SequenceStore()
    for i in range(10):
        s = i * 3600
        reads.add(f"r{i}", genome[s : s + 7000])
    for i in range(9):
        unitigs.add(f"u{i}", genome[i * 3600 + 3000 : i * 3600 + 4200])

    mcfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, mcfg)
    paf = map_all(index, reads, mcfg)

    reads_fa = tmp_path / "reads.fa"
    write_fasta(reads_fa, ((reads.registry.name(rid), seq) for rid, seq in reads.items()))
    paf_path = tmp_path / "mapped.paf"
    paf_path.write_text("\n".join(paf) + "\n")

    reads2 = SequenceStore()
    reads2.load(reads_fa)
    single = scrub_reads(paf, reads2, ScrubConfig(subset_size=3), mcfg)

    coordinator = f"127.0.0.1:{_free_port()}"
    out_fa = tmp_path / "scrubbed.fa"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # no virtual multi-device inside the procs
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "distributed_scrub.py"),
             str(pid), "2", coordinator, str(reads_fa), str(paf_path),
             str(out_fa), "3"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{so}\n{se[-2000:]}"

    got = out_fa.read_bytes()
    expected = tmp_path / "expected.fa"
    write_fasta(expected, single)
    assert got == expected.read_bytes()


def test_device_scrub_matches_host(tmp_path):
    """The scrub's subset all-vs-all through map_all_with_device (meshed
    over the 8 virtual devices) must emit identical scrubbed reads
    (VERDICT r2 item 4a)."""
    rng = np.random.default_rng(78)
    genome = random_genome(rng, 40_000)
    reads = SequenceStore()
    unitigs = SequenceStore()
    for i in range(10):
        s = i * 3600
        reads.add(f"r{i}", genome[s : s + 7000])
    for i in range(9):
        unitigs.add(f"u{i}", genome[i * 3600 + 3000 : i * 3600 + 4200])

    mcfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, mcfg)
    paf = map_all(index, reads, mcfg)

    host = scrub_reads(paf, reads, ScrubConfig(subset_size=3), mcfg)
    dev = scrub_reads(paf, reads, ScrubConfig(subset_size=3), mcfg,
                      device=True)
    assert dev == host


def test_device_all_vs_all_chunked_matches_single():
    """The chunked-index device all-vs-all (subsets past the v2 packing
    bound split the INDEX side into contiguous id chunks) must produce
    the exact per-read hit lists of the single-index run — order
    included, since the scrub's range merge is order-dependent."""
    from muchsalsa_tpu.pipeline.scrubber import _device_all_vs_all

    rng = np.random.default_rng(79)
    genome = random_genome(rng, 40_000)
    store = SequenceStore()
    for i in range(10):
        s = i * 3600
        store.add(f"r{i}", genome[s : s + 7000])

    mcfg = MapperConfig()
    single, _idx = _device_all_vs_all(store, mcfg)
    assert any(maps for _rid, maps in single), "fixture must overlap"
    # entry budget ~ one read's minimizers -> one chunk per read
    chunked, _idx2 = _device_all_vs_all(store, mcfg, entry_budget=3_000,
                                        max_chunks=99)
    assert chunked == single

    # and the full scrub output through forced chunking is unchanged
    unitigs = SequenceStore()
    for i in range(9):
        unitigs.add(f"u{i}", genome[i * 3600 + 3000 : i * 3600 + 4200])
    paf = map_all(MinimizerIndex.build(unitigs, mcfg), store, mcfg)
    host = scrub_reads(paf, store, ScrubConfig(subset_size=3), mcfg)

    import muchsalsa_tpu.pipeline.scrubber as scr

    orig = scr._device_all_vs_all
    try:
        scr._device_all_vs_all = (
            lambda s, m, entry_budget=3_000: orig(s, m, entry_budget,
                                                  max_chunks=99))
        dev = scrub_reads(paf, store, ScrubConfig(subset_size=3), mcfg,
                          device=True)
    finally:
        scr._device_all_vs_all = orig
    assert dev == host
