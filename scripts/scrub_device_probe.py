"""Measure the scrub's all-vs-all on the DEVICE at scale.

The per-subset all-vs-all overlap step is the scrub's wall and the
natural `--device-scrub` target: the subset
IS a mapping problem, and ``_subset_overlap_records(device=True)``
routes it through ``map_all_with_device``.  This probe loads a
pipeline outdir's scrub inputs (01_contigs_corrected.paf + nanopore
reads), runs the scrub twice — host native batch vs device — asserts
identical scrubbed records, and reports both walls plus the device
pass's overflow stats and the multiplicity guard's declines.

Usage: python scripts/scrub_device_probe.py <outdir> <nanopore.fa> \
    [subset_size=60000]
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path


def main() -> None:
    outdir = Path(sys.argv[1])
    nanopore = Path(sys.argv[2])
    subset_size = int(sys.argv[3]) if len(sys.argv) > 3 else 60_000

    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    print(f"[scrub_probe] backend: {jax.devices()}", flush=True)

    from muchsalsa_tpu.config import MapperConfig, ScrubConfig
    from muchsalsa_tpu.io.fasta import SequenceStore
    from muchsalsa_tpu.pipeline.mapper import (
        DEVICE_MAP_STATS_CUM)
    from muchsalsa_tpu.pipeline.scrubber import DEVICE_SCRUB_STATS, scrub_reads

    paf2 = outdir / "01_contigs_corrected.paf"
    lines = [l for l in paf2.read_text().splitlines()
             if l and "__sentinel__" not in l]
    reads = SequenceStore.from_file(nanopore)
    n_reads = sum(1 for _ in reads.ids())
    scfg = dataclasses.replace(ScrubConfig(), subset_size=subset_size)
    mcfg = MapperConfig()
    print(f"[scrub_probe] {n_reads} reads, {len(lines)} anchor PAF lines, "
          f"subset_size={subset_size}", flush=True)

    t0 = time.perf_counter()
    host_out = scrub_reads(lines, reads, scfg, mcfg, device=False)
    host_s = time.perf_counter() - t0
    print(f"[scrub_probe] host scrub: {host_s:.1f}s "
          f"({len(host_out)} records)", flush=True)

    DEVICE_MAP_STATS_CUM.clear()
    t0 = time.perf_counter()
    dev_out = scrub_reads(lines, reads, scfg, mcfg, device=True)
    dev_s = time.perf_counter() - t0
    print(f"[scrub_probe] device scrub (first pass, incl. any "
          f"once-ever compiles): {dev_s:.1f}s ({len(dev_out)} records) "
          f"stats={DEVICE_MAP_STATS_CUM} scrub={DEVICE_SCRUB_STATS}",
          flush=True)

    assert dev_out == host_out, "device scrub diverged from host"
    print("[scrub_probe] PARITY: PASS (device records == host records)",
          flush=True)

    # warm pass: executables and device read batches resident
    t0 = time.perf_counter()
    dev_out2 = scrub_reads(lines, reads, scfg, mcfg, device=True)
    warm_s = time.perf_counter() - t0
    assert dev_out2 == host_out
    print(f"[scrub_probe] device scrub (warm): {warm_s:.1f}s "
          f"({host_s/warm_s:.2f}x host)", flush=True)


if __name__ == "__main__":
    main()
