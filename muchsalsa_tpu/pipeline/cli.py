"""Command-line interface.

Two entry points mirroring the reference's two layers:

- ``core``: the muchsalsa binary's positional CLI
  (``src/Application.cpp:32-39``: ``<contigs.paf> <unitigs.fa>
  <nanopore.fa> <outdir> [threads] [wiggleRoom]`` — threads is accepted
  and ignored; parallelism is the device mesh);
- ``full``: the pipeline.sh driver (``pipeline/pipeline.sh:38-57``)
  with every external tool replaced by native stages;
- ``map``: standalone access to the native mapper (minimap2-stage
  replacement), useful for bit-compat cross-checking.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from muchsalsa_tpu.config import Config, DEFAULT_CONFIG


def _load_config(path: str | None) -> Config:
    if path:
        return Config.load(path)
    return DEFAULT_CONFIG


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="muchsalsa-tpu")
    parser.add_argument("--config", help="JSON config file", default=None)
    sub = parser.add_subparsers(dest="command", required=True)

    core = sub.add_parser("core", help="core assembly (reference muchsalsa CLI)")
    core.add_argument("paf")
    core.add_argument("unitigs")
    core.add_argument("nanopore")
    core.add_argument("outdir")
    core.add_argument(
        "threads", nargs="?", default=None,
        help="host worker processes for the assembly fan-out "
        "(device parallelism is the mesh); default: all cores",
    )
    core.add_argument("wiggle_room", nargs="?", type=int, default=None)

    full = sub.add_parser("full", help="full pipeline from raw reads")
    full.add_argument("--illumina1", required=True)
    full.add_argument("--illumina2", default=None)
    full.add_argument("--nanopore", required=True)
    full.add_argument("--out", required=True)
    full.add_argument("--kmer-filter-k", type=int, default=None)
    full.add_argument("--unitig-k", type=int, default=31)
    full.add_argument("--device-map", action=argparse.BooleanOptionalAction,
                      default=None,
                      help="run the mapping stages on the accelerator "
                      "(identical output; host fallback per overflow read; "
                      "default: auto — on when an accelerator is attached)")
    full.add_argument("--device-kmer", action=argparse.BooleanOptionalAction,
                      default=None,
                      help="count k-mers on the accelerator (identical "
                      "output; default: auto)")
    full.add_argument("--device-scrub", action=argparse.BooleanOptionalAction,
                      default=None,
                      help="run the scrub's subset all-vs-all overlap "
                      "on the accelerator (identical output; default: auto)")
    full.add_argument("--device-dbg", action=argparse.BooleanOptionalAction,
                      default=None,
                      help="batch the DBG walk's extension queries on "
                      "the accelerator (identical unitigs; default: auto)")

    mp = sub.add_parser("map", help="native minimizer mapper (PAF out)")
    mp.add_argument("query_fa", help="unitigs/anchors (PAF query)")
    mp.add_argument("target_fa", help="long reads (PAF target)")
    mp.add_argument("out_paf")
    mp.add_argument("--device", action="store_true",
                    help="map on the accelerator (host fallback per "
                    "overflowing read; identical output)")

    cfg_dump = sub.add_parser("config", help="print the default config JSON")

    args = parser.parse_args(argv)
    config = _load_config(args.config)

    if args.command == "config":
        print(config.to_json())
        return 0

    # initialises the backend: one that fails raises here rather than
    # falling back to the CPU (CPU runs say JAX_PLATFORMS=cpu)
    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.command == "core":
        # integrity check (reference Application::checkIntegrity,
        # Application.cpp:53-63)
        from pathlib import Path

        for p in (args.paf, args.unitigs, args.nanopore):
            if not Path(p).is_file():
                print("Paths are pointing to invalid/unusable locations", file=sys.stderr)
                print(f"  missing: {p}", file=sys.stderr)
                return 1

        if args.wiggle_room is not None:
            graph = dataclasses.replace(config.graph, wiggle_room=args.wiggle_room)
            config = dataclasses.replace(config, graph=graph)
        from muchsalsa_tpu.assemble.driver import assemble

        workers = int(args.threads) if args.threads is not None else None
        result = assemble(
            args.paf, args.unitigs, args.nanopore, args.outdir, config,
            workers=workers,
        )
        print("Finished assembly")
        print(f"components={result['components']} paths={result['paths']}")
        return 0

    if args.command == "full":
        from pathlib import Path

        inputs = [args.illumina1, args.nanopore]
        if args.illumina2 is not None:
            inputs.append(args.illumina2)
        for p in inputs:
            if not Path(p).is_file():
                print("Paths are pointing to invalid/unusable locations", file=sys.stderr)
                print(f"  missing: {p}", file=sys.stderr)
                return 1
        from muchsalsa_tpu.pipeline.full import run_full_pipeline

        final = run_full_pipeline(
            args.illumina1,
            args.illumina2,
            args.nanopore,
            args.out,
            config,
            kmer_filter_k=args.kmer_filter_k,
            unitig_k=args.unitig_k,
            device_map=getattr(args, "device_map", None),
            device_kmer=getattr(args, "device_kmer", None),
            device_scrub=getattr(args, "device_scrub", None),
            device_dbg=getattr(args, "device_dbg", None),
        )
        print(f"Assembly written to {final}")
        return 0

    if args.command == "map":
        from pathlib import Path

        for p in (args.query_fa, args.target_fa):
            if not Path(p).is_file():
                print("Paths are pointing to invalid/unusable locations", file=sys.stderr)
                print(f"  missing: {p}", file=sys.stderr)
                return 1
        from muchsalsa_tpu.io.fasta import SequenceStore
        from muchsalsa_tpu.pipeline.mapper import MinimizerIndex, map_all, write_paf

        unitigs = SequenceStore.from_file(args.query_fa)
        reads = SequenceStore.from_file(args.target_fa)
        index = MinimizerIndex.build(unitigs, config.mapper)
        lines = map_all(
            index, reads, config.mapper,
            unitig_names=lambda u: unitigs.registry.name(u),
            read_names=lambda r: reads.registry.name(r),
            device=bool(getattr(args, "device", False)),
        )
        write_paf(lines, args.out_paf)
        print(f"{len(lines)} mappings written to {args.out_paf}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
