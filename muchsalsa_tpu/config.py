"""Typed configuration for the whole assembler.

The reference scatters its tunables across compile-time constants; this
module lifts every one of them into a single dataclass (see SURVEY.md §5
"Config / flag system").  Field-by-field provenance:

- ``min_matches`` / ``th_length`` / ``th_matches``:
  reference ``libms/src/BlastFileReader.cpp:48-50``.
- ``th_overlap``: ``libms/src/matching/MatchMap.cpp:41``.
- ``wiggle_room``: ``src/Application.h:132`` (default 300).
- ``base_weight_multiplicator`` / ``max_weight_multiplicator``:
  ``src/main.cpp:96-97``.
- ``th_sequence_length`` / ``sequence_line_length``: ``libms/src/kernel/ap.cpp:52-53``.
- ``cluster_weight_exact_max_order``: ``libms/src/kernel/lg.cpp:362-366``.
- ``path_min_length`` / ``path_min_length_touching``: ``lg.cpp:375,396``.
- ``join_max_distance``: ``lg.cpp:570``.
- ``skip_last_paf_line``: reproduces the reference reader's loop bound
  ``lineIdx < getLineCount() - 1`` (``BlastFileReader.cpp:76``), which
  never parses the final PAF line.  Disable for a fixed-semantics run.
- scrubber/pipeline knobs: ``pipeline/scrubber_bfs.py:19,49,147``,
  ``pipeline/pipeline.sh:29``.
- mapper (minimap2-replacement) knobs mirror the flags the reference
  passes to minimap2 (``pipeline/pipeline.sh:163``: ``-k15 -w5 -m100``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class GraphConfig:
    """Overlap-graph construction + reduction thresholds."""

    min_matches: int = 400
    th_length: int = 500
    th_matches: int = 500
    th_overlap: int = 100
    wiggle_room: int = 300
    base_weight_multiplicator: float = 1.1
    max_weight_multiplicator: float = 0.8
    skip_last_paf_line: bool = True


@dataclass(frozen=True)
class LinearizeConfig:
    """Path-extraction (linearization) tunables."""

    cluster_weight_exact_max_order: int = 150_000
    path_min_length: int = 10
    path_min_length_touching: int = 5
    join_max_distance: int = 3


@dataclass(frozen=True)
class ConsensusConfig:
    """Consensus emission tunables."""

    th_sequence_length: int = 200
    sequence_line_length: int = 60


@dataclass(frozen=True)
class MapperConfig:
    """Minimizer seeding + chaining (minimap2-stage replacement)."""

    k: int = 15
    w: int = 5
    min_chain_score: int = 100
    max_gap: int = 10_000
    bandwidth: int = 2_000
    min_anchor_count: int = 3
    max_occ: int = 64
    # alignment-refined match counts (the reference's `-c --eqx` stage):
    # run the banded-DP kernel over every mapped region
    refine: bool = False
    refine_band: int = 256


@dataclass(frozen=True)
class ScrubConfig:
    """Read scrubbing (pipeline stage ④ replacement)."""

    subset_size: int = 60_000
    min_hit_length: int = 500
    end_trim: int = 200
    ext_merge_distance: int = 500


@dataclass(frozen=True)
class PipelineConfig:
    """Full-pipeline orchestration knobs."""

    min_unitig_length: int = 500
    kmer_k_filter: int = 25
    kmer_iqr_multiplier: float = 2.0
    unitig_iqr_multiplier: float = 1.5


@dataclass(frozen=True)
class DeviceConfig:
    """Execution-placement knobs for the JAX compute path."""

    # Edges whose anchor count is <= this run through the vectorised
    # device DP; bucket sizes are the padded anchor counts compiled.
    chain_buckets: tuple[int, ...] = (8, 16, 32, 64, 128)
    # Minimum number of edges before shipping a bucket to the device
    # (below this the host oracle is faster than dispatch overhead).
    min_device_batch: int = 32
    # Minimum total chaining problems (edge x strand classes) before the
    # whole chaining phase runs on the device: below this the one-time
    # accelerator compile is expected to outweigh the compute win — the
    # same per-size hybrid reasoning as the reference's 150000-order
    # heuristic switch (lg.cpp:362-366).  The value is carried over from
    # the accelerator this code was first tuned on; it is still to be
    # measured on the H100.
    chain_device_min_problems: int = 200_000
    # Minimum match-table rows before the scaffold all-pairs edge
    # construction (phase ②) runs on the device — same per-size hybrid
    # reasoning as chaining (the reference's second-hottest fan-out,
    # MatchMap.cpp:161-224).  Carried over like the chaining gate; still
    # to be measured on the H100.
    edges_device_min_rows: int = 500_000
    # Data-parallel mesh axis name for read streaming.
    data_axis: str = "reads"
    use_device: bool = True


@dataclass(frozen=True)
class Config:
    graph: GraphConfig = field(default_factory=GraphConfig)
    linearize: LinearizeConfig = field(default_factory=LinearizeConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    scrub: ScrubConfig = field(default_factory=ScrubConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)

        def build(cls, data):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in data:
                    continue
                value = data[f.name]
                if dataclasses.is_dataclass(f.type) or f.name in _SECTIONS:
                    value = build(_SECTIONS[f.name], value)
                elif isinstance(value, list):
                    value = tuple(value)
                kwargs[f.name] = value
            return cls(**kwargs)

        return build(Config, raw)

    @staticmethod
    def load(path: str | Path) -> "Config":
        return Config.from_json(Path(path).read_text())

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())


_SECTIONS = {
    "graph": GraphConfig,
    "linearize": LinearizeConfig,
    "consensus": ConsensusConfig,
    "mapper": MapperConfig,
    "scrub": ScrubConfig,
    "pipeline": PipelineConfig,
    "device": DeviceConfig,
}

DEFAULT_CONFIG = Config()
