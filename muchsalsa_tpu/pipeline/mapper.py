"""Minimizer-index mapper: the native replacement for the pipeline's
minimap2 anchoring stages.

Reference counterpart: the three ``minimap2 -k15 -DP --dual=yes
--no-long-join -w5 -m100 -g10000 -r2000`` invocations in
``pipeline/pipeline.sh:163,169,175`` that map unitigs (query, PAF col 0)
onto nanopore reads (target, cols 5-8).  Output is a PAF with exactly
the columns the core parser consumes (``BlastFileReader.cpp:52-60``).

Method:
1. index: minimizers of every unitig -> sorted (hash, unitig, pos,
   strand) table with CSR buckets; hashes occurring more than
   ``max_occ`` times are dropped (repeat masking, minimap2's -f
   analog);
2. per read: minimizer lookup -> anchors (unitig, strand, qpos, tpos);
3. chaining: per (unitig, relative strand), anchors are grouped by
   diagonal (tpos - qpos, or tpos + qpos for reverse hits) within
   ``bandwidth``; each group is one candidate chain;
4. scoring: ``matches`` = bases of the read covered by the union of
   anchor k-mer intervals (merged, so overlapping seeds don't double
   count);
5. chains with ``matches >= min_chain_score`` and ``min_anchor_count``
   anchors emit PAF rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.ops.minimizer import minimizers
from muchsalsa_tpu.utils.seq import encode_2bit


@dataclass
class MinimizerIndex:
    hashes: np.ndarray      # sorted uint32
    offsets: np.ndarray     # CSR into entries, len = len(uniq)+1
    entry_unitig: np.ndarray  # int32
    entry_pos: np.ndarray     # int32
    entry_strand: np.ndarray  # bool
    unitig_ids: list[int]
    unitig_lengths: dict[int, int]
    k: int
    w: int

    @staticmethod
    def build(
        store: SequenceStore,
        cfg: MapperConfig,
        sketches: dict | None = None,
    ) -> "MinimizerIndex":
        """``sketches`` (optional): precomputed ``{id: (pos, h, strand)}``
        minimizer sketches to reuse (the scrubber's all-vs-all computes
        each read's sketch once for both index and lookup)."""
        all_h, all_u, all_p, all_s = [], [], [], []
        lengths = {}

        if sketches is None and cfg.k <= 15:
            from muchsalsa_tpu import native

            if native.available():
                ids, seqs = [], []
                for uid, seq in store.items():
                    lengths[uid] = len(seq)
                    ids.append(uid)
                    seqs.append(seq)
                built = native.build_index_native(
                    seqs, np.asarray(ids, dtype=np.int32),
                    cfg.k, cfg.w, cfg.max_occ,
                )
                if built is not None:
                    uniq, offsets, u, p, s = built
                    return MinimizerIndex(
                        hashes=uniq,
                        offsets=offsets,
                        entry_unitig=u,
                        entry_pos=p,
                        entry_strand=s,
                        unitig_ids=store.ids(),
                        unitig_lengths=lengths,
                        k=cfg.k,
                        w=cfg.w,
                    )

        for uid, seq in store.items():
            lengths[uid] = len(seq)
            if sketches is not None and uid in sketches:
                pos, h, strand = sketches[uid]
            else:
                pos, h, strand = minimizers(seq, cfg.k, cfg.w)
            all_h.append(h)
            all_p.append(pos.astype(np.int32))
            all_s.append(strand)
            all_u.append(np.full(len(pos), uid, dtype=np.int32))

        if all_h:
            h = np.concatenate(all_h)
            u = np.concatenate(all_u)
            p = np.concatenate(all_p)
            s = np.concatenate(all_s)
        else:
            h = np.zeros(0, dtype=np.uint32)
            u = p = np.zeros(0, dtype=np.int32)
            s = np.zeros(0, dtype=bool)

        order = np.argsort(h, kind="stable")
        h, u, p, s = h[order], u[order], p[order], s[order]
        uniq, starts = np.unique(h, return_index=True)
        offsets = np.concatenate([starts, [len(h)]]).astype(np.int64)

        # repeat-mask: drop buckets with more than max_occ entries
        counts = np.diff(offsets)
        keep = counts <= cfg.max_occ
        if not np.all(keep):
            keep_rows = np.repeat(keep, counts)
            h, u, p, s = h[keep_rows], u[keep_rows], p[keep_rows], s[keep_rows]
            uniq, starts = np.unique(h, return_index=True)
            offsets = np.concatenate([starts, [len(h)]]).astype(np.int64)

        return MinimizerIndex(
            hashes=uniq,
            offsets=offsets,
            entry_unitig=u,
            entry_pos=p,
            entry_strand=s,
            unitig_ids=store.ids(),
            unitig_lengths=lengths,
            k=cfg.k,
            w=cfg.w,
        )


@dataclass
class Mapping:
    unitig: int
    strand: bool       # True = '+'
    q_start: int       # unitig coords, end exclusive
    q_end: int
    t_start: int       # read coords
    t_end: int
    matches: int
    n_anchors: int


def _covered(starts: np.ndarray, k: int) -> int:
    """Total bases covered by the union of [s, s+k) intervals."""
    if len(starts) == 0:
        return 0
    s = np.sort(starts)
    gaps = np.diff(s)
    return int(k + np.sum(np.minimum(gaps, k)))


def map_read(
    index: MinimizerIndex,
    read_seq: bytes,
    cfg: MapperConfig,
    sketch: tuple | None = None,
    use_native: bool = True,
) -> list[Mapping]:
    if use_native and sketch is None and index.k <= 15:
        from muchsalsa_tpu import native

        if native.available():
            out = native.map_read_native(
                encode_2bit(read_seq), index.k, index.w,
                index.hashes, index.offsets, index.entry_unitig,
                index.entry_pos, index.entry_strand,
                cfg.bandwidth, cfg.min_anchor_count, cfg.min_chain_score,
            )
            if out is not None:
                return [
                    Mapping(
                        unitig=int(out["unitig"][i]),
                        strand=bool(out["strand"][i]),
                        q_start=int(out["qs"][i]),
                        q_end=int(out["qe"][i]),
                        t_start=int(out["ts"][i]),
                        t_end=int(out["te"][i]),
                        matches=int(out["matches"][i]),
                        n_anchors=int(out["n_anchors"][i]),
                    )
                    for i in range(len(out["unitig"]))
                ]

    if sketch is not None:
        pos, h, strand = sketch
    else:
        codes = encode_2bit(read_seq)
        pos, h, strand = minimizers(codes, index.k, index.w)
    if len(pos) == 0:
        return []

    # bucket lookup (vectorised CSR expansion — no per-hit Python)
    loc = np.searchsorted(index.hashes, h)
    loc = np.minimum(loc, max(len(index.hashes) - 1, 0))
    hit = len(index.hashes) > 0
    found = index.hashes[loc] == h if hit else np.zeros(len(h), dtype=bool)

    hit_idx = np.nonzero(found)[0]
    if len(hit_idx) == 0:
        return []
    lo = index.offsets[loc[hit_idx]]
    counts = index.offsets[loc[hit_idx] + 1] - lo
    total = int(counts.sum())
    if total == 0:
        return []
    base = np.repeat(lo, counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    src = base + within

    au = index.entry_unitig[src]
    aq = index.entry_pos[src].astype(np.int64)
    at = np.repeat(pos[hit_idx], counts)
    arel = index.entry_strand[src] == np.repeat(strand[hit_idx], counts)

    k = index.k

    # fully vectorised chaining: one global sort by ((unitig, strand),
    # diagonal), band segmentation by diagonal gaps, and per-segment
    # stats via ufunc.reduceat — no per-group Python
    key = au.astype(np.int64) * 2 + arel
    diag = np.where(arel, at - aq, at + aq)
    order = np.lexsort((diag, key))
    key_s = key[order]
    diag_s = diag[order]
    q_s = aq[order]
    t_s = at[order]

    n_a = len(order)
    new_seg = np.ones(n_a, dtype=bool)
    new_seg[1:] = (key_s[1:] != key_s[:-1]) | (np.diff(diag_s) > cfg.bandwidth)
    starts = np.nonzero(new_seg)[0]
    seg_counts = np.diff(np.concatenate([starts, [n_a]]))

    q_min = np.minimum.reduceat(q_s, starts)
    q_max = np.maximum.reduceat(q_s, starts)
    t_min = np.minimum.reduceat(t_s, starts)
    t_max = np.maximum.reduceat(t_s, starts)

    # covered read bases per segment: sort anchors by (segment, t),
    # clip consecutive gaps at k, zero gaps crossing segment bounds
    seg_ids = np.cumsum(new_seg) - 1
    order2 = np.lexsort((t_s, seg_ids))
    t2 = t_s[order2]
    gaps = np.minimum(np.diff(t2), k) if n_a > 1 else np.zeros(0, dtype=np.int64)
    gaps = np.concatenate([[0], gaps])
    gaps[starts] = 0  # first element of each segment contributes k below
    covered = k + np.add.reduceat(gaps, starts) - gaps[starts]

    ok = (seg_counts >= cfg.min_anchor_count) & (covered >= cfg.min_chain_score)

    results: list[Mapping] = []
    for i in np.nonzero(ok)[0]:
        s0 = starts[i]
        results.append(
            Mapping(
                unitig=int(key_s[s0] // 2),
                strand=bool(key_s[s0] % 2),
                q_start=int(q_min[i]),
                q_end=int(q_max[i]) + k,
                t_start=int(t_min[i]),
                t_end=int(t_max[i]) + k,
                matches=int(covered[i]),
                n_anchors=int(seg_counts[i]),
            )
        )

    return results


def map_batch(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    threads: int = 0,
) -> list[tuple[int, list[Mapping]]] | None:
    """Map every read in one multithreaded native call (the host analog
    of the reference's job-per-read ThreadPool fan-out).  Results are
    identical to per-read :func:`map_read`; returns None when the native
    library is unavailable (callers fall back to the python path)."""
    if index.k > 15:
        return None
    from muchsalsa_tpu import native

    if not native.available():
        return None

    rids, seqs = [], []
    for rid, seq in reads.items():
        rids.append(rid)
        seqs.append(seq)
    out = native.map_batch_native(
        seqs, index.k, index.w,
        index.hashes, index.offsets, index.entry_unitig,
        index.entry_pos, index.entry_strand,
        cfg.bandwidth, cfg.min_anchor_count, cfg.min_chain_score,
        threads=threads,
    )
    if out is None:
        return None

    per_read: list[tuple[int, list[Mapping]]] = [(rid, []) for rid in rids]
    read_col = out["read"]
    for i in range(len(read_col)):
        per_read[int(read_col[i])][1].append(
            Mapping(
                unitig=int(out["unitig"][i]),
                strand=bool(out["strand"][i]),
                q_start=int(out["qs"][i]),
                q_end=int(out["qe"][i]),
                t_start=int(out["ts"][i]),
                t_end=int(out["te"][i]),
                matches=int(out["matches"][i]),
                n_anchors=int(out["n_anchors"][i]),
            )
        )
    return per_read


_POOL_STATE: dict = {}

# observability for the device-mapping placement decision: updated on
# every map_all_with_device call so pipeline stage counters (and tests)
# can assert the mesh actually engaged (SURVEY.md §5 metrics row)
DEVICE_MAP_STATS: dict = {}
# cumulative across map_all_with_device calls (reset by callers that
# want a fresh measurement window, e.g. scripts/scrub_device_probe.py)
DEVICE_MAP_STATS_CUM: dict = {}


def _pool_map_one(args):
    rid, seq = args
    return rid, map_read(_POOL_STATE["index"], seq, _POOL_STATE["cfg"])


def map_all(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    unitig_names=None,
    read_names=None,
    unitigs: SequenceStore | None = None,
    processes: int | None = None,
    device: bool = False,
) -> list[str]:
    """Map every read; emit PAF lines (query = unitig, target = read).

    With ``cfg.refine`` (and ``unitigs`` provided), match counts are
    alignment-refined via the banded-DP kernel.  ``processes`` > 1
    fans reads out over a fork-shared worker pool (the index is shared
    copy-on-write — the host analog of the reference's thread pool).
    ``device=True`` maps on the accelerator (ops/mapping_jax.py) with
    host fallback for reads exceeding the static anchor budgets —
    output is identical either way.
    """
    lines: list[str] = []
    uname = unitig_names or (lambda uid: f"u{uid}")
    rname = read_names or (lambda rid: f"r{rid}")

    if processes is None:
        processes = 1
    if device:
        per_read = map_all_with_device(index, reads, cfg)
    else:
        per_read = map_batch(index, reads, cfg, threads=0 if processes <= 1 else processes)
    if per_read is None and processes > 1:
        import multiprocessing as mp

        _POOL_STATE["index"] = index
        _POOL_STATE["cfg"] = cfg
        ctx = mp.get_context("fork")
        with ctx.Pool(processes) as pool:
            per_read = pool.map(_pool_map_one, list(reads.items()), chunksize=64)
        _POOL_STATE.clear()
    elif per_read is None:
        per_read = [(rid, map_read(index, seq, cfg)) for rid, seq in reads.items()]
    if cfg.refine and unitigs is not None:
        refine_mappings(per_read, reads, unitigs, band=cfg.refine_band)

    for rid, maps in per_read:
        tlen = reads.length(rid)
        for m in maps:
            qlen = index.unitig_lengths[m.unitig]
            block = max(m.q_end - m.q_start, m.t_end - m.t_start)
            lines.append(
                f"{uname(m.unitig)}\t{qlen}\t{m.q_start}\t{m.q_end}\t"
                f"{'+' if m.strand else '-'}\t{rname(rid)}\t{tlen}\t"
                f"{m.t_start}\t{m.t_end}\t{m.matches}\t{block}\t60"
            )
    return lines


def device_bucket_len(n: int) -> int:
    """Quarter-step read-length buckets (pow2 x {1.25, 1.5, 1.75, 2}):
    a 9 kb read lands in a 10240 bucket instead of 16384, and every
    device stage width downstream scales with L (reads fill >= 80% of
    their bucket).  All steps are multiples of 256 (packing + lane
    alignment).  Module-level so probes/benches share production's
    shapes (scripts/map_exec_probe.py)."""
    L = 1024
    while L < n:
        L *= 2
    if L > 1024:
        for frac in (5, 6, 7):
            cand = (L // 8) * frac
            if cand >= n:
                return cand
    return L


def device_bucket_budgets(
    L: int, k: int, max_pos_cap: int, max_per_hit: int,
) -> tuple[int, int, int | None]:
    """Static device budgets for one read-length bucket: returns
    (max_sel, max_pos, trim).

    Widths are the whole cost model of the device mapping path — the
    rank-probe gather and the packed-row fetches cost a fixed amount per
    element regardless of table size, and the sorts scale with operand
    width — so every budget scales with the bucket:

    - ``max_sel``: minimizer density is 2/(w+1) = ~L/3 at w=5, and
      quarter-step buckets keep reads >= 80% of L, so L/3 plus slack
      covers every read in the bucket (degenerate inputs overflow to
      the exact host path);
    - ``max_pos``: candidates are a subset of selected; capped at
      ``max_pos_cap`` (2048 default keeps the tail's first sort at a
      pow2 8192 slots instead of 16384);
    - ``trim``: = max_pos (real anchors run ~1.2 per candidate, so a
      1x-candidates anchor budget holds a ~1.6x margin on measured
      workloads; denser repeat anchors overflow to the host).
    """
    Lk = max(L - k + 1, 128)
    sel = min(-(-(L // 3 + 128) // 128) * 128, -(-Lk // 128) * 128)
    pos = min(max_pos_cap, sel)
    if max_per_hit <= 2:
        trim = None
    elif max_per_hit <= 4:
        trim = pos
    else:
        # wider expansion tiers (repeat-heavy reads) carry more anchors
        trim = 2 * pos
    return sel, pos, trim


def map_all_with_device(
    index: MinimizerIndex,
    reads: SequenceStore,
    cfg: MapperConfig,
    batch_reads: int = 256,
    max_pos: int = 2048,
    max_per_hit: int = 4,
    max_hits: int = 64,
    hit_budget: int | None = None,
    prebuilt=None,
) -> list[tuple[int, list[Mapping]]]:
    """Map every read on the device (ops/mapping_jax.py), falling back
    to the host path for reads whose anchors exceed the static device
    budgets (``overflow``).  Results are identical to per-read
    :func:`map_read`.  Reads are length-bucketed (pad to the next power
    of two) to bound recompiles.

    ``max_per_hit=4`` bounds the anchor-expansion width, whose compile
    time grows steeply with the cap; reads touching minimizers with
    more than 4 index entries retry through the tier-2 cap or overflow
    to the host path, which preserves exactness at any budget.

    Uses the packed-row v2 join (``map_reads_device_v2``) when the index
    fits its packing bounds (it virtually always does), and shards read
    batches over the device mesh when more than one device is attached
    (the index tables are replicated — SURVEY.md §2.5)."""
    import jax
    import jax.numpy as jnp

    from muchsalsa_tpu.ops.mapping_jax import (
        anchors_to_hits_device_dense, anchors_to_hits_device_packed,
        build_device_tables, build_join_tables,
        compact_candidates_device_v2, expand_anchors_device_v2,
        map_reads_device, pack_codes, probe_candidates_device_v2,
        select_compact_device_v2, sketch_device_packed, unpack_hits)

    items = list(reads.items())
    if not items:
        return []
    built = prebuilt
    if built is None and max_per_hit < 31:  # v2 count-saturation bound
        built = build_device_tables(
            index.hashes, index.offsets, index.entry_unitig, index.entry_pos,
            index.entry_strand)
    devices = jax.devices()
    mesh = None
    if built is not None and len(devices) > 1:
        from jax.sharding import Mesh

        # round the batch up so it shards evenly — never silently drop
        # to one device (the pad rows have len 0 -> no hits, no cost)
        D = len(devices)
        batch_reads = -(-batch_reads // D) * D
        mesh = Mesh(np.array(devices), ("reads",))
    DEVICE_MAP_STATS.update(
        n_devices=len(devices), meshed=mesh is not None,
        batch_reads=batch_reads, v2=built is not None,
        total_reads=len(items), overflow_reads=0, dense_repulls=0,
        tier2_reads=0)
    # per-bucket budgets (max_sel / max_pos / trim): every device stage
    # cost is linear in its static width, so widths scale with the
    # length bucket (device_bucket_budgets); all trims are
    # exactness-preserving (overflow -> host fallback / padded re-pull)
    if hit_budget is None:
        hit_budget = 16 * batch_reads
    # mirror the device-side clamp (anchors_to_hits_device_dense): a
    # budget above R*max_hits can never be filled and would desync the
    # host's flat_len from the device's actual output length
    hit_budget = min(hit_budget, batch_reads * max_hits)
    if built is not None:
        tables, hash_takes = built
    else:
        bitmap, rank, rounds = build_join_tables(index.hashes)
        idx_dev = (
            jnp.asarray(index.hashes),
            jnp.asarray(index.offsets.astype(np.int32)),
            jnp.asarray(index.entry_unitig),
            jnp.asarray(index.entry_pos),
            jnp.asarray(index.entry_strand),
        )

    buckets: dict[int, list[tuple[int, bytes]]] = {}
    for rid, seq in items:
        buckets.setdefault(device_bucket_len(len(seq)), []).append((rid, seq))

    def bucket_kw(L: int) -> dict:
        sel_L, pos_L, trim_L = device_bucket_budgets(
            L, cfg.k, max_pos, max_per_hit)
        return dict(
            k=cfg.k, w=cfg.w, bandwidth=cfg.bandwidth,
            min_anchor_count=cfg.min_anchor_count,
            min_chain_score=cfg.min_chain_score,
            max_sel=sel_L, max_pos=pos_L, max_per_hit=max_per_hit,
            max_hits=max_hits, trim=trim_L,
        )

    # device-resident read batches: the pipeline maps the same read
    # store against several indexes (unitigs, corrected unitigs —
    # pipeline.sh:163,169).  Cache the packed device arrays on the
    # store so reads cross the host->device link once per store.
    # The cache is keyed on the store's mutation counter (a post-pass
    # ``add`` shifts bucket membership) and byte-capped with LRU
    # eviction so large read sets can't exhaust HBM alongside the index
    # tables (ADVICE r3).
    dev_cache = getattr(reads, "_dev_batch_cache", None)
    store_version = getattr(reads, "version", 0)
    if dev_cache is None or getattr(reads, "_dev_batch_version", None) != store_version:
        dev_cache = reads._dev_batch_cache = {}
        reads._dev_batch_version = store_version
    cache_cap = int(os.environ.get("MS_TPU_DEV_CACHE_MB", "2048")) << 20

    def _cache_put(key, arrays):
        nbytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in arrays)
        if nbytes > cache_cap:
            return
        used = sum(sz for _v, sz in dev_cache.values())
        while dev_cache and used + nbytes > cache_cap:
            _k, (_v, sz) = next(iter(dev_cache.items()))
            del dev_cache[_k]
            used -= sz
        dev_cache[key] = (arrays, nbytes)

    def packed_batch(chunk, L, s, cache=True):
        # tier-2 batches never cache: their membership depends on the
        # INDEX (which reads overflowed), so a positional key would
        # alias stale packed reads across map_all_with_device calls on
        # the same store and zip hits onto the wrong read ids
        key = (L, s, batch_reads)
        hit = dev_cache.get(key) if cache else None
        if hit is not None:
            cached, _sz = dev_cache.pop(key)
            dev_cache[key] = (cached, _sz)  # LRU: move to back
            return cached
        R = batch_reads
        from muchsalsa_tpu import native

        built_np = native.pack_reads_2bit(
            [seq for _rid, seq in chunk], L, n_rows=R
        ) if native.available() else None
        if built_np is not None:
            # one-pass ASCII->packed build (no (R, L) uint8 intermediate,
            # which dominated the pass on a host with little DRAM
            # bandwidth)
            packed, nmask, lens = built_np
        else:
            codes = np.full((R, L), 4, dtype=np.uint8)
            lens = np.zeros(R, dtype=np.int32)
            for i, (_rid, seq) in enumerate(chunk):
                c = encode_2bit(seq)
                codes[i, : len(c)] = c
                lens[i] = len(c)
            packed, nmask = pack_codes(codes)
        cached = (jnp.asarray(packed), jnp.asarray(nmask),
                  jnp.asarray(lens))
        if cache:
            _cache_put(key, cached)
        return cached

    def dispatch(chunk, L, s, mph=max_per_hit, pos_cap=max_pos,
                 cache_batch=True):
        if built is not None:
            packed_d, nmask_d, lens_d = packed_batch(chunk, L, s,
                                                      cache=cache_batch)
        else:
            # legacy (unpacked) path: build host arrays per pass
            R = batch_reads
            codes = np.full((R, L), 4, dtype=np.uint8)
            lens = np.zeros(R, dtype=np.int32)
            for i, (_rid, seq) in enumerate(chunk):
                c = encode_2bit(seq)
                codes[i, : len(c)] = c
                lens[i] = len(c)
        if built is not None and mesh is not None:
            from muchsalsa_tpu.parallel.sharded import (
                sharded_map_reads_v2_packed)

            out, _stats = sharded_map_reads_v2_packed(
                packed_d, nmask_d, lens_d, tables, mesh,
                hash_takes=hash_takes, **bucket_kw(L))
            return out
        if built is not None:
            # reads ship 2-bit packed (0.375 bytes/base).  The pipeline
            # runs as SIX jits (sketch | selcompact | probe | compact |
            # expand | tail), which bounds whole-program compile time
            # (docs/DESIGN.md 4b); intermediates never leave the device
            sel_L, pos_L, trim_L = device_bucket_budgets(
                L, cfg.k, pos_cap, mph)
            selected, h, strand = sketch_device_packed(
                packed_d, nmask_d, lens_d, k=cfg.k, w=cfg.w)
            skey, h_s, n_sel = select_compact_device_v2(
                selected, h, strand, max_sel=sel_L)
            rpv, cand = probe_candidates_device_v2(skey, h_s, tables.rp)
            sel = compact_candidates_device_v2(
                skey, h_s, rpv, cand, n_sel, max_pos=pos_L)
            anchors = expand_anchors_device_v2(
                *sel, tables.jrows, tables.erows,
                max_per_hit=mph, hash_takes=hash_takes)
            flat = anchors_to_hits_device_dense(
                *anchors, k=cfg.k, bandwidth=cfg.bandwidth,
                min_anchor_count=cfg.min_anchor_count,
                min_chain_score=cfg.min_chain_score,
                max_hits=max_hits, trim=trim_L, budget=hit_budget)
            # anchors ride along so a budget-exceeding batch (rare) can
            # re-pull through the padded tail without recomputing
            return ("dense", flat, anchors, trim_L, mph)
        lkw = {k2: v2 for k2, v2 in bucket_kw(L).items() if k2 != "max_sel"}
        return map_reads_device(
            jnp.asarray(codes), jnp.asarray(lens), *idx_dev, bitmap, rank,
            join_rounds=rounds, **lkw)

    def collect_dense(chunk, flat_np, anchors, trim, mph):
        R = batch_reads
        n_hits = flat_np[:R]
        width_ovf = flat_np[R : 2 * R] != 0
        max_ecnt = flat_np[2 * R : 3 * R]
        counts = np.minimum(n_hits, max_hits)
        if int(counts.sum()) <= hit_budget:
            dense_np = flat_np[3 * R :].reshape(hit_budget, 9)
            offs = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
            for i, (rid, seq) in enumerate(chunk):
                if width_ovf[i] or max_ecnt[i] > mph:
                    # tier 2 widens the expansion cap AND the
                    # candidate/anchor widths (2x), so cap violations
                    # and trim-width overflow both retry on-device;
                    # reads hot past tier 2's own cap — or in buckets
                    # where tier 2's widths can't actually grow
                    # (sel-bound small buckets) with no cap violation
                    # to fix — go straight to the host
                    Lb = device_bucket_len(len(seq))
                    t2_budgets = device_bucket_budgets(
                        Lb, cfg.k, 2 * max_pos, tier2_mph)
                    t1_budgets = device_bucket_budgets(
                        Lb, cfg.k, max_pos, mph)
                    tier2_helps = (
                        max_ecnt[i] > mph or t2_budgets != t1_budgets)
                    if (mph < tier2_mph and max_ecnt[i] <= tier2_mph
                            and tier2_helps):
                        deferred.setdefault(Lb, []).append((rid, seq))
                        DEVICE_MAP_STATS["tier2_reads"] += 1
                    else:
                        DEVICE_MAP_STATS["overflow_reads"] += 1
                        results[rid] = map_read(index, seq, cfg)
                    continue
                rows = dense_np[offs[i] : offs[i + 1]]
                results[rid] = [
                    Mapping(
                        unitig=int(r[1]), strand=bool(r[2]),
                        q_start=int(r[3]), q_end=int(r[4]),
                        t_start=int(r[5]), t_end=int(r[6]),
                        matches=int(r[7]), n_anchors=int(r[8]),
                    )
                    for r in rows
                ]
            return
        # batch exceeded the dense budget: re-pull the padded tail
        # (cap violations fold into its overflow -> host fallback)
        DEVICE_MAP_STATS["dense_repulls"] += 1
        out = anchors_to_hits_device_packed(
            *anchors, k=cfg.k, bandwidth=cfg.bandwidth,
            min_anchor_count=cfg.min_anchor_count,
            min_chain_score=cfg.min_chain_score,
            max_hits=max_hits, trim=trim, per_hit_cap=mph)
        collect(chunk, out)

    def collect(chunk, out):
        if not isinstance(out, dict):  # packed (R, 8*max_hits+2) array
            out = unpack_hits(out, max_hits)
        out = {k2: np.asarray(v2) for k2, v2 in out.items()}
        for i, (rid, seq) in enumerate(chunk):
            if out["overflow"][i]:
                # host fallback preserves exactness past the static
                # anchor budgets; the count is surfaced in report.txt
                # so a silently host-bound "device run" is visible
                # (VERDICT r3 weakness 4)
                DEVICE_MAP_STATS["overflow_reads"] += 1
                results[rid] = map_read(index, seq, cfg)
                continue
            n = int(out["n_hits"][i])
            results[rid] = [
                Mapping(
                    unitig=int(out["unitig"][i, j]),
                    strand=bool(out["strand"][i, j]),
                    q_start=int(out["qs"][i, j]),
                    q_end=int(out["qe"][i, j]),
                    t_start=int(out["ts"][i, j]),
                    t_end=int(out["te"][i, j]),
                    matches=int(out["matches"][i, j]),
                    n_anchors=int(out["n_anchors"][i, j]),
                )
                for j in range(n)
            ]

    results: dict[int, list[Mapping]] = {}
    # second-tier expansion cap (0 disables): reads whose ONLY budget
    # violation is a minimizer with max_per_hit < entries <= tier2_mph
    # re-dispatch through a wider-expansion executable instead of
    # falling back to the host — on repeat-rich genomes the ANY-hot-
    # minimizer amplification made overflow ~100% at cap 4 while <0.5%
    # of minimizers are actually hot
    tier2_mph = int(os.environ.get("MS_TPU_MAP_TIER2", "16"))
    tier2_mph = min(tier2_mph, 30)  # v2 count-saturation bound (< 31)
    if tier2_mph <= max_per_hit:
        tier2_mph = 0
    deferred: dict[int, list[tuple[int, bytes]]] = {}
    # windowed pull loop: dense-path batches accumulate W at a time and
    # come back in ONE device-side concat + d2h (one transfer latency
    # per window instead of per batch); non-dense paths keep double
    # buffering
    window: list = []
    W = max(1, int(os.environ.get("MS_TPU_PULL_WINDOW", "8")))
    flat_len = 3 * batch_reads + 9 * hit_budget

    def drain_window():
        if not window:
            return
        import jax.numpy as _jnp

        if len(window) == 1:
            arr = np.asarray(window[0][1])
        else:
            arr = np.asarray(_jnp.concatenate([w[1] for w in window]))
        for j, (chunk, _flat, anchors, trim, mph) in enumerate(window):
            collect_dense(chunk, arr[j * flat_len : (j + 1) * flat_len],
                          anchors, trim, mph)
        window.clear()

    pending: tuple | None = None
    for L, members in sorted(buckets.items()):
        for s in range(0, len(members), batch_reads):
            chunk = members[s : s + batch_reads]
            out = dispatch(chunk, L, s)
            if isinstance(out, tuple) and out and out[0] == "dense":
                window.append((chunk, *out[1:]))
                if len(window) >= W:
                    drain_window()
                continue
            if pending is not None:
                collect(*pending)
            pending = (chunk, out)
    drain_window()
    if pending is not None:
        collect(*pending)

    # tier-2 pass over the deferred reads: wider expansion cap AND
    # wider candidate/anchor widths (2x max_pos, 2x-of-that trim) — the
    # tier-1 widths are tuned for speed on the common case, and both
    # the cap and the width budgets are index-coverage-sensitive (a
    # low-coverage index can put every read's candidate count past the
    # tier-1 cap).  Tier 2's own violations
    # fall back to the host in collect_dense (mph == tier2_mph there).
    if deferred:
        # deferral only happens in collect_dense, which only runs on
        # the single-device dense path (built is not None, mesh None) —
        # the tier executables are always available here
        t2_buckets, deferred = deferred, {}
        for L, members in sorted(t2_buckets.items()):
            for j, s in enumerate(range(0, len(members), batch_reads)):
                chunk = members[s : s + batch_reads]
                out = dispatch(chunk, L, ("t2", L, j), mph=tier2_mph,
                               pos_cap=2 * max_pos, cache_batch=False)
                window.append((chunk, *out[1:]))
                if len(window) >= W:
                    drain_window()
        drain_window()

    # cumulative counters survive across calls (a scrub's chunked
    # all-vs-all makes many calls; per-call stats describe only the
    # last one)
    for k2 in ("total_reads", "overflow_reads", "tier2_reads",
               "dense_repulls"):
        DEVICE_MAP_STATS_CUM[k2] = (
            DEVICE_MAP_STATS_CUM.get(k2, 0) + DEVICE_MAP_STATS[k2])

    return [(rid, results[rid]) for rid, _ in items]


def write_paf(lines: list[str], path: str | Path) -> None:
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


def refine_mappings(
    mappings_per_read: list[tuple[int, list[Mapping]]],
    reads: SequenceStore,
    unitigs: SequenceStore,
    band: int = 256,
    engine: str = "myers",
) -> None:
    """Alignment-refined match counts (the reference's ``minimap2 -c
    --eqx`` stage, pipeline.sh:175): batch edit-distance of every mapped
    region on the device and replace each mapping's heuristic
    ``matches`` with ``max(span) - edits`` (a true alignment-based count).

    ``engine``: "myers" (default — exact bit-parallel, no band guard) or
    "wavefront" (banded; mappings whose length difference exceeds
    ``band`` are left unrefined).

    ``mappings_per_read``: list of (read_id, [Mapping...]); mutated in place.
    """
    from muchsalsa_tpu.ops.align import pack_problems
    from muchsalsa_tpu.utils.seq import reverse_complement

    banded = engine != "myers"
    pairs = []
    slots = []
    for rid, maps in mappings_per_read:
        read_seq = reads.sequence(rid)
        for m in maps:
            q = unitigs.sequence(m.unitig)[m.q_start : m.q_end]
            t = read_seq[m.t_start : m.t_end]
            if not m.strand:
                t = reverse_complement(t)
            if banded and abs(len(q) - len(t)) >= band:
                continue
            pairs.append((q, t))
            slots.append(m)
    if not pairs:
        return

    args = pack_problems(pairs)
    if not banded:
        from muchsalsa_tpu.ops.myers_jax import myers_edit_distance

        dists = myers_edit_distance(*args)
    else:
        from muchsalsa_tpu.ops.align import banded_edit_distance

        dists = banded_edit_distance(*args, band=band)

    dists = np.asarray(dists)
    for m, (q, t), d in zip(slots, pairs, dists):
        if d >= 0:
            m.matches = max(len(q), len(t)) - int(d)
