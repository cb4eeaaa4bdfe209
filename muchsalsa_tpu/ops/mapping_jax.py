"""Full read->unitig mapping on the device (XLA): the data-parallel
replacement for the reference's external ``minimap2`` stage (pipeline.sh:163) as a
single static-shape jit — not just the seed-count filter of
``ops.minimizer_jax``.

Mirrors ``pipeline.mapper.map_read`` exactly (tests assert identical
Mapping sets): minimizer sketch, sorted-index membership join, CSR
anchor expansion, global (unitig,strand)/diagonal sort, band
segmentation, per-segment stats.  The ragged parts become static-shape
idioms:

- hit positions compact into ``max_pos`` slots per read via a sort
  (ragged -> padded);
- each hit expands to at most ``max_per_hit`` index entries (reads
  hitting ultra-repetitive minimizers beyond the cap are flagged in
  ``overflow`` so callers can fall back to the host path);
- ``reduceat`` segment stats become single-HLO scatter reductions
  (``jax.ops.segment_*`` over flattened ``read*S + seg_id`` ids) read
  back per position with one flat gather each;
- per-read results compact into ``max_hits`` Mapping slots.

Throughput and the multi-chip wrapper live in ``parallel/sharded.py``
(`sharded_map_reads`): reads shard over the mesh, the index is
replicated.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from muchsalsa_tpu.ops.minimizer_jax import minimizer_sketch

_I32_MAX = jnp.int32(2**31 - 1)



RANK_LOG2 = 20  # rank-table buckets over the 32-bit hash space

# ---------------------------------------------------------------------------
# v2 join: rank-probe + packed row tables (see build_device_tables)

RANK2_LOG2 = 22          # probe buckets; FP rate = H / 2^22 per bucket
_PACK_BITS = 27          # low bits of a packed (offset | count<<27) word
_PACK_MASK = (1 << _PACK_BITS) - 1
_CNT_CAP = 31            # count saturates at 31 (only `> max_per_hit` matters)


class DeviceTables(NamedTuple):
    """Packed device join tables (host-built, see build_device_tables).

    rp:    (2^RANK2_LOG2,) uint32 — bucket b (hash top bits) holds
           ``hstart | nhashes << 27`` into the packed hash rows
           (0 == empty bucket).
    jrows: (JR, 16) uint32 — packed hash rows ``[hash x8 | val x8]``
           where ``val = entry_start | entry_count << 27`` into the
           packed entry rows.  Multi-hash buckets are 8-aligned so
           ``ceil(nhashes/8)`` row fetches cover any bucket.
    erows: (ER, 16) int32 — packed entry rows ``[unitig*2+strand x8 |
           pos x8]``.  Multi-entry blocks are 8-aligned so
           ``ceil(A/8)`` row fetches cover any block prefix of size A.
    """

    rp: jnp.ndarray
    jrows: jnp.ndarray
    erows: jnp.ndarray


def _pack_blocks(sizes):
    """Block-packing offsets: single-element blocks go contiguously
    first (they never straddle an 8-row), larger blocks are 8-aligned
    after them.  Returns (starts, total) — fully vectorised."""
    import numpy as _np

    sizes = _np.asarray(sizes, dtype=_np.int64)
    starts = _np.zeros(len(sizes), dtype=_np.int64)
    single = sizes == 1
    n1 = int(single.sum())
    starts[single] = _np.arange(n1)
    multi = ~single & (sizes > 0)
    msizes = sizes[multi]
    aligned = (msizes + 7) & ~_np.int64(7)
    base = (n1 + 7) & ~_np.int64(7)
    mstarts = base + _np.concatenate([[0], _np.cumsum(aligned)[:-1]])
    starts[multi] = mstarts
    total = int(base + aligned.sum()) if len(msizes) else max(n1, 1)
    return starts, total


def _row_bucket(n: int) -> int:
    """Round a table row count up to a quarter-step bucket (pow2 x
    {1, 1.25, 1.5, 1.75}).  The jit'd join stages take jrows/erows as
    array operands, so their ROW COUNTS are part of the executable's
    shape key: unbucketed counts would mean one compile per
    index (each scrub subset chunk, each pipeline map stage).  Pad rows
    are zeros; clipped takes read them only for overflow-flagged reads.
    Memory cost <= 25%."""
    L = 256
    while L < n:
        L *= 2
    if L > 256:
        for frac in (5, 6, 7):
            cand = (L // 8) * frac
            if cand >= n:
                return cand
    return L


def build_device_tables(
    idx_hashes, idx_offsets, entry_unitig, entry_pos, entry_strand,
):
    """Build the packed v2 join tables on the host.

    Returns (DeviceTables, hash_takes) or None when the index violates
    the packing bounds (offsets beyond 27 bits or a probe bucket with
    more than 31 distinct hashes) — callers then use the legacy
    bitmap + binary-search join path.
    """
    import numpy as _np

    h = _np.asarray(idx_hashes, dtype=_np.uint32)
    off = _np.asarray(idx_offsets, dtype=_np.int64)
    H = len(h)
    if H == 0:
        return None

    ecnt = _np.diff(off)
    # --- pack entries: per-hash blocks ---
    estarts, E2 = _pack_blocks(ecnt)
    if E2 >= (1 << _PACK_BITS):
        return None
    packed = _np.asarray(entry_unitig, _np.int64) * 2 + _np.asarray(
        entry_strand, _np.int64)
    pos = _np.asarray(entry_pos, _np.int64)
    ER = _row_bucket((E2 + 7) // 8 + 4)  # pad rows: clipped takes read zeros
    erows = _np.zeros((ER, 16), dtype=_np.int32)
    dst = _np.repeat(estarts, ecnt) + (
        _np.arange(int(off[-1])) - _np.repeat(off[:-1], ecnt))
    erows[dst // 8, dst % 8] = packed
    erows[dst // 8, 8 + dst % 8] = pos

    # --- pack hashes: per-bucket blocks ---
    b = (h >> _np.uint32(32 - RANK2_LOG2)).astype(_np.int64)
    bcnt = _np.bincount(b, minlength=1 << RANK2_LOG2)
    gmax = int(bcnt.max())
    if gmax > _CNT_CAP:
        return None
    nonempty = _np.nonzero(bcnt)[0]
    hstarts_b, H2 = _pack_blocks(bcnt[nonempty])
    if H2 >= (1 << _PACK_BITS):
        return None
    # destination of each hash = its bucket's start + rank within bucket
    first_idx = _np.concatenate([[0], _np.cumsum(bcnt[nonempty])[:-1]])
    within = _np.arange(H) - _np.repeat(first_idx, bcnt[nonempty])
    hdst = _np.repeat(hstarts_b, bcnt[nonempty]) + within
    JR = _row_bucket((H2 + 7) // 8 + 4)  # pad rows: clipped takes read zeros
    jrows = _np.zeros((JR, 16), dtype=_np.uint32)
    val = (estarts[: H] | (_np.minimum(ecnt, _CNT_CAP) << _PACK_BITS)).astype(
        _np.uint32)
    jrows[hdst // 8, hdst % 8] = h
    jrows[hdst // 8, 8 + hdst % 8] = val

    rp = _np.zeros(1 << RANK2_LOG2, dtype=_np.uint32)
    rp[nonempty] = (hstarts_b | (bcnt[nonempty] << _PACK_BITS)).astype(_np.uint32)

    hash_takes = max(1, -(-gmax // 8))
    tables = DeviceTables(
        rp=jnp.asarray(rp), jrows=jnp.asarray(jrows), erows=jnp.asarray(erows))
    return tables, hash_takes


def build_join_tables(idx_hashes) -> tuple:
    """Host-side auxiliary tables for the device join: the occupancy
    bitmap (see ``minimizer_jax.build_hash_bitmap``) plus a rank table
    ``rank[b] = lower_bound(hashes, b << (32-RANK_LOG2))`` that bounds
    the binary search to one bucket (~5 rounds instead of 20 for a
    1M-entry index), and the static round count for the largest bucket.

    Returns (bitmap, rank_table, rounds) — pass to
    :func:`map_reads_device`.
    """
    import numpy as _np

    from muchsalsa_tpu.ops.minimizer_jax import build_hash_bitmap

    h = _np.asarray(idx_hashes, dtype=_np.uint32)
    bounds = (_np.arange(1 << RANK_LOG2, dtype=_np.uint64)
              << (32 - RANK_LOG2)).astype(_np.uint32)
    rank = _np.searchsorted(h, bounds).astype(_np.int32)
    rank = _np.concatenate([rank, _np.int32([len(h)])])
    max_gap = int(_np.max(_np.diff(rank))) if len(h) else 0
    rounds = max(int(_np.ceil(_np.log2(max_gap + 1))), 1)
    return build_hash_bitmap(h), jnp.asarray(rank), rounds


@partial(jax.jit, static_argnames=(
    "k", "w", "bandwidth", "min_anchor_count", "min_chain_score",
    "max_pos", "max_per_hit", "max_hits", "log2_bits", "join_rounds",
    "trim"))
def map_reads_device(
    codes: jnp.ndarray,        # (R, L) uint8/int32, pad = 4
    lens: jnp.ndarray,         # (R,)
    idx_hashes: jnp.ndarray,   # (H,) uint32, sorted
    idx_offsets: jnp.ndarray,  # (H+1,) int32/int64 CSR offsets
    entry_unitig: jnp.ndarray, # (E,) int32
    entry_pos: jnp.ndarray,    # (E,) int32
    entry_strand: jnp.ndarray, # (E,) bool
    bitmap: jnp.ndarray | None = None,  # build_join_tables(idx_hashes)[0]
    rank_table: jnp.ndarray | None = None,  # build_join_tables(...)[1]
    k: int = 15,
    w: int = 5,
    bandwidth: int = 500,
    min_anchor_count: int = 4,
    min_chain_score: int = 100,
    max_pos: int = 512,
    max_per_hit: int = 4,
    max_hits: int = 64,
    log2_bits: int = 28,
    join_rounds: int = 0,  # rounds for the rank-bounded search (static)
    trim: int | None = None,
):
    """Map every read against the index on the device.

    Returns a dict of (R, max_hits) int32 arrays (``unitig``,
    ``strand``, ``qs``, ``qe``, ``ts``, ``te``, ``matches``,
    ``n_anchors``), plus ``n_hits`` (R,) and ``overflow`` (R,) flags
    (anchor budget exceeded -> host fallback for exactness).

    ``bitmap`` (from :func:`minimizer_jax.build_hash_bitmap`) prunes
    the expensive sorted-index binary search to the ~``max_pos``
    candidate positions per read: one O(1) occupancy gather per
    minimizer replaces log2(H) gathers per position; false positives
    are eliminated by the exact membership check on the compacted
    candidates, so results are unchanged.
    """
    R, L = codes.shape
    Lk = L - k + 1
    H = idx_hashes.shape[0]
    A = max_per_hit
    max_pos = min(max_pos, Lk)  # short batches can't exceed Lk positions
    S = max_pos * A             # anchor slots per read

    selected, h, strand = minimizer_sketch(codes, lens, k, w)   # (R, Lk)

    if bitmap is not None:
        # O(1) occupancy probe per minimizer; false positives are
        # eliminated by the exact membership check below. overflow is
        # slightly conservative (counts surviving FPs).
        folded = h & jnp.uint32((1 << log2_bits) - 1)
        probe = (bitmap[(folded >> 5).astype(jnp.int32)]
                 >> (folded & 31).astype(jnp.uint32)) & jnp.uint32(1)
        cand = selected & (probe != 0)
    else:
        # exact prefilter: log2(H) gathers over every position (slow —
        # pass a bitmap for the production path)
        loc0 = jnp.clip(jnp.searchsorted(idx_hashes, h), 0, max(H - 1, 0))
        cand = (idx_hashes[loc0] == h) & selected if H else jnp.zeros_like(selected)

    # ragged -> padded: compact candidate positions into max_pos slots
    pos_ids = jax.lax.broadcasted_iota(jnp.int32, (R, Lk), 1)
    sort_key = jnp.where(cand, pos_ids, _I32_MAX)
    pos_sorted = jax.lax.sort(sort_key, dimension=1)[:, :max_pos]   # (R, max_pos)
    pos_valid = pos_sorted < _I32_MAX
    pos_safe = jnp.where(pos_valid, pos_sorted, 0)
    n_cand = jnp.sum(cand.astype(jnp.int32), axis=1)

    take = lambda arr: jnp.take_along_axis(arr, pos_safe, axis=1)
    h_c = take(h)                            # (R, max_pos)
    strand_c = take(strand)
    t_c = pos_safe                           # anchor read position

    # exact membership join on the compacted candidates only.  With a
    # rank table the binary search is bounded to one rank bucket
    # (join_rounds ~ log2(max bucket) instead of log2(H)).
    if rank_table is not None and join_rounds > 0 and H:
        b = (h_c >> jnp.uint32(32 - RANK_LOG2)).astype(jnp.int32)
        lo_b = rank_table[b]
        hi_b = rank_table[b + 1]
        for _ in range(join_rounds):
            mid = (lo_b + hi_b) // 2
            mv = idx_hashes[jnp.clip(mid, 0, H - 1)]
            go_right = (mv < h_c) & (lo_b < hi_b)
            hi_b = jnp.where((~go_right) & (lo_b < hi_b), mid, hi_b)
            lo_b = jnp.where(go_right, mid + 1, lo_b)
        loc = jnp.clip(lo_b, 0, H - 1)
    else:
        loc = jnp.clip(jnp.searchsorted(idx_hashes, h_c), 0, max(H - 1, 0))
    found = (idx_hashes[loc] == h_c) & pos_valid if H else jnp.zeros_like(pos_valid)
    lo_c = jnp.where(found, idx_offsets[loc].astype(jnp.int32), 0)
    cnt_full = jnp.where(
        found, idx_offsets[loc + 1].astype(jnp.int32) - lo_c, 0)
    cnt_c = jnp.minimum(cnt_full, A)

    overflow = (n_cand > max_pos) | jnp.any(cnt_full > A, axis=1)

    # expand to (R, max_pos, A) anchors; (unitig, strand) pack into one
    # int32 so the expansion costs 2 gathers per anchor instead of 3
    packed = entry_unitig * 2 + entry_strand.astype(jnp.int32)
    a_ids = jnp.arange(A, dtype=jnp.int32)[None, None, :]
    a_valid = a_ids < cnt_c[:, :, None]
    src = jnp.where(a_valid, lo_c[:, :, None] + a_ids, 0)
    pk = packed[src]
    au = pk // 2
    aq = entry_pos[src]
    arel = (pk % 2) == strand_c[:, :, None].astype(jnp.int32)
    at = jnp.broadcast_to(t_c[:, :, None], src.shape)

    key = jnp.where(a_valid, au * 2 + arel.astype(jnp.int32), _I32_MAX)
    diag = jnp.where(arel, at - aq, at + aq)
    key = key.reshape(R, S)
    diag = jnp.where(a_valid, diag, 0).reshape(R, S)
    aq = jnp.where(a_valid, aq, 0).reshape(R, S)
    at = jnp.where(a_valid, at, 0).reshape(R, S)

    return _anchors_to_hits(
        key, diag, aq, at, k, bandwidth, min_anchor_count, min_chain_score,
        max_hits, overflow, trim=trim,
    )



def _anchors_to_hits(key, diag, aq, at, k, bandwidth, min_anchor_count,
                     min_chain_score, max_hits, overflow, trim=None):
    """Shared mapping tail: global (key, diag) sort, band segmentation,
    per-segment stats, hit compaction (semantics of the host path's
    chaining — ``pipeline.mapper.map_read``).

    Layout rationale (measured on the accelerator this code was first
    tuned for; not yet re-measured on the GPU):

    - ``lax.sort`` exec is cheap even with 4 operands, and its
      once-per-shape compile cost is absorbed by the persistent
      compilation cache — so payloads RIDE THE SORT as extra operands.
      Full-width ``take_along_axis`` along the lane axis cost an order
      of magnitude more per call, and a permutation-gather form of this
      tail spent nearly all its time in eight such gathers.  Gathers
      whose output is ``max_hits``-narrow are effectively free, so all
      remaining gathers happen AFTER hit compaction.
    - Per-segment reductions use RANGE ARITHMETIC over the sorted
      layout (segments are contiguous slot ranges, and the range of
      segment i is identical in any re-sort keyed by (seg_id, x)):
      ``cummax``/``cummin``/``cumsum`` are single cheap HLOs, the
      (seg_id, value) re-sorts place each segment's min at its first
      slot and max at its last, and the covered-bases prefix sum
      broadcasts from segment ends via a reverse ``cummin`` (valid
      because the prefix sum is nondecreasing).  ``associative_scan``s
      explode server compile (1165 s at 16384 slots) and
      ``jax.ops.segment_*`` scatters execute at ~0.5 s/batch.
    """
    R, S = key.shape

    # global per-read sort by ((unitig, strand), diagonal), with aq/at
    # as payload operands (see rationale above)
    key, diag, aq, at = jax.lax.sort(
        (key, diag, aq, at), dimension=1, num_keys=2)

    if trim is not None and trim < S:
        # invalid slots (key == I32_MAX) sorted last: truncating to the
        # first `trim` slots drops only padding whenever the read has
        # <= trim real anchors (flagged otherwise -> exact host
        # fallback).  The anchor budget is max_pos*max_per_hit slots
        # but real anchor counts run ~1.2 per candidate, so the
        # segment machinery below runs at a fraction of the width.
        n_anch = jnp.sum((key < _I32_MAX).astype(jnp.int32), axis=1)
        overflow = overflow | (n_anch > trim)
        key, diag, aq, at = (a[:, :trim] for a in (key, diag, aq, at))
        S = trim

    iota = jax.lax.broadcasted_iota(jnp.int32, key.shape, 1)
    valid = key < _I32_MAX

    prev_key = jnp.concatenate([jnp.full((R, 1), -1, key.dtype), key[:, :-1]], axis=1)
    prev_diag = jnp.concatenate([diag[:, :1], diag[:, :-1]], axis=1)
    new_seg = (key != prev_key) | (diag - prev_diag > bandwidth)
    new_seg = new_seg.at[:, 0].set(True)
    last_seg = jnp.concatenate(
        [new_seg[:, 1:], jnp.ones_like(new_seg[:, :1])], axis=1)

    # per-position first/last slot index of the containing segment.
    # Invalid slots sort last (key == I32_MAX) and always start their
    # own segments, so no valid segment contains an invalid slot.
    firsts = jax.lax.cummax(jnp.where(new_seg, iota, -1), axis=1)
    ends = jax.lax.cummin(
        jnp.where(last_seg, iota, _I32_MAX), axis=1, reverse=True)
    seg_n = ends - firsts + 1

    # segment min/max of aq and at: re-sort values by (seg_id, value) —
    # segment slot ranges are unchanged (seg ids are the primary key),
    # so the segment's min sits at its first slot and its max at its
    # last slot; both are read back post-compaction only
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32), axis=1) - 1
    _, q2 = jax.lax.sort((seg_id, aq), dimension=1, num_keys=2)

    # covered read bases: in (seg_id, at) order, sum t-gaps clipped at
    # k.  cg is nondecreasing per row, so the segment-END value
    # broadcasts back over the whole segment via one reverse cummin —
    # covered is exact at every segment-FIRST slot (where it is read).
    _, t2 = jax.lax.sort((seg_id, at), dimension=1, num_keys=2)
    prev_t2 = jnp.concatenate([t2[:, :1], t2[:, :-1]], axis=1)
    gaps = jnp.where(iota == firsts, 0, jnp.minimum(t2 - prev_t2, k))
    cg = jnp.cumsum(gaps, axis=1)
    cg_end = jax.lax.cummin(
        jnp.where(last_seg, cg, _I32_MAX), axis=1, reverse=True)
    covered = k + cg_end - cg

    ok = (
        new_seg & valid
        & (seg_n >= min_anchor_count)
        & (covered >= min_chain_score)
    )

    # compact surviving segments into max_hits slots (position order =
    # (key, diag) order, matching the host path's emission order).
    # hit_pos slots are segment-first slots, so q2/t2/covered read
    # there give the segment's q-min/t-min/covered, and at the
    # segment's end slot its q-max/t-max.
    hit_key = jnp.where(ok, iota, _I32_MAX)
    hit_pos = jax.lax.sort(hit_key, dimension=1)[:, :max_hits]
    hit_valid = hit_pos < _I32_MAX
    hit_safe = jnp.where(hit_valid, hit_pos, 0)

    n_hits = jnp.sum(ok.astype(jnp.int32), axis=1)
    overflow = overflow | (n_hits > max_hits)

    take = lambda arr: jnp.take_along_axis(arr, hit_safe, axis=1)
    ends_h = take(ends)
    ends_safe = jnp.where(hit_valid, ends_h, 0)
    take_end = lambda arr: jnp.take_along_axis(arr, ends_safe, axis=1)
    mask = lambda arr: jnp.where(hit_valid, arr, 0)

    key_h = take(key)
    return {
        "unitig": jnp.where(hit_valid, key_h // 2, 0),
        "strand": jnp.where(hit_valid, key_h % 2, 0),
        "qs": mask(take(q2)),
        "qe": mask(take_end(q2) + k),
        "ts": mask(take(t2)),
        "te": mask(take_end(t2) + k),
        "matches": mask(take(covered)),
        "n_anchors": mask(ends_h - hit_pos + 1),
        "n_hits": jnp.minimum(n_hits, max_hits),
        "overflow": overflow,
    }


def _v2_compact(
    selected: jnp.ndarray,     # (R, Lk) bool from minimizer_sketch
    h: jnp.ndarray,            # (R, Lk) uint32
    strand: jnp.ndarray,       # (R, Lk) bool
    rp: jnp.ndarray,           # DeviceTables.rp
    max_sel: int = 4608,
    max_pos: int = 1024,
):
    """v2 stage 1b: compact the selected minimizers, rank-probe only
    the compacted slots, then compact the candidates to ``max_pos``.
    Returns (ckey, h_c, rpv_c, overflow) where ckey packs
    position*2+strand (invalid slots are _I32_MAX).

    The probe's table gather costs ~1.7 us per lane column on the chip
    (round-4 probe: 17.4 ms over Lk=10226 vs 7.8 ms over P=4608), so
    the selected positions compact FIRST — the probe then touches only
    ``max_sel`` slots.  Payloads ride the sorts as extra operands:
    full-width ``take_along_axis`` costs ~10 ms at (256, 4096) while
    sort operands add ~0.1 ms each (see ``_anchors_to_hits``).

    Overflow semantics are unchanged vs the probe-everything form:
    ``n_selected > min(max_sel, Lk)`` or ``n_candidates > max_pos``
    flags the read for host fallback, and non-overflow reads see
    exactly the same candidate set (truncation to P keeps the first P
    selected positions, which for non-overflow reads is all of them)."""
    skey, h_s, n_sel = _v2_selcompact(selected, h, strand, max_sel=max_sel)
    rpv, cand = _v2_probe(skey, h_s, rp)
    return _v2_compact2(skey, h_s, rpv, cand, n_sel, max_pos=max_pos)


def _v2_selcompact(selected, h, strand, max_sel=4608):
    """Compact selected minimizer slots to (R, P): skey packs
    position*2+strand (invalid slots _I32_MAX), h rides as payload.
    Returns (skey, h_s, n_sel)."""
    R, Lk = selected.shape
    P = min(max_sel, Lk)
    pos_ids = jax.lax.broadcasted_iota(jnp.int32, (R, Lk), 1)
    skey = jnp.where(selected, pos_ids * 2 + strand.astype(jnp.int32),
                     _I32_MAX)
    skey, h_s = jax.lax.sort((skey, h), dimension=1, num_keys=1)
    n_sel = jnp.sum(selected.astype(jnp.int32), axis=1)
    return skey[:, :P], h_s[:, :P], n_sel


def _v2_probe(skey, h_s, rp):
    """Rank probe over the compacted slots: one gather per slot (its
    own jit in production — composing the 4M-table gather with the
    compaction sorts multiplies server compile cost ~3x,
    docs/DESIGN.md 4b)."""
    valid = skey < _I32_MAX
    bkt = (h_s >> jnp.uint32(32 - RANK2_LOG2)).astype(jnp.int32)
    rpv = rp[jnp.where(valid, bkt, 0)]
    return rpv, valid & (rpv != 0)


def _v2_compact2(skey, h_s, rpv, cand, n_sel, max_pos=1024):
    """Compact candidate slots to (R, max_pos); h and rpv ride the
    sort as payload operands (no post-sort wide gathers)."""
    R, P = skey.shape
    max_pos = min(max_pos, P)
    ckey = jnp.where(cand, skey, _I32_MAX)
    ckey, h_c, rpv_c = jax.lax.sort((ckey, h_s, rpv), dimension=1, num_keys=1)
    n_cand = jnp.sum(cand.astype(jnp.int32), axis=1)
    overflow = (n_sel > P) | (n_cand > max_pos)
    return ckey[:, :max_pos], h_c[:, :max_pos], rpv_c[:, :max_pos], overflow


def _v2_select(
    codes: jnp.ndarray,        # (R, L) uint8/int32, pad = 4
    lens: jnp.ndarray,         # (R,)
    rp: jnp.ndarray,           # DeviceTables.rp
    k: int = 15,
    w: int = 5,
    max_sel: int = 4608,
    max_pos: int = 1024,
):
    """v2 stage 1: minimizer sketch + :func:`_v2_compact`."""
    selected, h, strand = minimizer_sketch(codes, lens, k, w)  # (R, Lk)
    return _v2_compact(selected, h, strand, rp, max_sel=max_sel,
                       max_pos=max_pos)


def _v2_expand(
    ckey: jnp.ndarray,         # (R, max_pos) from _v2_select
    h_c: jnp.ndarray,
    rpv_c: jnp.ndarray,
    overflow: jnp.ndarray,
    jrows: jnp.ndarray,        # DeviceTables.jrows
    erows: jnp.ndarray,        # DeviceTables.erows
    max_per_hit: int = 4,
    hash_takes: int = 1,       # from build_device_tables
):
    """v2 stage 2: packed-row join + packed-row entry expansion.
    Returns the flat anchor arrays (key, diag, aq, at) of shape
    (R, max_pos*max_per_hit) plus the WIDTH overflow flags and the
    per-read ``max_ecnt`` (max index-entry count over the read's found
    minimizers, saturated at 31) — inputs to :func:`_anchors_to_hits`.

    ``max_ecnt`` is the tier-routing signal (round 5): a read whose
    only budget violation is ``max_ecnt > max_per_hit`` loses no
    anchors at a HIGHER ``max_per_hit``, so the host can re-dispatch it
    through a wider-expansion executable instead of falling back — the
    cap violation itself is NOT folded into ``overflow`` here (the
    chaining tail folds it via ``per_hit_cap``).

    Every random access is either one 4-byte rank-probe gather or a
    contiguous 16-word row fetch (``jnp.take(..., axis=0)``), replacing
    the bitmap probe + 6-round binary search + 3D entry gathers of v1
    (measured ~4x end to end).  ``max_per_hit`` must be < 31 (count
    saturation bound).
    """
    if max_per_hit >= _CNT_CAP:
        raise ValueError("max_per_hit must be < 31 for the v2 join path")
    R, max_pos = ckey.shape
    A = max_per_hit
    S = max_pos * A
    entry_takes = max(1, -(-A // 8))
    cand_v = ckey < _I32_MAX
    t_c = jnp.where(cand_v, ckey >> 1, 0)          # anchor read position
    strand_c = (ckey & 1).astype(jnp.int32)

    # -- join: fetch the candidate's probe bucket as packed hash rows
    hlo = (rpv_c & jnp.uint32(_PACK_MASK)).astype(jnp.int32)
    hcnt = (rpv_c >> _PACK_BITS).astype(jnp.int32)
    JR = jrows.shape[0]
    row0 = hlo >> 3
    whash = []
    wval = []
    for t in range(hash_takes):
        jr = jnp.take(jrows, jnp.clip(row0 + t, 0, JR - 1), axis=0)  # (R,C,16)
        whash.append(jr[..., :8])
        wval.append(jr[..., 8:])
    whash = jnp.concatenate(whash, axis=-1)        # (R, C, 8*hash_takes)
    wval = jnp.concatenate(wval, axis=-1)
    Wh = 8 * hash_takes
    slot = (row0 * 8)[..., None] + jnp.arange(Wh, dtype=jnp.int32)
    match = (
        cand_v[..., None]
        & (whash == h_c[..., None])
        & (slot >= hlo[..., None])
        & (slot < (hlo + hcnt)[..., None])
    )
    found = jnp.any(match, axis=-1)
    val = jnp.sum(jnp.where(match, wval, jnp.uint32(0)), axis=-1)  # <=1 match
    elo = (val & jnp.uint32(_PACK_MASK)).astype(jnp.int32)
    ecnt = (val >> _PACK_BITS).astype(jnp.int32)
    max_ecnt = jnp.max(jnp.where(found, ecnt, 0), axis=1)
    cnt_c = jnp.where(found, jnp.minimum(ecnt, A), 0)

    # -- expand: fetch each hash's entry block as packed entry rows.
    # Multi-entry blocks are 8-aligned (offset 0); single-entry blocks
    # sit at arbitrary offsets but only need slot elo%8.
    ER = erows.shape[0]
    erow0 = elo >> 3
    wpk = []
    wpos = []
    for t in range(entry_takes):
        er = jnp.take(erows, jnp.clip(erow0 + t, 0, ER - 1), axis=0)  # (R,C,16)
        wpk.append(er[..., :8])
        wpos.append(er[..., 8:])
    wpk = jnp.concatenate(wpk, axis=-1)            # (R, C, 8*entry_takes)
    wpos = jnp.concatenate(wpos, axis=-1)
    s0 = elo & 7
    sel8 = lambda wnd: sum(
        jnp.where(s0 == s, wnd[..., s], 0) for s in range(8))
    a_ids = jnp.arange(A, dtype=jnp.int32)
    a_valid = a_ids[None, None, :] < cnt_c[:, :, None]
    aligned = (s0 == 0)[..., None]
    pk = jnp.where(
        a_ids[None, None, :] == 0, sel8(wpk)[..., None],
        jnp.where(aligned, wpk[..., :A], 0))
    aq = jnp.where(
        a_ids[None, None, :] == 0, sel8(wpos)[..., None],
        jnp.where(aligned, wpos[..., :A], 0))
    pk = jnp.where(a_valid, pk, 0)
    aq = jnp.where(a_valid, aq, 0)

    au = pk >> 1
    arel = (pk & 1) == strand_c[:, :, None]
    at = jnp.broadcast_to(t_c[:, :, None], (R, max_pos, A))

    key = jnp.where(a_valid, au * 2 + arel.astype(jnp.int32), _I32_MAX)
    diag = jnp.where(arel, at - aq, at + aq)
    key = key.reshape(R, S)
    diag = jnp.where(a_valid, diag, 0).reshape(R, S)
    aq = aq.reshape(R, S)
    at = jnp.where(a_valid, at, 0).reshape(R, S)

    return key, diag, aq, at, overflow, max_ecnt


def _v2_anchors(
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    rp: jnp.ndarray,
    jrows: jnp.ndarray,
    erows: jnp.ndarray,
    k: int = 15,
    w: int = 5,
    max_sel: int = 4608,
    max_pos: int = 1024,
    max_per_hit: int = 4,
    hash_takes: int = 1,
):
    """v2 sketch + join + expansion (:func:`_v2_select` composed with
    :func:`_v2_expand`)."""
    ckey, h_c, rpv_c, overflow = _v2_select(
        codes, lens, rp, k=k, w=w, max_sel=max_sel, max_pos=max_pos)
    return _v2_expand(
        ckey, h_c, rpv_c, overflow, jrows, erows,
        max_per_hit=max_per_hit, hash_takes=hash_takes)


@partial(jax.jit, static_argnames=("k", "w"))
def sketch_device_packed(
    packed: jnp.ndarray,
    nmask: jnp.ndarray,
    lens: jnp.ndarray,
    k: int = 15,
    w: int = 5,
):
    """Production jit 1/6 over packed codes: the minimizer sketch.
    The 6-way split (sketch | selcompact | probe | compact | expand |
    tail) exists because whole-program server compile time explodes
    combinatorially with program size (see docs/DESIGN.md 4b);
    intermediates stay on the device."""
    return minimizer_sketch(unpack_codes(packed, nmask), lens, k, w)


@partial(jax.jit, static_argnames=("max_sel",))
def select_compact_device_v2(
    selected: jnp.ndarray,
    h: jnp.ndarray,
    strand: jnp.ndarray,
    max_sel: int = 4608,
):
    """Production jit 2/6: compact selected minimizers to ``max_sel``
    slots (so the probe gathers only over those)."""
    return _v2_selcompact(selected, h, strand, max_sel=max_sel)


@jax.jit
def probe_candidates_device_v2(
    skey: jnp.ndarray,
    h_s: jnp.ndarray,
    rp: jnp.ndarray,
):
    """Production jit 3/6: the rank-table probe over compacted slots."""
    return _v2_probe(skey, h_s, rp)


@partial(jax.jit, static_argnames=("max_pos",))
def compact_candidates_device_v2(
    skey: jnp.ndarray,
    h_s: jnp.ndarray,
    rpv: jnp.ndarray,
    cand: jnp.ndarray,
    n_sel: jnp.ndarray,
    max_pos: int = 1024,
):
    """Production jit 4/6: candidate compaction to ``max_pos``."""
    return _v2_compact2(skey, h_s, rpv, cand, n_sel, max_pos=max_pos)


@partial(jax.jit, static_argnames=("k", "w", "max_sel", "max_pos"))
def map_select_device_v2_packed(
    packed: jnp.ndarray,
    nmask: jnp.ndarray,
    lens: jnp.ndarray,
    rp: jnp.ndarray,
    k: int = 15,
    w: int = 5,
    max_sel: int = 4608,
    max_pos: int = 1024,
):
    """Fused jits 1+2 (sketch + compaction) — kept as the semantics
    reference for tests; production uses the split pair."""
    return _v2_select(
        unpack_codes(packed, nmask), lens, rp, k=k, w=w, max_sel=max_sel,
        max_pos=max_pos)


@partial(jax.jit, static_argnames=("max_per_hit", "hash_takes"))
def expand_anchors_device_v2(
    ckey: jnp.ndarray,
    h_c: jnp.ndarray,
    rpv_c: jnp.ndarray,
    overflow: jnp.ndarray,
    jrows: jnp.ndarray,
    erows: jnp.ndarray,
    max_per_hit: int = 4,
    hash_takes: int = 1,
):
    """Production jit 5/6: packed-row join + entry expansion."""
    return _v2_expand(
        ckey, h_c, rpv_c, overflow, jrows, erows,
        max_per_hit=max_per_hit, hash_takes=hash_takes)


@partial(jax.jit, static_argnames=(
    "k", "w", "bandwidth", "min_anchor_count", "min_chain_score",
    "max_sel", "max_pos", "max_per_hit", "max_hits", "hash_takes",
    "trim"))
def map_reads_device_v2(
    codes: jnp.ndarray,
    lens: jnp.ndarray,
    rp: jnp.ndarray,
    jrows: jnp.ndarray,
    erows: jnp.ndarray,
    k: int = 15,
    w: int = 5,
    bandwidth: int = 500,
    min_anchor_count: int = 4,
    min_chain_score: int = 100,
    max_sel: int = 4608,
    max_pos: int = 1024,
    max_per_hit: int = 4,
    max_hits: int = 64,
    hash_takes: int = 1,
    trim: int | None = None,
):
    """v2 of :func:`map_reads_device` as ONE jit: anchor expansion
    (:func:`_v2_anchors`) + chaining tail (:func:`_anchors_to_hits`).
    Same results as the split pair below; kept for small shapes and as
    the semantics reference."""
    key, diag, aq, at, overflow, max_ecnt = _v2_anchors(
        codes, lens, rp, jrows, erows, k=k, w=w, max_sel=max_sel,
        max_pos=max_pos, max_per_hit=max_per_hit, hash_takes=hash_takes)
    overflow = overflow | (max_ecnt > max_per_hit)
    return _anchors_to_hits(
        key, diag, aq, at, k, bandwidth, min_anchor_count, min_chain_score,
        max_hits, overflow, trim=trim,
    )


@partial(jax.jit, static_argnames=(
    "k", "w", "max_sel", "max_pos", "max_per_hit", "hash_takes"))
def map_anchors_device_v2_packed(
    packed: jnp.ndarray,
    nmask: jnp.ndarray,
    lens: jnp.ndarray,
    rp: jnp.ndarray,
    jrows: jnp.ndarray,
    erows: jnp.ndarray,
    k: int = 15,
    w: int = 5,
    max_sel: int = 4608,
    max_pos: int = 1024,
    max_per_hit: int = 4,
    hash_takes: int = 1,
):
    """First half of the SPLIT v2 mapping pipeline over packed codes:
    anchors only.  The split bounds compile time, which grows much
    faster than linearly with whole-program size (the fused single jit
    compiled an order of magnitude slower than its two halves at 16384
    anchor slots); the intermediate anchor arrays stay on the device."""
    return _v2_anchors(
        unpack_codes(packed, nmask), lens, rp, jrows, erows, k=k, w=w,
        max_sel=max_sel, max_pos=max_pos, max_per_hit=max_per_hit,
        hash_takes=hash_takes)


@partial(jax.jit, static_argnames=(
    "k", "bandwidth", "min_anchor_count", "min_chain_score", "max_hits",
    "trim", "per_hit_cap"))
def anchors_to_hits_device(
    key: jnp.ndarray,
    diag: jnp.ndarray,
    aq: jnp.ndarray,
    at: jnp.ndarray,
    overflow: jnp.ndarray,
    max_ecnt: jnp.ndarray | None = None,
    k: int = 15,
    bandwidth: int = 500,
    min_anchor_count: int = 4,
    min_chain_score: int = 100,
    max_hits: int = 64,
    trim: int | None = None,
    per_hit_cap: int | None = None,
):
    """Second half of the split v2 mapping pipeline: chaining tail.
    ``per_hit_cap`` folds the expansion-cap violation (``max_ecnt >
    cap``) into the overflow flag (the expand stage emits the count
    but no longer folds it, so the host can tier-route)."""
    if max_ecnt is not None and per_hit_cap is not None:
        overflow = overflow | (max_ecnt > per_hit_cap)
    return _anchors_to_hits(
        key, diag, aq, at, k, bandwidth, min_anchor_count,
        min_chain_score, max_hits, overflow, trim=trim)


HIT_FIELDS = ("unitig", "strand", "qs", "qe", "ts", "te", "matches",
              "n_anchors")


@partial(jax.jit, static_argnames=(
    "k", "bandwidth", "min_anchor_count", "min_chain_score", "max_hits",
    "trim", "per_hit_cap"))
def anchors_to_hits_device_packed(
    key: jnp.ndarray,
    diag: jnp.ndarray,
    aq: jnp.ndarray,
    at: jnp.ndarray,
    overflow: jnp.ndarray,
    max_ecnt: jnp.ndarray | None = None,
    k: int = 15,
    bandwidth: int = 500,
    min_anchor_count: int = 4,
    min_chain_score: int = 100,
    max_hits: int = 64,
    trim: int | None = None,
    per_hit_cap: int | None = None,
):
    """:func:`anchors_to_hits_device` with the result packed into ONE
    (R, 8*max_hits + 2) int32 array — [HIT_FIELDS x max_hits | n_hits |
    overflow].  One d2h transfer per batch instead of ten: each
    transfer pays a fixed latency on top of its bytes."""
    if max_ecnt is not None and per_hit_cap is not None:
        overflow = overflow | (max_ecnt > per_hit_cap)
    out = _anchors_to_hits(
        key, diag, aq, at, k, bandwidth, min_anchor_count,
        min_chain_score, max_hits, overflow, trim=trim)
    R = key.shape[0]
    head = jnp.stack([out[f].astype(jnp.int32) for f in HIT_FIELDS],
                     axis=1).reshape(R, 8 * max_hits)
    tail = jnp.stack(
        [out["n_hits"].astype(jnp.int32), out["overflow"].astype(jnp.int32)],
        axis=1)
    return jnp.concatenate([head, tail], axis=1)


@partial(jax.jit, static_argnames=(
    "k", "bandwidth", "min_anchor_count", "min_chain_score", "max_hits",
    "trim", "budget"))
def anchors_to_hits_device_dense(
    key: jnp.ndarray,
    diag: jnp.ndarray,
    aq: jnp.ndarray,
    at: jnp.ndarray,
    overflow: jnp.ndarray,
    max_ecnt: jnp.ndarray | None = None,
    k: int = 15,
    bandwidth: int = 500,
    min_anchor_count: int = 4,
    min_chain_score: int = 100,
    max_hits: int = 64,
    trim: int | None = None,
    budget: int | None = None,
):
    """Chaining tail with a DENSE d2h layout: real hits average ~7 per
    read while the padded (R, 8*max_hits+2) layout ships 514 words per
    read, so the dense layout moves ~40x fewer bytes device-to-host.
    Packs the batch's hits into ``budget`` (default 16*R) flat rows.

    Returns (dense, meta):
      dense: (budget, 9) int32 rows [flat_slot | unitig | strand | qs |
             qe | ts | te | matches | n_anchors], hits in
             (read, hit-slot) order, ``flat_slot = rid*max_hits+slot``
             (_I32_MAX rows = padding);
      meta:  per-read [n_hits | width_overflow | max_ecnt] — the
             overflow word here is WIDTH overflow only (selection /
             candidate / anchor / hit budgets); the expansion-cap
             violation is reported via max_ecnt so the HOST decides:
             a read needs handling iff width_overflow or max_ecnt >
             max_per_hit, and cap-only violations can re-dispatch
             through a wider-``max_per_hit`` tier executable instead
             of falling back to the host path (round 5).

    If the batch's total hits exceed ``budget`` the caller must re-pull
    via the padded tail (detectable host-side: sum(min(n_hits,
    max_hits)) > budget); per-read semantics are unchanged.

    Everything returns as ONE flat (3R + 9*budget,) int32 array
    [n_hits (R) | width_overflow (R) | max_ecnt (R) | dense rows
    row-major]: each d2h transfer pays a fixed round-trip latency, so a
    separate meta pull would cost more than the bytes it saves.
    """
    # the tail's hit outputs do not depend on the overflow input (it
    # is only OR-carried), so run it on the raw width sources and keep
    # the cap violation separate in the meta
    out = _anchors_to_hits(
        key, diag, aq, at, k, bandwidth, min_anchor_count,
        min_chain_score, max_hits, overflow, trim=trim)
    me_word = (max_ecnt if max_ecnt is not None
               else jnp.zeros_like(out["n_hits"]))
    R = key.shape[0]
    F = R * max_hits
    # clamp: sort(flat_key)[:B] can never yield more than F rows, and a
    # caller-set budget > F would make the returned flat array shorter
    # than the host's expected 3R+9*budget layout (reshape crash in
    # collect_dense); the host side clamps identically
    B = min(budget if budget is not None else 16 * R, F)
    slot = jax.lax.broadcasted_iota(jnp.int32, (R, max_hits), 1)
    hit_valid = slot < out["n_hits"][:, None]
    flat_key = jnp.where(
        hit_valid,
        jax.lax.broadcasted_iota(jnp.int32, (R, max_hits), 0) * max_hits
        + slot,
        _I32_MAX,
    ).reshape(F)
    pos = jax.lax.sort(flat_key, dimension=0)[:B]
    safe = jnp.where(pos < _I32_MAX, pos, 0)
    cols = [pos] + [
        jnp.where(pos < _I32_MAX,
                  out[f].astype(jnp.int32).reshape(F)[safe], 0)
        for f in HIT_FIELDS
    ]
    dense = jnp.stack(cols, axis=1)
    return jnp.concatenate([
        out["n_hits"].astype(jnp.int32),
        out["overflow"].astype(jnp.int32),
        me_word.astype(jnp.int32),
        dense.reshape(9 * B),
    ])


def unpack_hits(arr, max_hits: int):
    """Host-side inverse of :func:`anchors_to_hits_device_packed` ->
    the :func:`_anchors_to_hits` dict (numpy arrays)."""
    import numpy as _np

    arr = _np.asarray(arr)
    R = arr.shape[0]
    fields = arr[:, : 8 * max_hits].reshape(R, 8, max_hits)
    out = {f: fields[:, i] for i, f in enumerate(HIT_FIELDS)}
    out["n_hits"] = arr[:, -2]
    out["overflow"] = arr[:, -1] != 0
    return out


# ---------------------------------------------------------------------------
# packed transfer: 2-bit base codes + non-ACGT bitmask
#
# The production entry (pipeline/mapper.py::map_all_with_device) ships every
# read to the device (~126 MB of uint8 codes per E. coli-scale run).
# Packing each base to 2 bits plus a 1-bit "other/pad" mask ships 0.375
# bytes/base instead of 1 — the unpack is a handful of vector shifts inside the
# same jit, and results stay bit-identical (pad positions decode back to the
# sentinel 4 consumed by minimizer_sketch, ops/minimizer_jax.py:51).


def pack_codes(codes):
    """Host-side pack of (R, L) uint8 base codes (A..T=0..3, other/pad=4)
    into (packed, nmask): 16 bases per uint32 word + 32 mask bits per
    uint32 word.  Requires L % 32 == 0 (length buckets are powers of two
    >= 1024, pipeline/mapper.py::bucket_len)."""
    import numpy as _np

    R, L = codes.shape
    if L % 32:
        raise ValueError("pack_codes needs L % 32 == 0")
    c = codes.astype(_np.uint32)
    two = (c & 3).reshape(R, L // 16, 16)
    packed = _np.bitwise_or.reduce(
        two << (_np.arange(16, dtype=_np.uint32) * 2), axis=2)
    nbits = (c >= 4).astype(_np.uint32).reshape(R, L // 32, 32)
    nmask = _np.bitwise_or.reduce(
        nbits << _np.arange(32, dtype=_np.uint32), axis=2)
    return packed, nmask


def unpack_codes(packed, nmask):
    """Device-side inverse of :func:`pack_codes` -> (R, L) uint8 codes."""
    R, W = packed.shape
    if nmask.shape != (R, W // 2):
        raise ValueError(
            f"mismatched pack pair: packed {packed.shape} needs nmask "
            f"{(R, W // 2)}, got {nmask.shape}")
    L = W * 16
    sh2 = jnp.arange(16, dtype=jnp.uint32) * 2
    codes = ((packed[:, :, None] >> sh2) & 3).astype(jnp.uint8).reshape(R, L)
    sh1 = jnp.arange(32, dtype=jnp.uint32)
    other = (((nmask[:, :, None] >> sh1) & 1) != 0).reshape(R, L)
    return jnp.where(other, jnp.uint8(4), codes)


@partial(jax.jit, static_argnames=(
    "k", "w", "bandwidth", "min_anchor_count", "min_chain_score",
    "max_sel", "max_pos", "max_per_hit", "max_hits", "hash_takes",
    "trim"))
def map_reads_device_v2_packed(
    packed: jnp.ndarray,       # (R, L//16) uint32 from pack_codes
    nmask: jnp.ndarray,        # (R, L//32) uint32 from pack_codes
    lens: jnp.ndarray,         # (R,)
    rp: jnp.ndarray,
    jrows: jnp.ndarray,
    erows: jnp.ndarray,
    **kwargs,
):
    """:func:`map_reads_device_v2` over 2-bit packed read codes."""
    return map_reads_device_v2(
        unpack_codes(packed, nmask), lens, rp, jrows, erows, **kwargs)
