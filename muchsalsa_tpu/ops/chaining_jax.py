"""Batched, bucketized anchor-chaining DP for the device (XLA).

This is the data-parallel replacement for the reference's job-per-edge
``getMaxPairwisePaths`` fan-out (``mpp.cpp:145-249`` dispatched from
``main.cpp:170-178``): instead of one thread touching one edge's shared
hash maps, every (edge, strand-class) problem becomes one row of a
padded ``(B, K)`` batch, the O(K^2) compatibility matrix and the forward
DP run as vectorised XLA ops, and only the tiny per-problem results
(scores + backpointers) return to the host, where chain reconstruction
and the irregular selection rules (75% secondaries, shadow demotion)
reuse the oracle's ``finalize_paths``.

Semantics are bit-matched to ``ops.chaining.check_compatibility`` —
verified by the equivalence tests in ``tests/test_chaining_jax.py``.
Compute dtype follows ``jax_enable_x64``: float64 in the tests (exact
vs the oracle), float32 by default.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from muchsalsa_tpu.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu.ops.chaining import ChainResult, EdgeContext, finalize_paths

_NEG = -1e30


def _corrected(ns, ne, is_, ie, rr, vdir, ov_s, ov_e):
    """Anchor range corrected by rRatio-projected overlap trimming."""
    ncl = (ov_s - is_) / rr
    ncr = (ie - ov_e) / rr
    lo = ns + jnp.where(vdir, ncl, ncr)
    hi = ne - jnp.where(vdir, ncr, ncl)
    return lo, hi


def _pair_orientation(lo, hi):
    """All-pairs orientation codes + gap diffs for one vertex's anchors.

    Returns (K, K) ``ori`` in {-2,-1,0,1,2} and ``diff`` arrays where
    [k, l] describes anchors (k, l) — mirrors mpp.cpp:67-91.
    """
    a_lo, a_hi = lo[:, None], hi[:, None]
    b_lo, b_hi = lo[None, :], hi[None, :]
    intersect = (a_lo <= b_hi) & (b_lo <= a_hi)

    fwd = (a_lo < b_lo) & (a_hi < b_hi)
    bwd = (a_lo > b_lo) & (a_hi > b_hi)
    ori_int = jnp.where(bwd, -2, jnp.where(fwd, 2, 0))
    diff_int = jnp.where(
        bwd, b_hi - a_lo + 1.0, jnp.where(fwd, a_hi - b_lo + 1.0, 0.0)
    )

    lt = a_lo < b_lo
    ori_dis = jnp.where(lt, 1, -1)
    diff_dis = jnp.where(lt, b_lo - a_hi + 1.0, a_lo - b_hi + 1.0)

    ori = jnp.where(intersect, ori_int, ori_dis)
    diff = jnp.where(intersect, diff_int, diff_dis)
    return ori, diff


def _vertex_abort(ns, ne, ori):
    """Abort when corrected and uncorrected orientations disagree in sign
    over intersecting uncorrected ranges (mpp.cpp:93-109)."""
    a_s, a_e = ns[:, None], ne[:, None]
    b_s, b_e = ns[None, :], ne[None, :]
    intersect = (a_s <= b_e) & (b_s <= a_e)
    fwd = (a_s < b_s) & (a_e < b_e)
    bwd = (a_s > b_s) & (a_e > b_e)
    uco = jnp.where(bwd, -2, jnp.where(fwd, 2, 0))
    return intersect & (((ori < 0) & (uco >= 0)) | ((ori > 0) & (uco <= 0)))


def _single_compat(b):
    """(K, K) compatibility matrix + (K,) initial scores for one
    problem (mpp.cpp:38-142 semantics)."""
    wiggle_room = b.pop("_wiggle")
    v_lo, v_hi = _corrected(
        b["v_ns"], b["v_ne"], b["v_is"], b["v_ie"], b["v_rr"], b["v_dir"],
        b["ov_s"], b["ov_e"],
    )
    w_lo, w_hi = _corrected(
        b["w_ns"], b["w_ne"], b["w_is"], b["w_ie"], b["w_rr"], b["w_dir"],
        b["ov_s"], b["ov_e"],
    )

    o1, d1 = _pair_orientation(v_lo, v_hi)
    o2, d2 = _pair_orientation(w_lo, w_hi)

    abort = _vertex_abort(b["v_ns"], b["v_ne"], o1) | _vertex_abort(
        b["w_ns"], b["w_ne"], o2
    )

    o2 = jnp.where(b["cls_dir"], o2, -o2)

    same_nz = (o1 == o2) & (o1 != 0)
    mx = jnp.maximum(d1, d2)
    diff = mx - jnp.minimum(d1, d2)
    rel = jnp.where(mx != 0, diff * 100.0 / mx, jnp.inf)
    rule1 = same_nz & ((diff <= wiggle_room) | (rel <= 15.0))
    rule2 = (
        ~same_nz
        & (((o1 < 0) & (o2 < 0)) | ((o1 > 0) & (o2 > 0)))
        & (d1 + d2 <= wiggle_room)
    )

    valid_pair = b["valid"][:, None] & b["valid"][None, :]
    compat = ~abort & (rule1 | rule2) & valid_pair
    init = jnp.where(b["valid"], b["score"], _NEG)
    return compat, init


@partial(jax.jit, static_argnames=("wiggle_room",))
def chain_dp_batch(batch: dict, wiggle_room: int):
    """Compute per-problem DP scores + backpointers.

    ``batch`` holds (B, K) arrays (anchor data in vStart-sorted order)
    plus (B,) ``cls_dir`` and (B, K) ``valid`` mask.  Returns
    (scores (B, K), backptr (B, K) int32).
    """

    def single(b):
        b = dict(b)
        b["_wiggle"] = jnp.asarray(wiggle_room, b["score"].dtype)
        compat, init = _single_compat(b)
        K = init.shape[0]
        idx = jnp.arange(K)

        def step(scores, l):
            cand = jnp.where(compat[:, l] & (idx < l), scores, _NEG)
            best = jnp.max(cand)
            bp = jnp.where(best > _NEG, jnp.argmax(cand), -1)
            new_l = jnp.where(best > _NEG, init[l] + best, scores[l])
            return scores.at[l].set(new_l), bp

        final, bps = jax.lax.scan(step, init, jnp.arange(K))
        return final, bps.astype(jnp.int32)

    return jax.vmap(single)(batch)


# ---------------------------------------------------------------------------
# host-side batch construction + result assembly

# (field name in batch) -> (field name in GatheredMatches)
_FIELD_MAP = {
    "v_ns": "v_ns", "v_ne": "v_ne", "v_is": "v_is", "v_ie": "v_ie", "v_rr": "v_rr",
    "w_ns": "w_ns", "w_ne": "w_ne", "w_is": "w_is", "w_ie": "w_ie", "w_rr": "w_rr",
    "ov_s": "ov_start", "ov_e": "ov_end", "score": "em_score",
}


def chaining_phase_device(
    graph,
    store: MatchStore,
    edge_matches: EdgeMatches,
    wiggle_room: int,
    chain_buckets: tuple[int, ...] = (8, 16, 32, 64, 128),
    min_device_batch: int = 32,
    mesh=None,
) -> None:
    """Device-batched variant of ``driver.chaining_phase``.

    One problem per (edge, strand class); batch construction is fully
    vectorised (one global lexsort + flat scatters).  Problems larger
    than the biggest bucket fall back to the oracle, as does any bucket
    smaller than ``min_device_batch``.

    With ``mesh`` (>1 device) each bucket batch shards data-parallel
    over the mesh's first axis via ``parallel.sharded.sharded_chain_dp``
    — the SPMD mapping of the reference's job-per-edge fan-out
    (main.cpp:170-178, SURVEY.md §2.5).
    """
    from muchsalsa_tpu.ops.chaining import GatheredMatches, max_pairwise_paths
    from muchsalsa_tpu.ops.overlap import get_overlap

    dtype = np.float64 if jax.config.read("jax_enable_x64") else np.float32
    max_bucket = max(chain_buckets)

    gathered = GatheredMatches.build(store, edge_matches)
    em = edge_matches
    f = gathered.fields
    n_rows = len(em.em_edge)

    # global problem grouping: key = (edge, strand class); rows within a
    # problem sorted in vStart order (v_ns, v_ne, illu) — mpp.cpp:172
    key = em.em_edge.astype(np.int64) * 2 + em.em_direction
    order = np.lexsort((f["illu_ids"], f["v_ne"], f["v_ns"], key))
    key_s = key[order]
    bounds = np.nonzero(np.diff(key_s))[0] + 1 if n_rows else np.zeros(0, np.int64)
    starts = np.concatenate([[0], bounds]).astype(np.int64) if n_rows else np.zeros(0, np.int64)
    ends = np.concatenate([bounds, [n_rows]]).astype(np.int64) if n_rows else np.zeros(0, np.int64)
    sizes = ends - starts
    prob_edge = (key_s[starts] // 2).astype(np.int64) if n_rows else np.zeros(0, np.int64)
    prob_dir = (key_s[starts] % 2).astype(bool) if n_rows else np.zeros(0, bool)
    # local (within-edge) row index of each sorted global row
    local_idx = order - em.em_offsets[em.em_edge[order]] if n_rows else np.zeros(0, np.int64)

    n_problems = len(sizes)
    results: dict[tuple[int, bool], list[ChainResult]] = {}

    contexts: dict[int, EdgeContext] = {}

    def ctx_of(edge_idx: int) -> EdgeContext:
        ctx = contexts.get(edge_idx)
        if ctx is None:
            ctx = gathered.context(store, edge_matches, edge_idx)
            contexts[edge_idx] = ctx
        return ctx

    # bucket assignment (vectorised)
    bucket_of = np.full(n_problems, -1, dtype=np.int64)
    for b in sorted(chain_buckets, reverse=True):
        bucket_of[sizes <= b] = b

    host_probs: list[int] = list(np.nonzero(bucket_of < 0)[0])

    for bucket in sorted(set(chain_buckets)):
        probs = np.nonzero(bucket_of == bucket)[0]
        if len(probs) == 0:
            continue
        if len(probs) < min_device_batch:
            host_probs.extend(probs.tolist())
            continue
        # pad the batch axis to the next power of two: B is data-dependent
        # and every distinct (B, K) shape is a fresh compile
        nb = len(probs)
        B = 1 << int(nb - 1).bit_length() if nb > 1 else 1
        n_mesh = 1
        if mesh is not None:
            n_mesh = int(np.prod(list(mesh.shape.values())))
            B = -(-B // n_mesh) * n_mesh  # shard evenly over the mesh
        K = bucket
        sel_sizes = sizes[probs]
        total = int(sel_sizes.sum())
        prob_of_row = np.repeat(np.arange(nb), sel_sizes)
        row_pos = np.arange(total) - np.repeat(np.cumsum(sel_sizes) - sel_sizes, sel_sizes)
        src = order[np.repeat(starts[probs], sel_sizes) + row_pos]
        dest = prob_of_row * K + row_pos

        arrs = {}
        for bf, gf in _FIELD_MAP.items():
            a = np.zeros(B * K, dtype=dtype)
            if bf in ("v_rr", "w_rr"):
                a[:] = 1.0  # padding: avoid div-by-zero; masked anyway
            a[dest] = f[gf][src]
            arrs[bf] = a.reshape(B, K)
        for bf, gf in (("v_dir", "v_dir"), ("w_dir", "w_dir")):
            a = np.zeros(B * K, dtype=bool)
            a[dest] = f[gf][src]
            arrs[bf] = a.reshape(B, K)
        valid = np.zeros(B * K, dtype=bool)
        valid[dest] = True
        arrs["valid"] = valid.reshape(B, K)

        batch = {k2: jnp.asarray(v2) for k2, v2 in arrs.items()}
        cls_dir = np.zeros(B, dtype=bool)
        cls_dir[:nb] = prob_dir[probs]
        batch["cls_dir"] = jnp.asarray(cls_dir)
        if mesh is not None and n_mesh > 1:
            from muchsalsa_tpu.parallel.sharded import sharded_chain_dp

            scores_dev, bps_dev, _stats = sharded_chain_dp(
                batch, int(wiggle_room), mesh, axis=mesh.axis_names[0])
        else:
            scores_dev, bps_dev = chain_dp_batch(batch, int(wiggle_room))
        scores_np = np.asarray(scores_dev)
        bps_np = np.asarray(bps_dev)

        for i, p in enumerate(probs):
            n = int(sizes[p])
            srows = [int(x) for x in local_idx[starts[p] : ends[p]]]
            paths, scores = _reconstruct(scores_np[i], bps_np[i], n)
            results[(int(prob_edge[p]), bool(prob_dir[p]))] = finalize_paths(
                ctx_of(int(prob_edge[p])), srows, paths, scores, bool(prob_dir[p])
            )

    for p in host_probs:
        edge_idx = int(prob_edge[p])
        direction = bool(prob_dir[p])
        ctx = ctx_of(edge_idx)
        rows = np.array(
            [r for r in range(len(ctx.illu_ids)) if bool(ctx.em_dir[r]) == direction]
        )
        results[(edge_idx, direction)] = max_pairwise_paths(ctx, rows, direction, wiggle_room)

    edge_list = graph.edges()

    # merge per edge exactly like chainingAndOverlaps (main.cpp:328-414)
    for edge in edge_list:
        ctx = ctx_of(edge.em_idx)
        minus_paths = results.get((edge.em_idx, False), [])
        plus_paths = results.get((edge.em_idx, True), [])

        has_primary = any(p.primary for p in plus_paths) or any(
            p.primary for p in minus_paths
        )
        if has_primary:
            plus_paths = [p for p in plus_paths if p.primary]
            minus_paths = [p for p in minus_paths if p.primary]
        has_multi = any(len(p.ids) > 1 for p in plus_paths) or any(
            len(p.ids) > 1 for p in minus_paths
        )
        if has_multi:
            plus_paths = [p for p in plus_paths if len(p.ids) > 1]
            minus_paths = [p for p in minus_paths if len(p.ids) > 1]

        if len(plus_paths) + len(minus_paths) > 1:
            edge.shadow = True
        else:
            path = minus_paths[0] if minus_paths else plus_paths[0]
            edge.shadow = not path.primary

        for p in minus_paths:
            o = get_overlap(ctx, p.ids, False, p.score, p.primary)
            if o is not None:
                edge.orders.append(o)
        for p in plus_paths:
            o = get_overlap(ctx, p.ids, True, p.score, p.primary)
            if o is not None:
                edge.orders.append(o)


def _reconstruct(
    scores: np.ndarray, bps: np.ndarray, n: int
) -> tuple[list[list[int]], list[float]]:
    """Rebuild the reference's population paths from DP backpointers."""
    paths: list[list[int]] = []
    for i in range(n):
        chain = []
        j = i
        while j >= 0:
            chain.append(j)
            j = int(bps[j])
        chain.reverse()
        paths.append(chain)
    return paths, [float(s) for s in scores[:n]]
