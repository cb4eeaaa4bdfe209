"""Sharded (multi-chip) compute steps via shard_map.

Replaces the reference's job fan-outs with SPMD over a device mesh:
chaining problems are data-parallel over the batch axis, and global
statistics (edge survival counts, score mass — the quantities the
reference accumulates under mutexes, e.g. ``main.cpp:180``) are merged
with ``psum`` collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from muchsalsa_tpu.ops.chaining_jax import chain_dp_batch


def sharded_chain_dp(batch: dict, wiggle_room: int, mesh: Mesh, axis: str = "reads"):
    """Run the chaining DP data-parallel over the mesh.

    ``batch`` arrays are (B, K) with B divisible by the mesh size.
    Returns (scores, backptrs, stats) where ``stats`` is the globally
    psum-merged [n_problems, total_best_score] pair — the cross-device
    reduction that replaces the reference's mutex-guarded accumulation.
    """
    in_spec = {k: P(axis) if v.ndim >= 1 else P() for k, v in batch.items()}

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(in_spec,),
        out_specs=(P(axis), P(axis), P()),
    )
    def step(local_batch):
        scores, bps = chain_dp_batch(local_batch, wiggle_room)
        best = jnp.max(jnp.where(local_batch["valid"], scores, 0.0), axis=1)
        local_stats = jnp.stack(
            [jnp.sum(jnp.any(local_batch["valid"], axis=1)).astype(best.dtype), jnp.sum(best)]
        )
        stats = jax.lax.psum(local_stats, axis)
        return scores, bps, stats

    return jax.jit(step)(batch)


def sharded_anchor_counts(
    codes,
    lens,
    index_hashes,
    mesh: Mesh,
    k: int = 15,
    w: int = 5,
    axis: str = "reads",
):
    """Multi-device mapping lookup: reads shard over the mesh, the sorted
    unitig-minimizer index is replicated on every device (unitigs
    replicated, nanopore long reads streamed in data-parallel batches).

    Returns ((R,) per-read anchor counts, (2,) psum-merged
    [reads_with_anchors, total_anchors]).
    """
    from muchsalsa_tpu.ops.minimizer_jax import anchor_counts

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(axis), P()),
    )
    def step(local_codes, local_lens, index):
        counts = anchor_counts(local_codes, local_lens, index, k, w)
        stats = jnp.stack(
            [
                jnp.sum((counts > 0).astype(jnp.float32)),
                jnp.sum(counts.astype(jnp.float32)),
            ]
        )
        return counts, jax.lax.psum(stats, axis)

    return jax.jit(step)(codes, lens, index_hashes)


def sharded_map_reads(
    codes,
    lens,
    index_arrays: tuple,
    mesh: Mesh,
    axis: str = "reads",
    **kwargs,
):
    """Multi-chip FULL mapping (the minimap2-replacement stage): reads
    shard over the mesh, the unitig index (hashes/offsets/entries) is
    replicated on every chip.  Returns the per-read hit tables of
    :func:`ops.mapping_jax.map_reads_device` plus a psum-merged
    [reads_with_hits, total_hits] stat pair."""
    from muchsalsa_tpu.ops.mapping_jax import map_reads_device

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)) + (P(),) * len(index_arrays),
        out_specs=({k: P(axis) for k in (
            "unitig", "strand", "qs", "qe", "ts", "te", "matches",
            "n_anchors", "n_hits", "overflow")}, P()),
    )
    def step(local_codes, local_lens, *index):
        out = map_reads_device(local_codes, local_lens, *index, **kwargs)
        stats = jnp.stack(
            [
                jnp.sum((out["n_hits"] > 0).astype(jnp.float32)),
                jnp.sum(out["n_hits"].astype(jnp.float32)),
            ]
        )
        return out, jax.lax.psum(stats, axis)

    return jax.jit(step)(codes, lens, *index_arrays)


def sharded_map_reads_v2(
    codes,
    lens,
    tables,
    mesh: Mesh,
    axis: str = "reads",
    **kwargs,
):
    """Multi-chip FULL mapping over the packed v2 join tables
    (:func:`ops.mapping_jax.map_reads_device_v2`): reads shard over the
    mesh, the packed tables are replicated — no cross-device traffic in
    the hot loop (the collective only carries the psum'd stat pair)."""
    from muchsalsa_tpu.ops.mapping_jax import map_reads_device_v2

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=({k: P(axis) for k in (
            "unitig", "strand", "qs", "qe", "ts", "te", "matches",
            "n_anchors", "n_hits", "overflow")}, P()),
    )
    def step(local_codes, local_lens, rp, jrows, erows):
        out = map_reads_device_v2(local_codes, local_lens, rp, jrows, erows,
                                  **kwargs)
        stats = jnp.stack(
            [
                jnp.sum((out["n_hits"] > 0).astype(jnp.float32)),
                jnp.sum(out["n_hits"].astype(jnp.float32)),
            ]
        )
        return out, jax.lax.psum(stats, axis)

    return jax.jit(step)(codes, lens, tables.rp, tables.jrows, tables.erows)


def sharded_map_reads_v2_packed(
    packed,
    nmask,
    lens,
    tables,
    mesh: Mesh,
    axis: str = "reads",
    **kwargs,
):
    """:func:`sharded_map_reads_v2` over 2-bit packed read codes
    (``ops.mapping_jax.pack_codes``): the 2-bit words shard over the
    mesh like the codes they encode; unpack runs per-shard on device."""
    from muchsalsa_tpu.ops.mapping_jax import map_reads_device_v2, unpack_codes

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
        out_specs=({k: P(axis) for k in (
            "unitig", "strand", "qs", "qe", "ts", "te", "matches",
            "n_anchors", "n_hits", "overflow")}, P()),
    )
    def step(local_packed, local_nmask, local_lens, rp, jrows, erows):
        out = map_reads_device_v2(
            unpack_codes(local_packed, local_nmask), local_lens,
            rp, jrows, erows, **kwargs)
        stats = jnp.stack(
            [
                jnp.sum((out["n_hits"] > 0).astype(jnp.float32)),
                jnp.sum(out["n_hits"].astype(jnp.float32)),
            ]
        )
        return out, jax.lax.psum(stats, axis)

    return jax.jit(step)(
        packed, nmask, lens, tables.rp, tables.jrows, tables.erows)


def sharded_myers(
    q_codes, q_lens, t_codes, t_lens, mesh: Mesh, axis: str = "reads"
):
    """Data-parallel exact edit distance over the mesh: alignment
    problems shard over devices; global edit-mass psum-merged."""
    from muchsalsa_tpu.ops.myers_jax import myers_edit_distance

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P()),
    )
    def step(q, ql, t, tl):
        d = myers_edit_distance(q, ql, t, tl)
        total = jax.lax.psum(jnp.sum(d).astype(jnp.float32), axis)
        return d, total

    return jax.jit(step)(q_codes, q_lens, t_codes, t_lens)
