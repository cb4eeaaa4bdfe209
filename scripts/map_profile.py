"""Per-stage warm-exec profile of the device mapping path.

Times each production jit (sketch | selcompact | probe | compact |
expand | tail) and the fused ``map_reads_device_v2`` at a given shape:
ITERS warm calls, synchronised with ``block_until_ready``, best of 3.

Usage: python scripts/map_profile.py [max_pos=2048] [max_per_hit=4] [R=256] [L=10240]
"""

from __future__ import annotations

import sys
import time

import numpy as np

ITERS = 10


def timed(name, fn, *args, **kw):
    import jax

    out = jax.block_until_ready(fn(*args, **kw))  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            last = fn(*args, **kw)
        jax.block_until_ready(last)
        best = min(best, (time.perf_counter() - t0) / ITERS)
    print(f"[profile] {name}: {best*1e3:.3f} ms", flush=True)
    return out, best


def main() -> None:
    max_pos = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    max_per_hit = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    R = int(sys.argv[3]) if len(sys.argv) > 3 else 256

    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from muchsalsa_tpu.ops.mapping_jax import (
        anchors_to_hits_device_packed, build_device_tables,
        compact_candidates_device_v2, expand_anchors_device_v2,
        map_reads_device_v2, pack_codes, probe_candidates_device_v2,
        select_compact_device_v2, sketch_device_packed)

    print(f"[profile] devices: {jax.devices()} max_pos={max_pos} "
          f"max_per_hit={max_per_hit} R={R}", flush=True)

    rng = np.random.default_rng(0)
    # the production length bucket for ~9 kb reads (quarter-step
    # buckets), with the production per-bucket budgets unless
    # overridden on the command line
    L = int(sys.argv[4]) if len(sys.argv) > 4 else 10_240
    from muchsalsa_tpu.pipeline.mapper import device_bucket_budgets

    max_sel, pos_L, trim_L = device_bucket_budgets(L, 15, max_pos, max_per_hit)
    max_pos = pos_L
    print(f"[profile] bucket budgets: L={L} max_sel={max_sel} "
          f"max_pos={max_pos} trim={trim_L}", flush=True)
    codes_np = rng.integers(0, 4, (R, L)).astype(np.uint8)
    codes = jnp.asarray(codes_np)
    lens = jnp.asarray(np.full(R, L, dtype=np.int32))
    E = 1 << 20
    hashes = np.unique(np.sort(rng.integers(0, 1 << 32, E, dtype=np.uint32)))
    H = len(hashes)
    tables, hash_takes = build_device_tables(
        hashes, np.arange(H + 1, dtype=np.int64),
        rng.integers(0, 5000, H).astype(np.int32),
        rng.integers(0, 1000, H).astype(np.int32),
        rng.random(H) < 0.5,
    )
    packed_np, nmask_np = pack_codes(codes_np)
    packed = jnp.asarray(packed_np)
    nmask = jnp.asarray(nmask_np)

    total = 0.0
    (sk, dt) = timed("sketch", sketch_device_packed, packed, nmask, lens)
    total += dt
    selected, h, strand = sk
    (sc, dt) = timed("selcompact", select_compact_device_v2, selected, h,
                     strand, max_sel=max_sel)
    total += dt
    skey, h_s, n_sel = sc
    (pr, dt) = timed("probe", probe_candidates_device_v2, skey, h_s,
                     tables.rp)
    total += dt
    rpv, cand = pr
    (sel, dt) = timed(
        "compact", compact_candidates_device_v2, skey, h_s, rpv, cand,
        n_sel, max_pos=max_pos)
    total += dt
    (anchors, dt) = timed(
        "expand", expand_anchors_device_v2, *sel, tables.jrows, tables.erows,
        max_per_hit=max_per_hit, hash_takes=hash_takes)
    total += dt
    (_, dt) = timed(
        "tail", anchors_to_hits_device_packed, *anchors,
        trim=trim_L, per_hit_cap=max_per_hit)
    total += dt
    print(f"[profile] 6-stage total: {total*1e3:.1f} ms "
          f"({R/total:.0f} reads/s)", flush=True)

    (_, dt) = timed(
        "fused v2", map_reads_device_v2, codes, lens, tables.rp,
        tables.jrows, tables.erows, hash_takes=hash_takes,
        max_sel=max_sel, max_pos=max_pos, max_per_hit=max_per_hit,
        trim=trim_L)
    print(f"[profile] fused v2: {R/dt:.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()
