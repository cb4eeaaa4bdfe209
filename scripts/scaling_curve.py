"""Mesh-scaling curve: sharded mapping + chaining throughput and output
equality at 1/2/4/8 devices.

The BASELINE.json north star asks for >=80% scaling efficiency at 4
hosts; real multi-chip hardware is not attached here, so this records
the mesh-proxy curve the blueprint allows (SURVEY.md §4 "multi-node
testing"): the same sharded entry points the production driver uses,
over a virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count)
or over real chips when present.  On virtual devices the *timing* shares
2 physical cores and mostly measures partitioning overhead — the
meaningful rows are output-equality at every width plus the collective
structure compiling and executing; on a real slice the same script
produces the true curve.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python scripts/scaling_curve.py [widths=1,2,4,8]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main() -> None:
    widths = [int(x) for x in (sys.argv[1].split(",") if len(sys.argv) > 1
                               else ("1", "2", "4", "8"))]

    from muchsalsa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from muchsalsa_tpu.ops.mapping_jax import build_device_tables
    from muchsalsa_tpu.parallel.mesh import make_mesh
    from muchsalsa_tpu.parallel.sharded import (
        sharded_chain_dp, sharded_map_reads_v2_packed)
    from muchsalsa_tpu.ops.mapping_jax import pack_codes
    from __graft_entry__ import _example_batch

    devices = jax.devices()
    assert len(devices) >= max(widths), (
        f"need {max(widths)} devices, have {len(devices)}")
    print(f"[scaling] backend={devices[0].platform} n_devices={len(devices)}",
          file=sys.stderr)

    # --- workloads (shapes divisible by every width) ---
    rng = np.random.default_rng(0)
    R, L = 256, 8192
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = jnp.asarray(np.full(R, L, dtype=np.int32))
    packed_np, nmask_np = pack_codes(codes)
    E = 1 << 18
    hashes = np.unique(np.sort(rng.integers(0, 1 << 32, E, dtype=np.uint32)))
    H = len(hashes)
    tables, hash_takes = build_device_tables(
        hashes, np.arange(H + 1, dtype=np.int64),
        rng.integers(0, 5000, H).astype(np.int32),
        rng.integers(0, 1000, H).astype(np.int32),
        rng.random(H) < 0.5,
    )
    map_kw = dict(k=15, w=5, bandwidth=2000, min_anchor_count=3,
                  min_chain_score=100, max_pos=512, max_per_hit=4,
                  hash_takes=hash_takes)

    dtype = np.float64 if jax.config.read("jax_enable_x64") else np.float32
    chain_batch = _example_batch(1024, 64, dtype)

    results = {"backend": devices[0].platform, "rows": []}
    ref_map = None
    ref_chain = None
    for w in widths:
        mesh = make_mesh(w)
        # mapping
        t0 = time.perf_counter()
        out, _ = sharded_map_reads_v2_packed(
            jnp.asarray(packed_np), jnp.asarray(nmask_np), lens, tables,
            mesh, **map_kw)
        out = {k: np.asarray(v) for k, v in out.items()}
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out2, _ = sharded_map_reads_v2_packed(
                jnp.asarray(packed_np), jnp.asarray(nmask_np), lens, tables,
                mesh, **map_kw)
            _ = np.asarray(out2["n_hits"])
        t_map = (time.perf_counter() - t0) / reps
        if ref_map is None:
            ref_map = out
        else:
            for k in ref_map:
                np.testing.assert_array_equal(ref_map[k], out[k], err_msg=k)

        # chaining
        t0 = time.perf_counter()
        s, b, st = sharded_chain_dp(chain_batch, 300, mesh)
        s = np.asarray(s)
        t0 = time.perf_counter()
        for _ in range(reps):
            s2, b2, _ = sharded_chain_dp(chain_batch, 300, mesh)
            s2 = np.asarray(s2)
        t_chain = (time.perf_counter() - t0) / reps
        if ref_chain is None:
            ref_chain = (s, np.asarray(b))
        else:
            np.testing.assert_array_equal(ref_chain[0], s2)
            np.testing.assert_array_equal(ref_chain[1], np.asarray(b2))

        row = {"devices": w,
               "map_reads_per_s": round(R / t_map, 1),
               "map_cold_s": round(t_cold, 2),
               "chain_problems_per_s": round(1024 / t_chain, 1),
               "equal_to_width1": True}
        results["rows"].append(row)
        print(f"[scaling] {row}", file=sys.stderr)

    base = results["rows"][0]
    for row in results["rows"]:
        wdt = row["devices"]
        row["map_scaling_eff_pct"] = round(
            100.0 * row["map_reads_per_s"] / (base["map_reads_per_s"] * wdt), 1)
        row["chain_scaling_eff_pct"] = round(
            100.0 * row["chain_problems_per_s"]
            / (base["chain_problems_per_s"] * wdt), 1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
