"""Banded edit-distance: batched wavefront DP for the device.

This is a capability the reference *lacks* natively — it delegates all
base-level alignment to external minimap2 (``pipeline/pipeline.sh:175``,
``-c --eqx``) and to coordinate arithmetic in consensus.  This module
provides an on-device banded edit-distance kernel as an XLA formulation.

Formulation (vector-friendly: no intra-row dependency):
with D the (m+1, n+1) Levenshtein matrix and rows swept i = 1..m over a
static band of diagonals k = j - i in [klo, klo + B), the in-row
left-neighbor chain D[i][j-1] + 1 collapses into a *min-plus prefix
scan*:

    cand[k] = min(D[i-1][i+k-1] + cost, D[i-1][i+k] + 1)   (diag, up)
    D[i][i+k] = k + cummin_{l<=k}(cand[l] - l)

so each row is O(B) vector ops plus an associative scan — regular,
gather-free (the target window is a contiguous dynamic slice), and
batchable with vmap.  Work per problem: O(m*B) band cells.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

INF = np.int32(1 << 20)


def edit_distance_np(q: bytes, t: bytes) -> int:
    """Full O(mn) Levenshtein oracle (tests only)."""
    m, n = len(q), len(t)
    prev = np.arange(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        qc = q[i - 1]
        for j in range(1, n + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (0 if qc == t[j - 1] else 1),
            )
        prev = cur
    return int(prev[n])


@partial(jax.jit, static_argnames=("band", "max_m"))
def banded_edit_distance(
    q_codes: jnp.ndarray,   # (P, M) uint8, pad = 5
    q_lens: jnp.ndarray,    # (P,) int32
    t_codes: jnp.ndarray,   # (P, N) uint8, pad = 4
    t_lens: jnp.ndarray,    # (P,) int32
    band: int = 128,
    max_m: int | None = None,
):
    """Batched banded Levenshtein distance.

    Returns (P,) int32 distances; -1 where ``|n - m| >= band`` (endpoint
    falls outside the band) or inputs are empty.
    """
    P, M = q_codes.shape
    N = t_codes.shape[1]
    B = band
    rows = max_m if max_m is not None else M

    # pad targets so every band window is a valid slice
    t_pad = jnp.concatenate(
        [
            jnp.full((P, B), 4, dtype=t_codes.dtype),
            t_codes,
            jnp.full((P, B + rows), 4, dtype=t_codes.dtype),
        ],
        axis=1,
    )

    karange = jnp.arange(B, dtype=jnp.int32)

    def one(q, t, m, n):
        diff = n - m
        slack = (B - 1 - jnp.abs(diff)) // 2
        klo = jnp.minimum(0, diff) - slack

        k = klo + karange
        R0 = jnp.where((k >= 0) & (k <= n), k, INF).astype(jnp.int32)

        def row(i, R):
            j = i + k                      # (B,) target columns this row
            qc = q[i - 1]
            twin = jax.lax.dynamic_slice(t, (i - 1 + klo + B,), (B,))
            cost = jnp.where(qc == twin, 0, 1).astype(jnp.int32)

            diag = R + cost
            up = jnp.concatenate([R[1:], jnp.array([INF], jnp.int32)]) + 1
            cand = jnp.minimum(diag, up)
            cand = jnp.where(j == 0, i, cand)
            cand = jnp.where((j >= 0) & (j <= n), cand, INF)

            x = cand - karange
            x = jax.lax.associative_scan(jnp.minimum, x)
            Rn = jnp.minimum(x + karange, INF)
            Rn = jnp.where((j >= 0) & (j <= n), Rn, INF)
            return jnp.where(i <= m, Rn, R)

        R = jax.lax.fori_loop(1, rows + 1, row, R0)
        out = R[jnp.clip(diff - klo, 0, B - 1)]
        ok = (jnp.abs(diff) < B) & (m > 0) & (n > 0) & (m <= rows)
        return jnp.where(ok, out, -1)

    return jax.vmap(one)(q_codes, t_pad, q_lens.astype(jnp.int32), t_lens.astype(jnp.int32))


def pack_problems(pairs: list[tuple[bytes, bytes]], band: int = 128):
    """Encode (query, target) byte pairs into padded code arrays."""
    from muchsalsa_tpu.utils.seq import encode_2bit

    M = max((len(q) for q, _ in pairs), default=1)
    N = max((len(t) for _, t in pairs), default=1)
    P = len(pairs)
    q_codes = np.full((P, M), 5, dtype=np.uint8)
    t_codes = np.full((P, N), 4, dtype=np.uint8)
    q_lens = np.zeros(P, dtype=np.int32)
    t_lens = np.zeros(P, dtype=np.int32)
    for i, (q, t) in enumerate(pairs):
        q_codes[i, : len(q)] = encode_2bit(q)
        t_codes[i, : len(t)] = encode_2bit(t)
        q_lens[i] = len(q)
        t_lens[i] = len(t)
    return (
        jnp.asarray(q_codes),
        jnp.asarray(q_lens),
        jnp.asarray(t_codes),
        jnp.asarray(t_lens),
    )
