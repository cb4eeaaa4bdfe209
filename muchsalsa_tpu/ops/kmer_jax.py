"""Canonical k-mer counting on the device (XLA).

Device twin of ``pipeline.kmer.count_kmers`` (jellyfish-count
equivalent — reference ``pipeline/pipeline.sh:142-148``): canonical
2k-bit k-mer packing split across two uint32 lanes, one global
two-key sort per read chunk, and run-length counts via the reverse
segmented scan.  Chunks merge on the host (sorted-run combine), so
results are exactly ``count_kmers``'s ``(sorted unique uint64 values,
counts)`` for any chunking.

Economics: the device sort is memory-bandwidth bound, against the
host's comparison sort; the transfer of (value, count) runs back to the
host is the cost that can eat the win.  Auto placement in
``pipeline.full`` runs this whenever an accelerator is attached;
``device_kmer`` forces either path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_U32_MAX = jnp.uint32(0xFFFFFFFF)


@partial(jax.jit, static_argnames=("k",))
def kmer_hi_lo_batch(codes: jnp.ndarray, lens: jnp.ndarray, k: int):
    """Canonical k-mer values of a padded read batch, as (hi, lo)
    uint32 pairs of the 2k-bit packing (k <= 31).

    ``codes``: (R, L) uint8/int32, pad = 4.  Returns (hi, lo, valid)
    of shape (R, L - k + 1) matching ``pipeline.kmer.kmer_values64``
    bit-for-bit (hi = value >> 32, lo = value & 0xFFFFFFFF).
    """
    assert k <= 31
    R, L = codes.shape
    Lk = L - k + 1
    c = codes.astype(jnp.uint32)

    f_hi = jnp.zeros((R, Lk), jnp.uint32)
    f_lo = jnp.zeros((R, Lk), jnp.uint32)
    r_hi = jnp.zeros((R, Lk), jnp.uint32)
    r_lo = jnp.zeros((R, Lk), jnp.uint32)
    bad = jnp.zeros((R, Lk), jnp.int32)
    for j in range(k):
        col = jax.lax.dynamic_slice_in_dim(c, j, Lk, axis=1)
        base = col & 3
        comp = (jnp.uint32(3) - col) & 3
        f_hi = (f_hi << 2) | (f_lo >> 30)
        f_lo = (f_lo << 2) | base
        if 2 * j < 32:
            r_lo = r_lo | (comp << jnp.uint32(2 * j))
        else:
            r_hi = r_hi | (comp << jnp.uint32(2 * j - 32))
        bad = bad + (col >= 4).astype(jnp.int32)

    pos = jnp.arange(Lk)[None, :]
    valid = (bad == 0) & (pos + k <= lens[:, None])

    r_lt = (r_hi < f_hi) | ((r_hi == f_hi) & (r_lo < f_lo))
    hi = jnp.where(r_lt, r_hi, f_hi)
    lo = jnp.where(r_lt, r_lo, f_lo)
    return hi, lo, valid


@jax.jit
def sort_count_chunk(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray):
    """Globally sort one chunk's canonical k-mers and attach run-length
    counts at run starts.

    Returns (hi_sorted, lo_sorted, counts, starts, n_valid): flat (N,)
    arrays where ``starts[i]`` marks the first slot of each distinct
    value (padding sorts to the end as (0xFFFFFFFF, 0xFFFFFFFF) and is
    excluded via ``n_valid``).
    """
    hi = jnp.where(valid, hi, _U32_MAX).reshape(-1)
    lo = jnp.where(valid, lo, _U32_MAX).reshape(-1)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    hi_s, lo_s = jax.lax.sort((hi, lo), dimension=0, num_keys=2)

    first = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1]),
    ])
    # run lengths via one scatter reduction (a flat associative_scan
    # unrolls into ~23 wide slice steps whose server-side compile cost
    # explodes — same fix as ops/mapping_jax._anchors_to_hits)
    run_id = jnp.cumsum(first.astype(jnp.int32)) - 1
    N = hi_s.shape[0]
    counts = jax.ops.segment_sum(
        jnp.ones_like(run_id), run_id, num_segments=N)[run_id]
    return hi_s, lo_s, counts, first, n_valid


def count_kmers_device(
    seqs, k: int, chunk_bases: int = 8 << 20, row_len: int = 1 << 14
) -> tuple[np.ndarray, np.ndarray]:
    """Device-backed ``count_kmers``: identical (sorted unique uint64,
    counts) output; sequences stream through fixed-shape (rows,
    row_len) chunks with ``k-1`` overlap between row fragments so no
    boundary k-mer is lost or duplicated."""
    from muchsalsa_tpu.utils.seq import encode_2bit

    rows_per_chunk = max(1, chunk_bases // row_len)
    step = row_len - (k - 1)

    uniq_chunks: list[np.ndarray] = []
    count_chunks: list[np.ndarray] = []
    buf = np.full((rows_per_chunk, row_len), 4, dtype=np.uint8)
    lens = np.zeros(rows_per_chunk, dtype=np.int32)
    row = 0

    def flush():
        nonlocal row
        if row == 0:
            return
        # always ship the full (rows_per_chunk, row_len) buffer: unused
        # rows have len 0 (no valid k-mers), and a partial last chunk
        # would otherwise compile a fresh shape per distinct row count
        hi, lo, valid = kmer_hi_lo_batch(
            jnp.asarray(buf), jnp.asarray(lens), k)
        hi_s, lo_s, counts, first, n_valid = sort_count_chunk(hi, lo, valid)
        n = int(n_valid)
        hi_n = np.asarray(hi_s[:n], dtype=np.uint64)
        lo_n = np.asarray(lo_s[:n], dtype=np.uint64)
        first_n = np.asarray(first[:n])
        vals = (hi_n << np.uint64(32)) | lo_n
        uniq_chunks.append(vals[first_n])
        count_chunks.append(np.asarray(counts[:n])[first_n].astype(np.int64))
        buf.fill(4)
        lens.fill(0)
        row = 0

    for seq in seqs:
        c = encode_2bit(seq)
        # split long sequences into overlapping row fragments
        for s in range(0, max(len(c) - k + 1, 1), step):
            frag = c[s : s + row_len]
            if len(frag) < k:
                continue
            buf[row, : len(frag)] = frag
            lens[row] = len(frag)
            row += 1
            if row == rows_per_chunk:
                flush()
    flush()

    if not uniq_chunks:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    vals = np.concatenate(uniq_chunks)
    counts = np.concatenate(count_chunks)
    order = np.argsort(vals, kind="stable")
    vals = vals[order]
    counts = counts[order]
    first = np.ones(len(vals), dtype=bool)
    first[1:] = vals[1:] != vals[:-1]
    starts = np.nonzero(first)[0]
    merged = np.add.reduceat(counts, starts)
    return vals[starts], merged.astype(np.int64)
