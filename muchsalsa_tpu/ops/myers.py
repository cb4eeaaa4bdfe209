"""Myers bit-parallel edit distance — prototypes and the batched
word-sliced formulation.

The wavefront kernel (``ops.align``) spends ~20
lane-ops per DP cell; Myers' bit-vector algorithm (Myers, JACM 1999)
packs 32 cells per machine word, and its only cross-word interactions
(the addition carry and the horizontal delta chain) vectorise as short
scans.  This module builds the algorithm in three stages:

1. :func:`myers_bigint` — reference implementation over Python
   arbitrary-precision ints (whole pattern in one bit-vector);
2. :func:`myers_words_np` — word-sliced numpy port: the pattern is
   split into 32-bit words (the future lane axis), the addition carry
   resolved with generate/propagate logic, and the per-column
   horizontal input of each word resolved by evaluating each word's
   block step for all three inputs {-1, 0, +1} and composing the
   resulting 3-state functions — both scans in lane-friendly form;
3. ``ops.myers_jax`` — the batched XLA/device version.

All stages are validated against the full-DP oracle.
"""

from __future__ import annotations

import numpy as np

W_BITS = 32
_WMASK = np.uint64(0xFFFFFFFF)


def myers_bigint(q: bytes, t: bytes) -> int:
    """Myers 1999 bit-vector edit distance, pattern as one big int."""
    m = len(q)
    n = len(t)
    if m == 0:
        return n
    if n == 0:
        return m

    peq = {c: 0 for c in set(q) | set(t)}
    for i, c in enumerate(q):
        peq[c] = peq.get(c, 0) | (1 << i)

    mask = (1 << m) - 1
    high = 1 << (m - 1)
    vp = mask
    vn = 0
    score = m

    for c in t:
        eq = peq.get(c, 0)
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq

        ph = vn | (~(xh | vp) & mask)
        mh = vp & xh

        if ph & high:
            score += 1
        elif mh & high:
            score -= 1

        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask

        vp = mh | (~(xv | ph) & mask)
        vn = ph & xv

    return score


# ---------------------------------------------------------------------------
# word-sliced formulation (numpy, single problem — the device blueprint)


def _block_step(vp, vn, eq, hin):
    """One 32-bit Myers block column step with horizontal input.

    ``vp/vn/eq`` uint64 holding 32-bit words (uint64 to see the add
    carry); ``hin`` in {-1, 0, +1}.  Returns (vp', vn', hout).
    Mirrors Edlib's ``calculateBlock``.
    """
    eq = np.uint64(eq)
    vp = np.uint64(vp)
    vn = np.uint64(vn)
    if hin < 0:
        eq |= np.uint64(1)

    xv = eq | vn
    xh = ((((eq & vp) + vp) & _WMASK) ^ vp) | eq

    ph = vn | (~(xh | vp) & _WMASK)
    mh = vp & xh

    hout = 0
    if ph & np.uint64(0x80000000):
        hout = 1
    elif mh & np.uint64(0x80000000):
        hout = -1

    ph = (ph << np.uint64(1)) & _WMASK
    mh = (mh << np.uint64(1)) & _WMASK
    if hin > 0:
        ph |= np.uint64(1)
    elif hin < 0:
        mh |= np.uint64(1)

    vp_out = mh | (~(xv | ph) & _WMASK)
    vn_out = ph & xv
    return vp_out, vn_out, hout


def myers_words_np(q: bytes, t: bytes) -> int:
    """Word-sliced Myers (sequential words; the vectorisation blueprint)."""
    m = len(q)
    n = len(t)
    if m == 0:
        return n
    if n == 0:
        return m

    n_words = (m + W_BITS - 1) // W_BITS

    # PEq[c][w]
    peq = np.zeros((256, n_words), dtype=np.uint64)
    for i, c in enumerate(q):
        peq[c, i // W_BITS] |= np.uint64(1) << np.uint64(i % W_BITS)

    vp = np.full(n_words, int(_WMASK), dtype=np.uint64)
    vn = np.zeros(n_words, dtype=np.uint64)

    last = n_words - 1
    last_bit = np.uint64((m - 1) % W_BITS)
    score = m

    for c in t:
        hin = 1  # row-0 boundary: D(0, j) = j
        for w in range(n_words):
            if w == last:
                # track the score at pattern row m-1: recompute hout at
                # the last valid bit rather than bit 31
                vp_w, vn_w, _ = _block_step(vp[w], vn[w], peq[c, w], hin)
                # re-derive ph/mh bit at last_bit
                eq = np.uint64(peq[c, w])
                if hin < 0:
                    eq |= np.uint64(1)
                xh = ((((eq & vp[w]) + vp[w]) & _WMASK) ^ vp[w]) | eq
                ph = vn[w] | (~(xh | vp[w]) & _WMASK)
                mh = vp[w] & xh
                if (ph >> last_bit) & np.uint64(1):
                    score += 1
                elif (mh >> last_bit) & np.uint64(1):
                    score -= 1
                vp[w], vn[w] = vp_w, vn_w
            else:
                vp[w], vn[w], hin = _block_step(vp[w], vn[w], peq[c, w], hin)

    return score


# ---------------------------------------------------------------------------
# banded (windowed-block) formulation — numpy prototype


def myers_banded_np(q: bytes, t: bytes, window_words: int = 8) -> int:
    """Banded Myers: only a sliding window of `window_words` 32-bit
    blocks is active per text column (Ukkonen band over diagonals
    k = j - i, like the wavefront kernel).  Returns the edit distance
    when the optimal path stays inside the band (an upper bound
    otherwise), or -1 when |n - m| exceeds the band.
    """
    m = len(q)
    n = len(t)
    if m == 0:
        return n
    if n == 0:
        return m

    WB = window_words
    band_rows = WB * W_BITS
    diff = n - m
    if abs(diff) >= band_rows - W_BITS:
        return -1
    slack = (band_rows - 1 - abs(diff)) // 2
    klo = min(0, diff) - slack             # k = j - i in [klo, khi]
    khi = klo + band_rows - 1

    n_words_full = (max(m, band_rows) + W_BITS - 1) // W_BITS + WB + 4

    peq = np.zeros((256, n_words_full), dtype=np.uint64)
    for i, c in enumerate(q):
        peq[c, i // W_BITS] |= np.uint64(1) << np.uint64(i % W_BITS)

    # window state: words [wb, wb + WB)
    vp = np.full(WB, int(_WMASK), dtype=np.uint64)
    vn = np.zeros(WB, dtype=np.uint64)
    wb = 0
    score = WB * W_BITS  # D(window bottom row + 1, col 0)

    for j in range(1, n + 1):
        # advance the window when the band top passes a word boundary
        target_wb = max(0, (j - khi)) // W_BITS
        while wb < target_wb:
            vp = np.concatenate([vp[1:], [np.uint64(int(_WMASK))]])
            vn = np.concatenate([vn[1:], [np.uint64(0)]])
            wb += 1
            score += W_BITS

        c = t[j - 1]
        hin = 1
        for wi in range(WB):
            w = wb + wi
            eq = peq[c, w] if w < n_words_full else np.uint64(0)
            if wi == WB - 1:
                # bottom block: hout updates the tracked bottom score
                vp_w, vn_w, hout = _block_step(vp[wi], vn[wi], eq, hin)
                score += hout
                vp[wi], vn[wi] = vp_w, vn_w
            else:
                vp[wi], vn[wi], hin = _block_step(vp[wi], vn[wi], eq, hin)

    # walk from the window bottom row up to pattern row m-1
    bottom_row = (wb + WB) * W_BITS - 1
    if bottom_row < m - 1:
        return -1  # band never reached the pattern end
    # subtract vertical deltas of rows (m-1, bottom]
    for r in range(bottom_row, m - 1, -1):
        wi = r // W_BITS - wb
        bit = np.uint64(r % W_BITS)
        if wi < 0:
            return -1
        if (vp[wi] >> bit) & np.uint64(1):
            score -= 1
        elif (vn[wi] >> bit) & np.uint64(1):
            score += 1
    return score
