"""Ordered-statistics decoding of the header code, as batched matmuls.

Array-program equivalent of CODE::OrderedStatisticsDecoder<255,71,4>
(decode.cc:199,417).  The reference enumerates ~971k error patterns of
weight <= 4 serially; here the whole enumeration is reshaped into one
matmul:

  * Sort the 255 soft values by reliability; Gaussian-eliminate the
    generator matrix over GF(2) to a basis systematic in the 71 most
    reliable independent positions (vectorised column scan, 255 steps).
  * Every weight<=4 flip pattern over the basis bits is the XOR of two
    "half patterns" A, B each of weight<=2.  With U = [0; singles; pairs]
    the codeword-domain flip rows ([2557, 255]) and t the signed soft
    vector of the base codeword, the correlation discrepancy of A xor B is
      D(A xor B) = D(A) + D(B) - 2 * (U_A * U_B) . t,
    so ALL candidate scores are one [2557,255] x [255,2557] matmul.
  * Duplicate representations are masked to a canonical split so the
    minimum is unique per codeword; the decoder reports uniqueness of the
    best score like the reference's `unique` flag.

Soft inputs are int8-quantised (decode.cc:412-416), so scores are exact
integers in f32 and ties are meaningful.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import bch


@functools.cache
def _pattern_support(k: int = bch.K):
    """Support indices of the half-patterns: 1 empty + k singles + pairs."""
    singles = [(i,) for i in range(k)]
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    pats = [()] + singles + pairs
    # [P, 2] support, -1 padded; and weight per pattern
    sup = np.full((len(pats), 2), -1, dtype=np.int32)
    for p, s in enumerate(pats):
        sup[p, : len(s)] = s
    weights = np.array([len(s) for s in pats], dtype=np.int32)
    return sup, weights


def _rref_gf2(mat, k: int):
    """Reduced row-echelon form of [k, n] GF(2) matrix via a column scan.

    Returns (reduced matrix, pivot column per row).  The scan visits the
    n columns most-reliable-first (caller pre-permutes), so the pivots
    are the k most reliable independent positions.
    """
    n = mat.shape[1]

    def step(state, col):
        m, rank, pivots = state
        colv = m[:, col]
        rows = jnp.arange(k)
        cand = jnp.where((colv > 0) & (rows >= rank), rows, k)
        prow = jnp.min(cand)
        found = prow < k
        # Swap pivot row up to position `rank`.
        def do(mrp):
            m, rank, pivots = mrp
            pr = jnp.where(found, prow, rank)
            row_rank = m[rank]
            row_piv = m[pr]
            m = m.at[rank].set(row_piv).at[pr].set(row_rank)
            # Eliminate the column from every other row.
            colv2 = m[:, col]
            elim = colv2.at[rank].set(0)
            m = m ^ (elim[:, None] & m[rank][None, :])
            pivots = pivots.at[rank].set(col)
            return m, rank + 1, pivots
        state = jax.lax.cond(found & (rank < k), do,
                             lambda x: x, (m, rank, pivots))
        return state, None

    pivots0 = jnp.zeros(k, dtype=jnp.int32)
    (m, rank, pivots), _ = jax.lax.scan(
        step, (mat.astype(jnp.uint8), jnp.int32(0), pivots0),
        jnp.arange(n))
    return m, pivots


def _gf2_matmul(a, b):
    """(a @ b) mod 2 via f32 matmul (exact: sums < 2^24).

    HIGHEST: a GPU runs a default-precision f32 dot in TF32; 0/1
    operands would survive that, but the header decode should not rest
    on the argument."""
    prod = jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.mod(prod, 2.0).astype(jnp.uint8)


def osd_decode(soft, genmat: np.ndarray | None = None, order: int = 4):
    """Order-4 OSD of one received header block.

    Args:
      soft: [255] int8-valued soft bits, positive => bit 0.
      genmat: [71, 255] systematic generator matrix (default BCH(255,71)).

    Returns:
      (data_bits [71] uint8, unique bool) — decoded info bits and whether
      the best candidate is the unique minimiser.
    """
    if genmat is None:
        genmat = bch.generator_matrix()
    assert order == 4, "only the reference's order-4 search is implemented"
    k, n = genmat.shape
    soft = jnp.asarray(soft, dtype=jnp.float32)

    # Reliability-sort the columns (stable, most reliable first).
    reliab = -jnp.abs(soft)
    perm = jnp.argsort(reliab, stable=True)
    g_perm = jnp.asarray(genmat, dtype=jnp.uint8)[:, perm]
    soft_perm = soft[perm]
    hard = (soft_perm < 0).astype(jnp.uint8)

    # Basis systematic in the most reliable independent positions.
    g_red, pivots = _rref_gf2(g_perm, k)

    # Base codeword: re-encode the hard decisions at the basis positions.
    h_mrb = hard[pivots]
    c0 = _gf2_matmul(h_mrb[None, :], g_red)[0]

    # Signed discrepancy weights: flipping codeword bit i costs t_i.
    t = (1.0 - 2.0 * c0.astype(jnp.float32)) * soft_perm

    sup, weights = _pattern_support(k)
    sup = jnp.asarray(sup)
    weights = jnp.asarray(weights)
    p = sup.shape[0]

    # Codeword-domain flip rows for each half-pattern (XOR of <=2 basis
    # rows).  Rows with -1 support contribute zero.
    rows = jnp.where(sup[:, :, None] >= 0,
                     g_red[jnp.clip(sup, 0), :], 0).astype(jnp.uint8)
    u = rows[:, 0, :] ^ rows[:, 1, :]

    # HIGHEST for the same reason as _gf2_matmul (t is int8-valued)
    d_single = jnp.dot(u.astype(jnp.float32), t,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    v = u.astype(jnp.float32) * t[None, :]
    cross = jnp.dot(u.astype(jnp.float32), v.T,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    scores = d_single[:, None] + d_single[None, :] - 2.0 * cross

    # Canonical-split mask: every weight<=4 pattern counted exactly once.
    lo = jnp.where(sup[:, 0] >= 0, sup[:, 0], k + 1)
    hi = jnp.max(sup, axis=1)  # -1 for empty
    wa, wb = weights[:, None], weights[None, :]
    a_max, b_min = hi[:, None], lo[None, :]
    valid = (
        ((wa == 0) & (wb <= 2))            # weight 0..2: empty (x) any
        | ((wa == 1) & (wb == 2))          # weight 3: single (x) pair
        | ((wa == 2) & (wb == 2))          # weight 4: pair (x) pair
    ) & (a_max < b_min)                    # disjoint + ordered split
    valid = valid | (jnp.arange(p)[:, None] == 0) & (jnp.arange(p)[None, :] == 0)

    big = jnp.float32(3.4e38)
    masked = jnp.where(valid, scores, big)
    flat = masked.reshape(-1)
    best = jnp.argmin(flat)
    best_score = flat[best]
    unique = jnp.sum(flat == best_score) == 1
    a, b = best // p, best % p

    c_best = c0 ^ u[a] ^ u[b]
    # Undo the reliability permutation and return the systematic prefix.
    inv = jnp.zeros(n, dtype=jnp.int32).at[perm].set(jnp.arange(n))
    codeword = c_best[inv]
    return codeword[:k], unique
