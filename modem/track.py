"""Channel tracking: Theil-Sen SFO/CFO regression and SNR estimation.

Array-program equivalents of DSP::TheilSenEstimator (decode.cc:195,
488-494) and the per-row Es/N0 loop (decode.cc:505-523).  The reference
computes O(cols^2) pairwise slopes serially; here the slope matrix is
one broadcast subtraction and the median a sort — trivial work at
cols <= 512.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import cplx, psk


def _median_lower(v, count: int):
    """Element at index count//2 of the sorted first `count` entries
    (std::nth_element-style middle, matching the reference's estimator)."""
    return jnp.sort(v)[count // 2]


# Which Theil-Sen variant derotate_rows uses (read at trace time).
# "disjoint": O(n) pairs (i, i+n/2).  "all_pairs": the reference's
# full O(n^2) estimator (decode.cc:488-494).  The A/B at the -18..-22
# dB sensitivity edge and under deep multipath measured NO frame-level
# difference between them, so
# the 260x-smaller disjoint variant stays the default.
ESTIMATOR = "disjoint"


def theil_sen(x, y):
    """Robust line fit: median slope over disjoint pairs + median
    intercept (the O(n) Theil-Sen variant: pairs (i, i + n/2)).

    x, y: [cols].  Returns (slope, yint).  Robustness note: k outlier
    points corrupt up to k of the n/2 disjoint slopes (breakdown 25%)
    and ~kn of the all-pairs n(n-1)/2 slopes (breakdown ~29%, the
    higher of the two) — the all-pairs estimator is the more robust
    one in theory, but the measured frame-level difference at the
    decode sensitivity edge and under deep multipath is nil; see
    ESTIMATOR above.
    """
    cols = x.shape[-1]
    h = cols // 2
    slopes = (y[h: 2 * h] - y[:h]) / (x[h: 2 * h] - x[:h])
    slope = _median_lower(slopes, h)
    resid = y - slope * x
    yint = _median_lower(resid, cols)
    return slope, yint


def theil_sen_all_pairs(x, y):
    """All-pairs Theil-Sen: the reference's exact estimator
    (DSP::TheilSenEstimator<value,512>, decode.cc:488-494) — median
    over all n(n-1)/2 pairwise slopes, intercept as median residual.

    One broadcast subtraction + one sort of cols^2 values (~262k f32
    at cols=512): trivial work and a small graph.
    """
    cols = x.shape[-1]
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    iu = jnp.triu(jnp.ones((cols, cols), jnp.bool_), k=1)
    slopes = jnp.where(iu, dy / jnp.where(iu, dx, 1.0), jnp.inf)
    count = cols * (cols - 1) // 2
    slope = jnp.sort(slopes.reshape(-1))[count // 2]
    resid = y - slope * x
    yint = _median_lower(resid, cols)
    return slope, yint


def derotate_rows(cons, code_off: int, mod_bits: int,
                  estimator: str | None = None):
    """Per-row Theil-Sen phase regression and derotation
    (decode.cc:479-504).

    cons: [rows, cols, 2] differential constellation points.
    ``estimator``: "disjoint" | "all_pairs"; None uses the module
    default ESTIMATOR.  Pipelines thread their constructor's choice
    through here at TRACE time — flipping the module global after a
    pipeline has jitted its payload graph has no effect on it.
    Returns (derotated cons, avg_slope, avg_yint).
    """
    rows, cols, _ = cons.shape
    x = (jnp.arange(cols) + code_off).astype(jnp.float32)

    hard = psk.mod_hard(mod_bits, cons)
    ref = psk.mod_map(mod_bits, hard)
    # phase error of each point vs its hard decision
    err = jnp.arctan2(
        cons[..., 1] * ref[..., 0] - cons[..., 0] * ref[..., 1],
        cons[..., 0] * ref[..., 0] + cons[..., 1] * ref[..., 1])

    choice = ESTIMATOR if estimator is None else estimator
    est = theil_sen_all_pairs if choice == "all_pairs" else theil_sen

    def fit(row_err):
        return est(x, row_err)

    slopes, yints = jax.vmap(fit)(err)
    theta = -(slopes[:, None] * x[None, :] + yints[:, None])
    rot = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    out = cplx.cmul(cons, rot)
    return out, jnp.mean(slopes), jnp.mean(yints)


def soft_llrs(cons, mod_bits: int):
    """Cumulative-SNR soft demap (decode.cc:505-523).

    The reference accumulates signal/noise power ACROSS rows (sp, np are
    never reset), so row r uses precision = sum(sp[0..r])/sum(np[0..r]).
    Returns (llrs [rows, cols, mod_bits], snr_per_row [rows]).
    """
    hard = psk.mod_hard(mod_bits, cons)
    ref = psk.mod_map(mod_bits, hard)
    err = cons - ref
    sp = jnp.cumsum(jnp.sum(ref[..., 0]**2 + ref[..., 1]**2, axis=1))
    npow = jnp.cumsum(jnp.sum(err[..., 0]**2 + err[..., 1]**2, axis=1))
    precision = sp / jnp.maximum(npow, 1e-12)
    llrs = psk.mod_soft(mod_bits, cons, precision[:, None])
    return llrs, 10.0 * jnp.log10(precision)
