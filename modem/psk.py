"""Vectorized PSK constellations: map / hard / soft / quantize.

Array-program equivalent of the header-only PhaseShiftKeying family
(reference: psk.hh:9-141).  Device functions operate on whole arrays in
split-complex form: ``bits`` has shape [..., BITS] in the +/-1 NRZ
domain, symbols are [..., 2] (re/im; see cplx.py).  All are
jit/vmap-safe.  Host (numpy, complex dtype) twins carry the _np suffix.

Layout quirks preserved from the reference:
  * QPSK is Gray (I = b0, Q = b1), scaled 1/sqrt(2) (psk.hh:84-87);
  * 8PSK uses the axis-swap layout: b1 signs I, b2 signs Q, b0 selects
    whether |I| = cos(pi/8) or sin(pi/8) (psk.hh:132-139) — not Gray;
  * soft bits scale by DIST * precision, with int8 saturation when
    quantizing to integral code types (psk.hh:28-29).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np

RCP_SQRT_2 = 0.70710678118654752440
COS_PI_8 = 0.92387953251128675613
SIN_PI_8 = 0.38268343236508977173

DIST = {1: 2.0, 2: 2.0 * RCP_SQRT_2, 3: 2.0 * SIN_PI_8}  # keyed by BITS


def _quantize(mod_bits: int, precision, value, int8: bool):
    value = value * (DIST[mod_bits] * precision)
    if int8:
        value = jnp.clip(jnp.round(value), -128, 127)
    return value


# ---------------------------------------------------------------------------
# map: +/-1 bit groups [..., BITS] -> split-complex symbols [..., 2]
# ---------------------------------------------------------------------------

def mod_map(mod_bits: int, bits):
    if mod_bits == 1:
        return jnp.stack([bits[..., 0], jnp.zeros_like(bits[..., 0])],
                         axis=-1)
    if mod_bits == 2:
        return RCP_SQRT_2 * jnp.stack([bits[..., 0], bits[..., 1]],
                                      axis=-1)
    if mod_bits == 3:
        swap = bits[..., 0] < 0
        re = jnp.where(swap, SIN_PI_8, COS_PI_8) * bits[..., 1]
        im = jnp.where(swap, COS_PI_8, SIN_PI_8) * bits[..., 2]
        return jnp.stack([re, im], axis=-1)
    raise ValueError(f"unsupported mod_bits {mod_bits}")


def mod_phase(mod_bits: int, bits):
    """Constellation phase angle of each symbol (for exact unit-modulus
    cumulative products: the encoder's differential chain accumulates
    phases instead of multiplying complex values).

    The 2^BITS angles come from a host table, each the correctly rounded
    f32 arctan2 of the f32 constellation point.  A device arctan2 may be
    an ulp off on some backend, and the encoder sums these angles down
    all payload rows, so that ulp would grow into the transmitted
    samples (tests/test_waveform_pin.py)."""
    groups = np.array(list(itertools.product((1.0, -1.0), repeat=mod_bits)))
    pts = mod_map_np(mod_bits, groups).astype(np.complex64)
    table = np.arctan2(pts.imag.astype(np.float64),
                       pts.real.astype(np.float64)).astype(np.float32)
    weights = 1 << np.arange(mod_bits - 1, -1, -1)
    idx = jnp.sum(jnp.where(bits < 0, weights, 0), axis=-1)
    return jnp.asarray(table)[idx]


# ---------------------------------------------------------------------------
# hard / soft: symbols [..., 2] -> bit groups [..., BITS]
# ---------------------------------------------------------------------------

def mod_hard(mod_bits: int, sym):
    re, im = sym[..., 0], sym[..., 1]
    sgn_re = jnp.where(re < 0, -1.0, 1.0)
    sgn_im = jnp.where(im < 0, -1.0, 1.0)
    if mod_bits == 1:
        return sgn_re[..., None]
    if mod_bits == 2:
        return jnp.stack([sgn_re, sgn_im], axis=-1)
    if mod_bits == 3:
        b0 = jnp.where(jnp.abs(re) < jnp.abs(im), -1.0, 1.0)
        return jnp.stack([b0, sgn_re, sgn_im], axis=-1)
    raise ValueError(f"unsupported mod_bits {mod_bits}")


def mod_soft(mod_bits: int, sym, precision, int8: bool = False):
    re, im = sym[..., 0], sym[..., 1]
    q = lambda v: _quantize(mod_bits, precision, v, int8)
    if mod_bits == 1:
        return q(re)[..., None]
    if mod_bits == 2:
        return jnp.stack([q(re), q(im)], axis=-1)
    if mod_bits == 3:
        b0 = q(RCP_SQRT_2 * (jnp.abs(re) - jnp.abs(im)))
        return jnp.stack([b0, q(re), q(im)], axis=-1)
    raise ValueError(f"unsupported mod_bits {mod_bits}")


# ---------------------------------------------------------------------------
# Host/numpy twins (complex dtype) for trace-time constant generation
# ---------------------------------------------------------------------------

def mod_map_np(mod_bits: int, bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.float64)
    if mod_bits == 1:
        return bits[..., 0].astype(np.complex128)
    if mod_bits == 2:
        return RCP_SQRT_2 * (bits[..., 0] + 1j * bits[..., 1])
    swap = bits[..., 0] < 0
    re = np.where(swap, SIN_PI_8, COS_PI_8) * bits[..., 1]
    im = np.where(swap, COS_PI_8, SIN_PI_8) * bits[..., 2]
    return re + 1j * im
