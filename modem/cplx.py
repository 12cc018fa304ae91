"""Split-complex arithmetic: complex values as a trailing [re, im] axis.

The framework represents every complex tensor as float32 [..., 2]:
elementwise complex arithmetic becomes plain real ops, and DFTs become
real matmuls (see fft.py).  The layout dates from a backend without
complex dtypes; it is plain JAX that compiles for any backend as is.
Moving to complex64 / jnp.fft would change the transmitted waveform in
its last bits (tests/test_waveform_pin.py pins it), so that is a
measured, deliberate change, not a cleanup.

Host numpy code may use complex128/complex64 freely; `from_np`/`to_np`
convert at the jit boundary.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def make(re, im):
    return jnp.stack([re, im], axis=-1)


def zeros(shape, dtype=jnp.float32):
    return jnp.zeros(tuple(shape) + (2,), dtype)


def from_np(x: np.ndarray) -> np.ndarray:
    """Host complex array -> split [..., 2] float32."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def to_np(x) -> np.ndarray:
    """Split [..., 2] -> host complex64."""
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def re(x):
    return x[..., 0]


def im(x):
    return x[..., 1]


def conj(x):
    return jnp.stack([x[..., 0], -x[..., 1]], axis=-1)


def cmul(a, b):
    """a * b."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br - ai * bi, ar * bi + ai * br], axis=-1)


def cmul_conj(a, b):
    """a * conj(b)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br + ai * bi, ai * br - ar * bi], axis=-1)


def abs2(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2


def angle(x):
    return jnp.arctan2(x[..., 1], x[..., 0])


def expi(theta):
    """e^{j theta} as split complex."""
    return jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)


def scale(x, s):
    """Multiply by a real scalar/array (broadcast over the re/im axis)."""
    return x * jnp.asarray(s)[..., None]


def cdiv(a, b, eps: float = 0.0):
    """a / b (optionally guarded against |b| = 0)."""
    denom = abs2(b)
    if eps:
        denom = jnp.maximum(denom, eps)
    return cmul_conj(a, b) / denom[..., None]
