"""Mixed-radix DFT as real matmuls over split-complex arrays.

The reference relies on DSP::FastFourierTransform for sizes
{640, 1280, 2560, 3528, 3840, 5120, 7056, 7680, 10240, 28224, 30720}
(encode.cc:42-44, decode.cc:43-44,191) — including the non-power-of-two
7056 = 2^4 * 3^2 * 7^2 family.  Here they are Cooley-Tukey with
*matmul* butterflies over split-complex arrays: a size-N transform
splits as N = A * B (A <= BASE), the size-A/size-B stages are dense
[*, A] x [A, A] real matmuls, joined by a precomputed twiddle
multiply.  FLOPs are N*(A+B+...) — far from N log N, but small next to
matmul throughput, and every op is batched over all OFDM symbols at
once.  The design dates from a backend without complex dtypes or an
FFT primitive; it stays because jnp.fft would change the transmitted
waveform in its last bits (tests/test_waveform_pin.py), which is a
measured, deliberate change of its own.

Conventions match DSP::FastFourierTransform: `fwd` uses e^{-2 pi j nk/N},
`bwd` uses e^{+2 pi j nk/N}; both UNNORMALISED (callers scale explicitly,
as the reference does at encode.cc:88,97,109 and decode.cc:82).

Matmuls run with Precision.HIGHEST: without it a GPU runs f32 matmuls
in TF32 (about three decimal digits), and the DFTs need full f32
accuracy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BASE = 128  # largest direct-matmul stage


@functools.lru_cache(maxsize=None)
def _dft_matrices(n: int, sign: int):
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    c = np.cos(ang).astype(np.float32)
    s = (np.sin(ang) * sign).astype(np.float32)
    return c, s


@functools.lru_cache(maxsize=None)
def _twiddle(n: int, a: int, sign: int):
    b = n // a
    aa = np.arange(a)[:, None]
    cc = np.arange(b)[None, :]
    ang = 2.0 * np.pi * (aa * cc) / n
    t = np.stack([np.cos(ang), np.sin(ang) * sign],
                 axis=-1).astype(np.float32)
    return t


@functools.lru_cache(maxsize=None)
def _split(n: int) -> int:
    """Largest divisor of n that is <= BASE (the direct stage size)."""
    best = 1
    for a in range(2, BASE + 1):
        if n % a == 0:
            best = a
    return best


def _dft_direct(x, sign: int):
    n = x.shape[-2]
    c, s = _dft_matrices(n, sign)
    c = jnp.asarray(c)
    s = jnp.asarray(s)
    xr, xi = x[..., 0], x[..., 1]
    hp = jax.lax.Precision.HIGHEST
    # forward (sign=-1): X = sum x * (cos + j*sign*sin)
    yr = jnp.matmul(xr, c, precision=hp) - jnp.matmul(xi, s, precision=hp)
    yi = jnp.matmul(xi, c, precision=hp) + jnp.matmul(xr, s, precision=hp)
    return jnp.stack([yr, yi], axis=-1)


def _dft(x, sign: int):
    n = x.shape[-2]
    if n <= BASE:
        return _dft_direct(x, sign)
    a = _split(n)
    if a == 1:
        raise ValueError(f"DFT size {n} has no factor <= {BASE}")
    b = n // a
    lead = x.shape[:-2]
    # n = a_idx + A * b_idx  ->  [..., B, A, 2]
    x = x.reshape(*lead, b, a, 2)
    x = jnp.swapaxes(x, -2, -3)              # [..., A, B, 2]
    y = _dft(x, sign)                        # DFT over b -> columns c
    from . import cplx
    y = cplx.cmul(y, jnp.asarray(_twiddle(n, a, sign)))
    y = jnp.swapaxes(y, -2, -3)              # [..., B(c), A(a), 2]
    z = _dft_direct(y, sign)                 # DFT over a -> rows d
    z = jnp.swapaxes(z, -2, -3)              # [..., A(d), B(c), 2]
    return z.reshape(*lead, n, 2)


def fwd(x):
    """Forward unnormalised DFT over axis -2 of split-complex [..., N, 2]."""
    return _dft(x, -1)


def bwd(x):
    """Backward (e^{+j}) unnormalised DFT — DSP::FFT<.., 1> semantics."""
    return _dft(x, +1)
