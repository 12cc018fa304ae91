"""OFDM symbol synthesis: PAPR reduction, IFFT, windowed guard crossfade.

Array-program re-design of the reference's per-symbol streaming synthesis
(encode.cc:80-131).  The reference synthesises one symbol at a time
through member-state FFTs; here a whole frame's worth of symbols is one
batched matmul-DFT pass (fft.py) plus vectorised clip-and-filter, and
the guard crossfade — the only cross-symbol dependency — becomes a
one-symbol shift instead of carried state.  All complex data is
split-complex [..., 2] (cplx.py); no complex dtypes touch the device.

Conventions matched to the reference:
  * fwd/bwd are unnormalised (DSP::FastFourierTransform semantics);
    every scale factor is explicit, mirroring encode.cc:88,97,109.
  * improve_papr (encode.cc:80-100): 4x zero-padded oversample, clip
    |re| and |im| to 1, refilter, keep only originally-occupied bins.
  * symbol IFFT scaled 1/sqrt(8 N) for 3 dB headroom (encode.cc:109).
  * guard = raised-cosine crossfade between the previous symbol's head
    and the current symbol's tail — windowed OFDM, not a cyclic prefix
    (encode.cc:110-114, 127-130).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import cplx, fft


def bin_index(carrier, n: int):
    """Negative-frequency-aware bin mapping (encode.cc:68-71)."""
    return (np.asarray(carrier) + n) % n


def demod_or_erase(curr, prev):
    """Differential demod with erasures (decode.cc:62-70): returns
    curr/prev, or 0 where |prev|^2 == 0 or |curr/prev|^2 > 4 (NaNs
    erase too, via the negated comparisons)."""
    num = cplx.cmul_conj(curr, prev)
    den = cplx.abs2(prev)
    cons = num / jnp.maximum(den, 1e-30)[..., None]
    ok = (den > 0) & (cplx.abs2(cons) <= 4.0)
    return jnp.where(ok[..., None], cons, 0.0)


def improve_papr(fdom):
    """Batched 4x-oversampled clip-and-filter (encode.cc:80-100).

    fdom: [..., N, 2] split-complex symbol spectra.  Bins that were
    exactly zero stay zero.
    """
    n = fdom.shape[-2]
    lead = fdom.shape[:-2]
    zeros = jnp.zeros(lead + (3 * n, 2), dtype=fdom.dtype)
    # fdom4[bin4(i)] = fdom[bin(i)] for i in [-N/2, N/2): low half keeps
    # its bins, the negative half moves to the top of the 4N spectrum.
    fdom4 = jnp.concatenate(
        [fdom[..., : n // 2, :], zeros, fdom[..., n // 2:, :]], axis=-2)
    tdom4 = fft.bwd(fdom4) / np.sqrt(4.0 * n)
    amp = jnp.maximum(jnp.abs(tdom4[..., 0]), jnp.abs(tdom4[..., 1]))
    tdom4 = jnp.where((amp > 1.0)[..., None], tdom4 / amp[..., None],
                      tdom4)
    spec = fft.fwd(tdom4) / np.sqrt(4.0 * n)
    clipped = jnp.concatenate(
        [spec[..., : n // 2, :], spec[..., 3 * n + n // 2:, :]], axis=-2)
    occupied = (cplx.abs2(fdom) > 0)[..., None]
    return jnp.where(occupied, clipped, 0.0)


def synthesize(fdom, guard_len: int, papr_mask=None):
    """Spectra [n_sym, N, 2] -> (waveform [n_sym*(G+N), 2], papr [n_sym, 2]).

    Applies PAPR reduction where ``papr_mask`` (bool [n_sym]) is true
    (the Schmidl-Cox symbol skips it, encode.cc:153), synthesises all
    symbols with one batched IFFT, and emits [guard | symbol] rows with
    the raised-cosine crossfade.  The caller appends the all-zero flush
    symbol as the last row (encode.cc:311-313).
    """
    wave, papr, _head = synthesize_carry(fdom, guard_len, papr_mask)
    return wave, papr


def synthesize_carry(fdom, guard_len: int, papr_mask=None,
                     prev_head=None):
    """synthesize() with the cross-symbol crossfade state explicit.

    ``prev_head``: [guard_len, 2] head of the symbol PRECEDING
    fdom[0] (None = silence, i.e. a stream start).  Returns
    (wave, papr, last_head) where last_head is fdom[-1]'s symbol head
    — feed it to the next chunk so a long transmission can synthesise
    in fixed-size chunks with ONE bounded set of compiled graphs (the
    guard crossfade is the only cross-symbol dependency)."""
    n_sym, n, _ = fdom.shape
    shaped = improve_papr(fdom)
    if papr_mask is not None:
        shaped = jnp.where(jnp.asarray(papr_mask)[:, None, None], shaped,
                           fdom)
    tdom = fft.bwd(shaped) / np.sqrt(8.0 * n)

    # Raised-cosine crossfade guard (encode.cc:110-114).
    x = jnp.arange(guard_len) / (guard_len - 1)
    w = (0.5 * (1.0 - jnp.cos(jnp.pi * x)))[None, :, None]
    heads = tdom[:, :guard_len]
    tails = tdom[:, n - guard_len:]
    first = (jnp.zeros((1, guard_len, 2), tdom.dtype)
             if prev_head is None else prev_head[None])
    prev_heads = jnp.concatenate([first, heads[:-1]], axis=0)
    guards = prev_heads * (1.0 - w) + tails * w

    # Per-symbol per-axis PAPR (encode.cc:115-126), as metrics.
    power = tdom ** 2                                   # [n_sym, N, 2]
    papr = n * jnp.max(power, axis=1) / jnp.maximum(
        jnp.sum(power, axis=1), 1e-30)

    wave = jnp.concatenate([guards, tdom], axis=1).reshape(-1, 2)
    return wave, papr, heads[-1]
