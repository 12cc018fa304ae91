"""Decoder front-end DSP: DC blocking and Hilbert analytic conversion.

Array-program equivalents of DSP::BlockDC and DSP::Hilbert as used at
decode.cc:192-193, 298-299: mono recordings pass through a DC-blocking
high-pass and an FIR Hilbert transformer to produce the analytic signal
the synchronizer consumes.  Both are whole-recording array ops (the
reference streams sample-by-sample).

The Hilbert filter is a type-III odd-length FIR (taps = filter_len,
decode.cc:172) from the windowed ideal response h[m] = 2/(pi m) for odd
m, paired with a matching (taps-1)/2-sample delay on the real path.
Exact window choice affects only mono-path sensitivity, not the wire
format (SURVEY.md Appendix A); a Blackman window is used.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def block_dc(x, window: int):
    """x - causal sliding mean over `window` samples (decode.cc:386).

    Uses the drift-free block window sum (sync.window_sum): a plain
    cumsum difference in f32 — jnp.float64 silently demotes — would
    accumulate cancellation error over minutes-long recordings."""
    from .sync import window_sum
    s = window_sum(x.astype(jnp.float32), window)
    cnt = jnp.minimum(jnp.arange(1, x.shape[0] + 1), window)
    return x - s / cnt


# Window applied to the ideal Hilbert response.  Upstream hilbert.hh
# is unmounted, so the exact choice is a designed-by-measurement
# default, not a parity pin: bench/mono_sweep.py --window A/Bs the
# candidates through the full impaired mono chain.  Wire-format
# irrelevant either way (SURVEY.md Appendix A).
HILBERT_WINDOW = "blackman"

_WINDOWS = {
    "blackman": np.blackman,
    "hamming": np.hamming,
    "hann": np.hanning,
    "rect": np.ones,
    "kaiser6": lambda n: np.kaiser(n, 6.0),
    "kaiser9": lambda n: np.kaiser(n, 9.0),
}


def hilbert_taps(taps: int, window: str | None = None) -> np.ndarray:
    # resolve the default BEFORE the cache key: a caller that flips
    # HILBERT_WINDOW (the A/B bench) must not hit a stale entry
    return _hilbert_taps(taps, window or HILBERT_WINDOW)


@functools.lru_cache(maxsize=None)
def _hilbert_taps(taps: int, window: str) -> np.ndarray:
    m = np.arange(taps) - (taps - 1) // 2
    h = np.zeros(taps)
    odd = m % 2 != 0
    h[odd] = 2.0 / (np.pi * m[odd])
    return (h * _WINDOWS[window](taps)).astype(np.float32)


def analytic(x, taps: int):
    """Real [T] -> split-complex analytic [T, 2] via FIR Hilbert.

    The real path is delayed (taps-1)/2 samples to align with the
    filter's group delay.
    """
    h = jnp.asarray(hilbert_taps(taps))
    d = (taps - 1) // 2
    xp = jnp.concatenate([jnp.zeros(taps - 1, x.dtype), x])
    # correlate: im[n] = sum_k h[k] * x[n - k]
    im = jnp.convolve(xp, h, mode="valid")
    re = jnp.concatenate([jnp.zeros(d, x.dtype), x])[: x.shape[0]]
    return jnp.stack([re, im[: x.shape[0]]], axis=-1)


def frontend(samples, channels: int, dc_window: int, taps: int):
    """WAV samples -> split-complex analytic recording (decode.cc:294-301).

    channels == 1: DC-block then Hilbert; channels == 2: I/Q passthrough.
    `samples` is [T] real or [T, 2].
    """
    if channels == 1:
        x = samples if samples.ndim == 1 else samples[:, 0]
        return analytic(block_dc(x, dc_window), taps)
    return jnp.asarray(samples)
