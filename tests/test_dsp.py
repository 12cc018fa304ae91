"""Mono front-end filter-design properties (decode.cc:172,192-193).

The Hilbert FIR's exact window is a designed-by-measurement default
(upstream hilbert.hh unmounted — docs/WIRE_FORMAT.md); these numpy
pins guard the whole candidate family's structural invariants so the
A/B bench (bench/mono_sweep.py --window) always compares valid
Hilbert transformers, whatever default the measurements pick.
"""

import numpy as np
import pytest

from modem import dsp


TAPS = 161  # mode-6 filter_len at 8 kHz (decode.cc:172)


@pytest.mark.parametrize("window", sorted(dsp._WINDOWS))
def test_hilbert_taps_type3(window):
    """Type-III FIR: odd length, antisymmetric, zero even taps."""
    h = dsp.hilbert_taps(TAPS, window)
    assert h.shape == (TAPS,) and h.dtype == np.float32
    m = np.arange(TAPS) - (TAPS - 1) // 2
    assert np.all(h[m % 2 == 0] == 0.0)
    np.testing.assert_allclose(h, -h[::-1], atol=0)


@pytest.mark.parametrize("window", sorted(dsp._WINDOWS))
def test_hilbert_response(window):
    """|H| ~= 1 over the occupied band, H purely imaginary with a sign
    flip across DC (the 90-degree shift that builds the analytic
    signal).  Mode 6 at 8 kHz occupies ~1200..2800 Hz, i.e.
    0.15..0.35 fs — comfortably inside every candidate's passband."""
    h = dsp.hilbert_taps(TAPS, window).astype(np.float64)
    n_fft = 4096
    H = np.fft.rfft(h, n_fft)
    # remove the linear phase of the (TAPS-1)/2 group delay
    w = np.arange(H.shape[0]) * 2 * np.pi / n_fft
    H = H * np.exp(1j * w * ((TAPS - 1) // 2))
    band = slice(int(0.15 * n_fft), int(0.35 * n_fft) + 1)
    mag = np.abs(H[band])
    ripple = 0.05 if window != "rect" else 0.25  # Gibbs on rect
    assert np.all(np.abs(mag - 1.0) < ripple), (mag.min(), mag.max())
    # phase: H = -j * sign(f) ideally -> real part ~ 0 in the band
    assert np.max(np.abs(H[band].real)) < 1e-9
    assert np.all(H[band].imag < 0)


def test_block_dc_rejects_dc_passes_band():
    """block_dc kills a constant offset and leaves the occupied band
    (decode.cc:192,386: BlockDC ahead of the Hilbert on mono input)."""
    import jax
    import jax.numpy as jnp
    rate, win = 8000, 250
    t = np.arange(rate * 2) / rate
    tone = np.sin(2 * np.pi * 2000.0 * t).astype(np.float32)
    y = np.asarray(jax.jit(lambda v: dsp.block_dc(v, win))(
        jnp.asarray(tone + 0.5)))
    settled = y[2 * win:]
    assert abs(settled.mean()) < 1e-3
    np.testing.assert_allclose(settled, tone[2 * win:], atol=0.02)
