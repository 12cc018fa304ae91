"""Theil-Sen regression, SNR demap, and sync building-block tests."""

import numpy as np

from modem import psk, track
from modem.sync import schmitt_falling, window_sum


def test_theil_sen_recovers_line():
    rng = np.random.default_rng(0)
    x = np.arange(-50, 50, dtype=np.float32)
    y = 0.01 * x + 0.3 + 0.001 * rng.standard_normal(100).astype(
        np.float32)
    slope, yint = track.theil_sen(x, y)
    assert abs(float(slope) - 0.01) < 1e-3
    assert abs(float(yint) - 0.3) < 5e-3


def test_theil_sen_robust_to_outliers():
    x = np.arange(-20, 20, dtype=np.float32)
    y = (0.05 * x - 0.1).astype(np.float32)
    y[::7] += 3.0   # gross outliers
    slope, yint = track.theil_sen(x, y)
    assert abs(float(slope) - 0.05) < 5e-3


def test_derotate_removes_linear_phase():
    rng = np.random.default_rng(1)
    rows, cols, code_off = 4, 64, -32
    bits = 1 - 2 * rng.integers(0, 2, (rows, cols, 2)).astype(np.float32)
    sym = np.asarray(psk.mod_map(2, bits))
    x = np.arange(cols) + code_off
    theta = 0.004 * x + 0.2
    rot = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    from modem import cplx
    import jax.numpy as jnp
    skew = np.asarray(cplx.cmul(jnp.asarray(sym),
                                jnp.asarray(rot)[None, :, :]))
    out, slope, yint = track.derotate_rows(jnp.asarray(skew), code_off, 2)
    assert abs(float(slope) - 0.004) < 5e-4
    assert abs(float(yint) - 0.2) < 2e-2
    back = np.asarray(psk.mod_hard(2, np.asarray(out)))
    assert (back == bits).all()


def test_soft_llrs_cumulative_snr():
    rng = np.random.default_rng(2)
    rows, cols = 6, 64
    bits = 1 - 2 * rng.integers(0, 2, (rows, cols, 2)).astype(np.float32)
    sym = np.asarray(psk.mod_map(2, bits))
    noisy = sym + 0.05 * rng.standard_normal(sym.shape).astype(np.float32)
    llrs, snr = track.soft_llrs(noisy, 2)
    assert llrs.shape == (rows, cols, 2)
    assert (np.sign(np.asarray(llrs)) ==
            np.asarray(psk.mod_hard(2, noisy))).all()
    # ~26 dB expected for sigma=0.05 per complex dim pair
    assert 20 < float(np.asarray(snr)[-1]) < 32


def test_window_sum_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(500)
    got = np.asarray(window_sum(x, 32))
    want = np.convolve(x, np.ones(32))[: len(x)]
    assert np.allclose(got, want, atol=1e-5)  # f32 tree-reduction error
    # error must not grow with position (no cumulative-sum drift)
    late = np.abs(got[-50:] - want[-50:]).max()
    assert late < 1e-5


def test_schmitt_hysteresis():
    t = np.array([0, 5, 2, 5, 1, 0, 5, 0], dtype=np.float32)
    state, falling = (np.asarray(v) for v in schmitt_falling(t, 2.0, 4.0))
    # rises at 5s, survives the dip to 2 (>= lo), drops at 1
    assert list(state.astype(int)) == [0, 1, 1, 1, 0, 0, 1, 0]
    assert list(falling.astype(int)) == [0, 0, 0, 0, 1, 0, 0, 1]
