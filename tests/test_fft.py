"""Matmul mixed-radix DFT vs numpy reference, all wire-format sizes."""

import numpy as np
import pytest

from modem import cplx, fft

SIZES = [640, 1280, 2560, 3528, 3840, 5120, 7056, 7680, 10240]


@pytest.mark.parametrize("n", SIZES)
def test_fwd_bwd_match_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    xs = cplx.from_np(x)
    got = cplx.to_np(fft.fwd(xs))
    assert np.abs(got - np.fft.fft(x)).max() < 2e-4 * np.abs(
        np.fft.fft(x)).max()
    gotb = cplx.to_np(fft.bwd(xs))
    assert np.abs(gotb - n * np.fft.ifft(x)).max() < 2e-4 * np.abs(
        np.fft.fft(x)).max()


def test_bwd_fwd_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1280, 2)).astype(np.float32)
    y = fft.fwd(fft.bwd(x)) / 1280.0
    assert np.abs(np.asarray(y) - x).max() < 1e-3


def test_cplx_ops():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16,)) + 1j * rng.standard_normal((16,))
    b = rng.standard_normal((16,)) + 1j * rng.standard_normal((16,))
    sa, sb = cplx.from_np(a), cplx.from_np(b)
    assert np.allclose(cplx.to_np(cplx.cmul(sa, sb)), a * b, atol=1e-5)
    assert np.allclose(cplx.to_np(cplx.cmul_conj(sa, sb)),
                       a * np.conj(b), atol=1e-5)
    assert np.allclose(np.asarray(cplx.abs2(sa)), np.abs(a) ** 2,
                       atol=1e-5)
    assert np.allclose(np.asarray(cplx.angle(sa)), np.angle(a),
                       atol=1e-6)
