"""Native C++ host runtime vs the numpy reference implementations."""

import numpy as np
import pytest

from modem import bits as B
from modem import native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("native library not built and no compiler available")


def test_scramble_matches_numpy():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    assert native.scramble(data) == B.scramble(data)
    assert native.scramble(native.scramble(data)) == data


def test_crc_matches_numpy():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    from modem.numerology import CRC16_POLY, CRC32_POLY
    assert native.crc_bytes(CRC32_POLY, data) == B.crc32.over_bytes(data)
    assert native.crc_bytes(CRC16_POLY, data) == B.crc16.over_bytes(data)


def test_bits_roundtrip_matches_numpy():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 640, dtype=np.uint8).tobytes()
    got = native.bytes_to_bits_le(data)
    assert (got == B.bytes_to_bits_le(data)).all()
    assert native.bits_to_bytes_le(got) == data


def test_native_wav_codec_matches_python(tmp_path, monkeypatch):
    """Native RIFF read/write vs the numpy fallback: same files, same
    samples back (8/16-bit, 1/2 channels)."""
    from modem import native, wav

    if not native.available():
        import pytest
        pytest.skip("native library not built")
    rng = np.random.default_rng(2)
    sig = (0.8 * rng.standard_normal(2048)).clip(-1, 1).astype(
        np.complex64)
    sig += 1j * (0.5 * rng.standard_normal(2048)).clip(-1, 1)
    for bits in (8, 16):
        for ch in (1, 2):
            p_nat = tmp_path / f"n_{bits}_{ch}.wav"
            p_py = tmp_path / f"p_{bits}_{ch}.wav"
            wav.write_wav(str(p_nat), sig, 8000, bits, ch)
            monkeypatch.setattr(native, "wav_write",
                                lambda *a, **k: False)
            wav.write_wav(str(p_py), sig, 8000, bits, ch)
            monkeypatch.undo()
            a = p_nat.read_bytes()
            b = p_py.read_bytes()
            assert a[:44] == b[:44]          # identical headers
            qa = np.frombuffer(a[44:], dtype=np.uint8).astype(int)
            qb = np.frombuffer(b[44:], dtype=np.uint8).astype(int)
            # quantizers may round .5 ties differently; never more
            assert len(qa) == len(qb)
            if bits == 16:
                qa = np.frombuffer(a[44:], dtype="<i2").astype(int)
                qb = np.frombuffer(b[44:], dtype="<i2").astype(int)
            assert np.abs(qa - qb).max() <= 1
            # native read of both files agrees with python read
            r_nat = wav.read_wav(str(p_nat))
            monkeypatch.setattr(native, "wav_read", lambda *a: None)
            r_py = wav.read_wav(str(p_nat))
            monkeypatch.undo()
            assert r_nat.rate == r_py.rate == 8000
            assert r_nat.channels == r_py.channels == ch
            assert np.allclose(r_nat.samples, r_py.samples, atol=1e-6)
