"""Impaired-channel robustness (SURVEY.md §4 check 3, BASELINE config 4).

The reference demonstrates bit-exact recovery through multipath + CFO
234.567 Hz + SFO 147 ppm + AWGN (README.md:42-49).  These tests apply
the native channel.py impairment chain at graduated severity; the full
chain runs on the toy configuration to keep CPU time sane, individual
impairments on the wire format.
"""

import numpy as np
import pytest

from modem import bits as B
from modem import channel
from modem.decoder import cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import make_config


@pytest.fixture(scope="module")
def mode6():
    cfg = make_config(8000, 6, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    return cfg, payload, np.concatenate([sil, wave, sil])


def _decode(rec, payload):
    res = cached_decoder(8000).decode(rec, channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    return res


def test_cfo_recovery(mode6):
    cfg, payload, rec = mode6
    res = _decode(channel.cfo(rec, 234.567, cfg.rate), payload)
    # estimated CFO = transmit offset + impairment
    assert abs(res.cfo_hz - (2000.0 + 234.567)) < 3.0


def test_sfo_recovery(mode6):
    cfg, payload, rec = mode6
    res = _decode(channel.sfo(rec, 147.0), payload)
    assert abs(res.sfo_ppm) < 400.0


def test_awgn_recovery(mode6):
    cfg, payload, rec = mode6
    res = _decode(channel.awgn(rec, -30.0,
                               np.random.default_rng(1)), payload)
    assert res.snr_db.mean() < 32.0   # noise visibly lowered the SNR


def test_multipath_recovery(mode6):
    cfg, payload, rec = mode6
    _decode(channel.multipath(rec), payload)


def test_full_reference_chain(mode6):
    cfg, payload, rec = mode6
    out = channel.reference_chain(rec, cfg.rate,
                                  rng=np.random.default_rng(2))
    _decode(out, payload)


def test_analytic_np_exact():
    """channel.analytic_np: real part preserved exactly (the analytic
    signal's real projection IS the input) and the spectrum is
    one-sided (negative frequencies zero)."""
    rng = np.random.default_rng(8)
    for n in (4096, 4097):          # even + odd lengths
        x = rng.standard_normal(n)
        a = channel.analytic_np(x)
        assert np.abs(a.real - x).max() < 1e-9
        spec = np.fft.fft(a)
        neg = spec[(n // 2) + 1:]
        assert np.abs(neg).max() < 1e-6 * np.abs(spec).max()
