"""Non-default frequency offsets end-to-end.

The reference supports any band-legal offset divisible by 50,
including negative centers for 2-channel analytic output
(encode.cc:389-397).  Round 1 exercised only freq_off=2000; these
tests pin the band edges and a negative offset on the wire format
(mode 10 at 8 kHz: bandwidth 3200 -> legal range [-2400, 2400]).
"""

import numpy as np
import pytest

from modem import bits as B
from modem.decoder import cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import make_config


@pytest.mark.parametrize("freq_off", [2400, -2400])
def test_band_edge_offset_loopback(freq_off):
    cfg = make_config(8000, 10, freq_off, channels=2)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(11 + abs(freq_off))
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])
    res = cached_decoder(8000).decode(rec, channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    # the receiver's coarse CFO estimate IS the transmit offset
    assert abs(res.cfo_hz - freq_off) < 3.0


def test_one_channel_requires_positive_band():
    # encode.cc:389: a real (1-channel) output cannot center below
    # bandwidth/2; analytic (2-channel) can go negative.
    with pytest.raises(ValueError):
        make_config(8000, 10, 1000, channels=1)
    make_config(8000, 10, 1000, channels=2)   # legal analytic
    with pytest.raises(ValueError):
        make_config(8000, 10, 2450, channels=2)  # past band edge
    with pytest.raises(ValueError):
        make_config(8000, 10, -2450, channels=2)
