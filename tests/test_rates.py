"""Sample-rate breadth: 16/44.1/48 kHz full loopbacks; 44.1/48 kHz
spectra.

The 44100 family exercises the mixed-radix (7056 = 2^4 3^2 7^2) DFT
path end-to-end, in the encoder and in the batch and interactive
decoders (SURVEY.md §7 hard part 4).
"""

import numpy as np
import pytest

from modem import bits as B
from modem.decoder import cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import make_config
from modem.pipeline import cached_pipeline


def test_loopback_16k_pipeline():
    cfg = make_config(16000, 10, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 4, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])[None, :]
    pipe = cached_pipeline(16000, 10)
    res = pipe.decode_batch(rec)
    assert bool(np.asarray(res["ok"])[0])
    assert pipe.payload_bytes(res, 0) == payload


def test_loopback_44k_pipeline():
    """Full mixed-radix (7056-point) encode->decode loopback."""
    cfg = make_config(44100, 13, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(44)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 8, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])[None, :]
    pipe = cached_pipeline(44100, 13)
    res = pipe.decode_batch(rec)
    assert bool(np.asarray(res["ok"])[0])
    assert pipe.payload_bytes(res, 0) == payload


@pytest.mark.parametrize("rate,fft_len", [(44100, 7056), (48000, 7680)])
def test_encoder_high_rates_spectrum(rate, fft_len):
    cfg = make_config(rate, 13, 2000)
    assert cfg.symbol_len == fft_len
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(rate)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, papr = enc.encode(payload, B.base37_encode("N0CALL"))
    assert len(wave) == (2 + cfg.frame_symbols) * cfg.extended_len
    # a payload symbol's occupied band must match the mode-13 1600 Hz
    sym = wave[4 * cfg.extended_len + cfg.guard_len: 5 * cfg.extended_len]
    spec = np.fft.fft(sym)
    occ = np.abs(spec) > 0.1 * np.abs(spec).max()
    freqs = np.fft.fftfreq(fft_len, 1 / rate)[occ]
    assert freqs.min() > 2000 - 900 and freqs.max() < 2000 + 900
    db = 10 * np.log10(papr[papr[:, 0] > 0, 0])
    assert db.max() < 15.0


def test_loopback_48k_pipeline():
    """48 kHz (7680-point) full encode->decode loopback."""
    cfg = make_config(48000, 10, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(48)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 8, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])[None, :]
    pipe = cached_pipeline(48000, 10)
    res = pipe.decode_batch(rec)
    assert bool(np.asarray(res["ok"])[0])
    assert pipe.payload_bytes(res, 0) == payload


def test_loopback_16k_real_mono():
    """Mono real-channel decode at 16 kHz exercises the 41-tap Hilbert
    + DC-block front-end (taps are rate-dependent: 21/41/113/125)."""
    from modem.decoder import Decoder

    cfg = make_config(16000, 10, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(16)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 4, dtype=np.float32)
    rec = np.concatenate([sil, wave.real.astype(np.float32), sil])
    res = cached_decoder(16000).decode(rec, channels=1)
    assert res.ok and res.payload == payload


def test_noise_only_finds_no_preamble():
    from modem.decoder import Decoder

    rng = np.random.default_rng(0)
    noise = 0.1 * (rng.standard_normal(60000) +
                   1j * rng.standard_normal(60000))
    res = cached_decoder(8000).decode(noise.astype(np.complex64), channels=2)
    assert not res.ok
    assert res.payload is None


def test_loopback_44k_real_mono():
    """Mono real-channel decode at 44.1 kHz: the 113-tap Hilbert +
    DC-block front-end over the mixed-radix (7056) symbol."""
    from modem.decoder import Decoder

    cfg = make_config(44100, 13, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(441)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 8, dtype=np.float32)
    rec = np.concatenate([sil, wave.real.astype(np.float32), sil])
    res = cached_decoder(44100).decode(rec, channels=1)
    assert res.ok and res.payload == payload
