"""End-to-end loopback: encode -> waveform -> decode, bit-exact payload.

The modem's own ground truth (SURVEY.md §4 check 2, BASELINE config 1):
byte-identical payload recovery through the full pipeline.  Runs on
XLA-CPU (conftest); one full-size configuration plus front-end variants.
"""

import numpy as np
import pytest

from modem import bits as B
from modem.decoder import Decoder, cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import make_config


@pytest.fixture(scope="module")
def mode6_wave():
    cfg = make_config(8000, 6, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(99)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, papr = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    return cfg, payload, np.concatenate([sil, wave, sil]), papr


def test_loopback_analytic_mode6(mode6_wave):
    cfg, payload, rec, papr = mode6_wave
    dec = cached_decoder(8000)
    res = dec.decode(rec, channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    assert res.oper_mode == 6
    assert res.call_sign == "N0CALL"
    assert res.bit_flips == 0
    # sync must land on the S&C symbol: silence + pilot + guard
    expect = cfg.rate + cfg.extended_len + cfg.guard_len
    assert abs(res.symbol_pos - expect) <= 2
    assert abs(res.cfo_hz - 2000.0) < 1.0


def test_loopback_real_mono_mode6(mode6_wave):
    """Mono path exercises BlockDC + Hilbert (decode.cc:298-299)."""
    cfg, payload, rec, _ = mode6_wave
    dec = cached_decoder(8000)
    res = dec.decode(rec.real.astype(np.float32), channels=1)
    assert res.ok, res.status
    assert res.payload == payload


def test_loopback_quantized_16bit(mode6_wave):
    """Through the WAV codec (16-bit quantization noise)."""
    from modem import wav
    import tempfile, os
    cfg, payload, rec, _ = mode6_wave
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.wav")
        wav.write_wav(path, rec, cfg.rate, 16, 2)
        data = wav.read_wav(path)
        assert data.rate == cfg.rate and data.channels == 2
        res = cached_decoder(8000).decode(data.analytic, channels=2)
    assert res.ok, res.status
    assert res.payload == payload


def test_loopback_device_scl(mode6_wave):
    """Interactive decoder with the on-device SCL VM instead of the
    numpy reference decoder."""
    cfg, payload, rec, _ = mode6_wave
    dec = Decoder(8000, device_scl=True)
    res = dec.decode(rec, channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    assert res.bit_flips == 0


def test_loopback_8bit_wav(mode6_wave):
    """8-bit PCM round trip (encode.cc BITS=8 support)."""
    from modem import wav
    import tempfile, os
    cfg, payload, rec, _ = mode6_wave
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t8.wav")
        wav.write_wav(path, rec, cfg.rate, 8, 2)
        data = wav.read_wav(path)
        assert data.bits == 8
        res = cached_decoder(8000).decode(data.analytic, channels=2)
    assert res.ok, res.status
    assert res.payload == payload


def test_failure_path_transcript(mode6_wave):
    """On payload decode failure the reference still prints coarse
    sfo / finer cfo / Es-N0 BEFORE `payload decoding error.`
    (decode.cc:502-523 vs :543) — pin that stderr ordering."""
    import io

    cfg, _payload, rec, _ = mode6_wave
    rec = np.array(rec)
    # wreck the payload rows only: preamble+metadata+pilot stay clean
    start = cfg.rate + 4 * cfg.extended_len
    rng = np.random.default_rng(5)
    rec[start:] = 0.05 * (
        rng.standard_normal(len(rec) - start)
        + 1j * rng.standard_normal(len(rec) - start))
    log = io.StringIO()
    res = cached_decoder(8000).decode(rec, channels=2, log=log)
    assert not res.ok
    assert res.status == "payload decoding error."
    lines = log.getvalue().splitlines()
    i_err = lines.index("payload decoding error.")
    head = lines[:i_err]
    assert any(ln.startswith("coarse sfo: ") for ln in head)
    assert any(ln.startswith("finer cfo: ") for ln in head)
    assert any(ln.startswith("Es/N0 (dB):") for ln in head)
    # demod statistics surface on the result even without a payload
    assert res.snr_db is not None


def test_loopback_mono_impaired(mode6_wave):
    """Mono robustness regression: the reference's
    headline acoustic workflow is ONE-channel 16-bit audio
    (decode.cc:294-301 dequantise -> BlockDC -> Hilbert).  Run the
    full reference impairment chain (x10-spread multipath + CFO
    234.567 Hz + SFO 147 ppm + AWGN -30 dB), observe only the real
    projection quantised to int16, and require byte-exact recovery —
    pins the Hilbert/BlockDC margin under impairment, not just clean
    loopback (bench/mono_sweep.py measures the full envelope)."""
    from modem import channel

    cfg, payload, rec, _ = mode6_wave
    y = channel.multipath(rec, spread=10)
    y = channel.cfo(y, 234.567, cfg.rate)
    y = channel.sfo(y, 147.0)
    y = channel.awgn(y, -30.0, np.random.default_rng(11))
    q = np.clip(np.rint(y.real * 32767.0), -32768, 32767)
    mono = (q / 32767.0).astype(np.float32)
    res = cached_decoder(8000).decode(mono, channels=1)
    assert res.ok, res.status
    assert res.payload == payload


def test_papr_reported(mode6_wave):
    _, _, _, papr = mode6_wave
    db = 10 * np.log10(papr[papr[:, 0] > 0, 0])
    assert 3.0 < db.min() < db.max() < 15.0
