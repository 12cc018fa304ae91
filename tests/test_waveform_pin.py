"""Frozen TRANSMIT-waveform fingerprint: the anti-drift tripwire.

Loopback tests cannot catch a self-consistent wire-format change —
if the encoder and decoder move together (a different MLS convention
default, an altered PAPR clip rule, a guard-crossfade tweak), every
byte-exact test still passes while the on-air waveform silently
changes.  This test pins the actual transmitted samples: a decimated
int16 fingerprint of a seeded mode-6 encode, stored in tests/data.
Any intentional wire-format change must regenerate the fixture and
say so in the commit (CLAUDE.md wire-format rule; the frozen polar
tables pin the code construction the same way, test_freezer.py).

Tolerance: quantisation sits ~1e-6 float jitter below the int16 LSB,
so cross-run/XLA-version drift can flip razor-edge samples by 1 LSB —
allow |diff| <= 1 on < 0.5% of fingerprint samples, never more.
"""

import os

import numpy as np
import pytest

from modem import bits as B
from modem.decoder import cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import make_config

_DATA = os.path.join(os.path.dirname(__file__), "data")


def test_mode6_waveform_fingerprint():
    pin = np.load(os.path.join(
        _DATA, "waveform_pin_mode6_galois.npy"))
    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    cfg = make_config(8000, 6, 2000)
    wave, _ = cached_encoder(cfg).encode(payload, B.base37_encode("N0CALL"))
    q = np.clip(np.rint(wave.real * 32767.0), -32768,
                32767).astype(np.int16)
    qi = np.clip(np.rint(wave.imag * 32767.0), -32768,
                 32767).astype(np.int16)
    fp = np.stack([q[::97], qi[::97]])
    assert fp.shape == pin.shape
    diff = np.abs(fp.astype(np.int32) - pin.astype(np.int32))
    assert diff.max() <= 1, f"waveform changed (max LSB diff {diff.max()})"
    frac = float((diff > 0).mean())
    assert frac < 0.005, f"waveform changed ({frac:.2%} samples differ)"


def test_golden_recording_decodes():
    """RX side of the tripwire: a FROZEN on-disk recording (16-bit
    stereo WAV of a seeded mode-6 encode, generated once and checked
    in) must keep decoding byte-exact.  The fingerprint test above
    pins the transmitter; this pins the receiver against the same
    frozen wire format — a decoder-side convention change (MLS kernel,
    window placement, demap sign) fails HERE even if encoder and
    decoder drift together in fresh loopbacks.  An intentional format
    change regenerates BOTH fixtures (CLAUDE.md wire-format rule)."""
    from modem import wav
    from modem.decoder import Decoder

    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    data = wav.read_wav(os.path.join(
        _DATA, "golden_mode6_galois.wav"))
    assert data.rate == 8000 and data.channels == 2
    res = cached_decoder(8000).decode(data.samples[:, :2], channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    assert res.oper_mode == 6
    assert res.call_sign == "N0CALL"


@pytest.mark.parametrize("conv", ["galois", "fibonacci", "msb"])
def test_golden_per_convention_fixture_decodes(conv):
    """One frozen recording PER MLS convention (tools/
    gen_golden_fixtures.py): the material for the docs/WIRE_FORMAT.md
    golden-waveform handshake — an environment with the reference
    aicodix binary identifies upstream mls.hh's convention by running
    `decode` on each file (mls.hh call sites encode.cc:134,144,165 /
    decode.cc:238,407).  Here the AUTO receiver must decode every
    fixture byte-exact AND commit the fixture's own convention (the
    recovered CFO pins it: a wrong-convention alias shifts the
    estimate by a multiple of the 2x bin spacing)."""
    from modem import wav
    from modem.decoder import Decoder

    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    data = wav.read_wav(os.path.join(
        _DATA, f"golden_mode6_{conv}.wav"))
    assert data.rate == 8000 and data.channels == 2
    dec = cached_decoder(8000, mls_convention="auto")
    res = dec.decode(data.samples[:, :2], channels=2)
    assert res.ok, (conv, res.status)
    assert res.payload == payload
    assert res.oper_mode == 6
    assert res.call_sign == "N0CALL"
    assert abs(res.cfo_hz - 2000.0) < 1.0, (conv, res.cfo_hz)


def test_mls_sequence_value_pins():
    """First bits of each MLS sequence per convention: the property
    tests (test_mls_convention) prove m-sequence-ness but would pass
    ANY phase; these pin the exact emitted values."""
    from modem.numerology import MLS0_POLY, MLS1_POLY
    pins = {
        ("galois", MLS0_POLY): [1, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 0],
        ("fibonacci", MLS0_POLY): [1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1],
        ("msb", MLS0_POLY): [0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0],
        ("galois", MLS1_POLY): [1, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0],
    }
    for (conv, poly), want in pins.items():
        got = B.mls_bits(poly, len(want), convention=conv).tolist()
        assert got == want, (conv, hex(poly), got)
