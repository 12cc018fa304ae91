"""Regenerate the golden-recording fixtures in tests/data.

One frozen 16-bit stereo WAV per MLS LFSR convention (galois /
fibonacci / msb), each a seeded mode-6 encode with a 0.25 s silence
lead and tail — the material for the docs/WIRE_FORMAT.md golden-
waveform handshake: an environment that has the reference aicodix
binary can run `decode` on each file; whichever decodes identifies
the upstream mls.hh convention in minutes (mls.hh call sites
encode.cc:134,144,165 / decode.cc:238,407).

tests/test_waveform_pin.py pins all three fixtures on the RX side.
By default the galois fixture (checked in first, round 4) is NOT
rewritten — quantisation sits ~1e-6 below the int16 LSB, so a
regenerate can flip razor-edge samples by 1 LSB and churn the frozen
file for nothing.  --all forces every convention.

Usage: python tools/gen_golden_fixtures.py [--all]
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from modem import bits as B  # noqa: E402
from modem import wav  # noqa: E402
from modem.encoder import Encoder  # noqa: E402
from modem.numerology import make_config  # noqa: E402

_DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")
LEAD = 2000  # 0.25 s at 8 kHz, matches the round-4 galois fixture


def generate(convention: str) -> str:
    cfg = dataclasses.replace(make_config(8000, 6, 2000),
                              mls_convention=convention)
    payload = np.load(os.path.join(
        _DATA, "waveform_pin_payload_seed.npy")).tobytes()
    wave_c, _ = Encoder(cfg).encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(LEAD, np.complex64)
    rec = np.concatenate([sil, np.asarray(wave_c, np.complex64), sil])
    path = os.path.join(_DATA, f"golden_mode6_{convention}.wav")
    wav.write_wav(path, rec, 8000, bits=16, channels=2)
    return path


def main():
    force_all = "--all" in sys.argv[1:]
    for conv in ("galois", "fibonacci", "msb"):
        path = os.path.join(_DATA, f"golden_mode6_{conv}.wav")
        if conv == "galois" and os.path.exists(path) and not force_all:
            print(f"keep   {path} (frozen; --all to rewrite)")
            continue
        print(f"write  {generate(conv)}")


if __name__ == "__main__":
    main()
