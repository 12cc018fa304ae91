"""MLS LFSR convention: the one unresolved wire-format choice.

The reference's CODE::MLS (mls.hh, unmounted) pins the m-sequence PHASE
transmitted on the sync carriers (encode.cc:144), the header scrambler
(encode.cc:165) and the pilot (encode.cc:134).  Loopback parity cannot
distinguish LFSR conventions (encoder and decoder share the generator),
and — the sequences being phases of ONE m-sequence — neither can the
sync stage alone: a phase shift aliases into a shifted integer-CFO
estimate that still passes the peak-dominance gate.  These tests pin
the framework's answer (docs/WIRE_FORMAT.md): every convention is a
self-consistent wire format behind ModemConfig.mls_convention, and an
"auto" receiver walks the gate-passing convention hypotheses and
commits the one whose header OSD+CRC16 validates.
"""

import dataclasses

import numpy as np
import pytest

from modem import bits as B
from modem.decoder import cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import (MLS0_POLY, MLS1_POLY, MLS2_POLY,
                                  make_config)


@pytest.mark.parametrize("poly", [MLS0_POLY, MLS1_POLY, MLS2_POLY])
def test_conventions_are_distinct_m_sequences(poly):
    """Each convention must emit a maximal-length sequence (period
    2^deg - 1, balanced), and the three must differ (else the config
    knob would be vacuous)."""
    deg = poly.bit_length() - 1
    per = (1 << deg) - 1
    seqs = {}
    for conv in B.MLS_CONVENTIONS:
        s = B.mls_bits(poly, 3 * per, convention=conv)
        assert (s[:per] == s[per:2 * per]).all()
        assert (s[:per] == s[2 * per:]).all()
        # no smaller period (m-sequence property)
        assert all(not (s[:per] == np.roll(s[:per], d)).all()
                   for d in range(1, per))
        assert s[:per].sum() == (per + 1) // 2       # balance
        seqs[conv] = s[:per]
    convs = list(seqs)
    for i in range(len(convs)):
        for j in range(i + 1, len(convs)):
            assert not (seqs[convs[i]] == seqs[convs[j]]).all()


def test_convention_sequence_relations():
    """The aliasing root cause (sync._fine_stage docstring): fibonacci
    and msb emit phases of ONE m-sequence; galois emits the time-
    REVERSED sequence (the reciprocal polynomial's recurrence).  A
    rotation aliases into a shifted integer-CFO estimate; even the
    reversed sequence's matched filter was measured passing the
    peak-dominance gate (ratio ~15) — hence the header-CRC
    hypothesis test instead of sync-stage detection."""
    per = 127
    g = B.mls_bits(MLS0_POLY, per, convention="galois")
    f = B.mls_bits(MLS0_POLY, per, convention="fibonacci")
    m = B.mls_bits(MLS0_POLY, per, convention="msb")
    assert any((m == np.roll(f, d)).all() for d in range(per))
    gr = g[::-1]
    assert any((f == np.roll(gr, d)).all() for d in range(per))


def _encode(convention: str):
    cfg = dataclasses.replace(make_config(8000, 6, 2000),
                              mls_convention=convention)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 2, dtype=np.complex64)
    return payload, np.concatenate([sil, wave, sil])


@pytest.fixture(scope="module")
def fibonacci_wave():
    return _encode("fibonacci")


def test_auto_receiver_decodes_fibonacci(fibonacci_wave):
    payload, rec = fibonacci_wave
    dec = cached_decoder(8000, mls_convention="auto")
    res = dec.decode(rec, channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    # the committed hypothesis recovers the true CFO (a wrong-
    # convention alias would be off by a multiple of 2*6.25 Hz)
    assert abs(res.cfo_hz - 2000.0) < 1.0


def test_auto_receiver_decodes_msb():
    payload, rec = _encode("msb")
    dec = cached_decoder(8000, mls_convention="auto")
    res = dec.decode(rec, channels=2)
    assert res.ok, res.status
    assert res.payload == payload
    assert abs(res.cfo_hz - 2000.0) < 1.0


def test_galois_receiver_rejects_fibonacci(fibonacci_wave):
    """Cross-convention interop is NOT transparent: a single-
    convention receiver must fail on a foreign wave (this is exactly
    the dormant wire-format risk vs the reference binary)."""
    _payload, rec = fibonacci_wave
    res = cached_decoder(8000).decode(rec, channels=2)
    assert not res.ok


def test_headers_batch_commits_detected_convention(fibonacci_wave):
    """The serving header stage (decode_headers_batch) evaluates all
    gate-passing hypotheses in one jit and commits the validating one
    into the candidate (SyncCandidate.accept)."""
    _payload, rec = fibonacci_wave
    dec = cached_decoder(8000, mls_convention="auto")
    from modem import cplx
    x = cplx.from_np(np.asarray(rec))
    cands = [c for c in dec.sync.scan(x) if c.ok]
    assert cands
    out = dec.decode_headers_batch(x, cands)
    hdr, status = out[0]
    assert hdr is not None, status
    oper_mode, call = hdr
    assert oper_mode == 6
    assert B.base37_decode(call).lstrip() == "N0CALL"
    assert dec.sync.conventions[cands[0].conv] == "fibonacci"
    assert abs(cands[0].cfo_rad * 8000 / (2 * np.pi) - 2000.0) < 1.0


def test_batch_pipeline_rejects_auto():
    """The batch path pins one matched kernel; silently accepting
    'auto' would decode a foreign convention as noise."""
    from modem.pipeline import BatchPipeline
    with pytest.raises(ValueError, match="auto"):
        BatchPipeline(8000, 6, mls_convention="auto")
