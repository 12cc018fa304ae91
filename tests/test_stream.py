"""Streaming (live) decode: parity with the batch auto-decoder and the
live-emission property.

The reference decodes live audio from a pipe sample-by-sample
(decode.cc:294-301); modem.stream.StreamDecoder is the chunked
array-program analog.  Frames fed incrementally must match
pipeline.decode_recording_auto on the full recording, emit BEFORE the
stream ends, and hold only a bounded buffer.
"""

import numpy as np
import pytest

from modem import bits as B
from modem import cplx
from modem.encoder import cached_encoder
from modem.ingest import PcmRecording
from modem.numerology import make_config
from modem.pipeline import decode_recording_auto
from modem.stream import StreamDecoder


@pytest.fixture(scope="module")
def two_frame_rec():
    rng = np.random.default_rng(31)
    payloads = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
                for _ in range(2)]
    cfg = make_config(8000, 10, 2300)
    wave, _ = cached_encoder(cfg).encode(payloads, B.base37_encode("AB1CDE"))
    rec = np.concatenate([np.zeros(8000, np.complex64), wave,
                          np.zeros(8000, np.complex64)])
    return rec, payloads


def _key(frames):
    return [(f["pos"], f["mode"], f["ok"], f["payload"]) for f in frames]


def test_stream_float_matches_batch(two_frame_rec):
    rec, payloads = two_frame_rec
    x = cplx.from_np(rec).astype(np.float32)
    ref = decode_recording_auto(x.copy(), 8000, channels=2)
    sd = StreamDecoder(8000, channels=2, bits=None)
    got, first_emit = [], None
    i = 0
    while i < len(x):
        out = sd.feed(x[i: i + 7001])
        if out and first_emit is None:
            first_emit = i + 7001
        got += out
        i += 7001
    got += sd.finish()
    assert _key(sorted(got, key=lambda f: f["pos"])) == _key(ref)
    assert [f["payload"] for f in got if f["ok"]] == payloads
    # live property: frame 0 emitted well before the stream ended
    assert first_emit is not None and first_emit < len(x) - 8000


def test_stream_mono_int16_matches_batch(two_frame_rec):
    rec, payloads = two_frame_rec
    mono = np.clip(np.rint(rec.real * 32767), -32768,
                   32767).astype(np.int16)
    pcm = PcmRecording(data=mono, bits=16, rate=8000)
    ref = decode_recording_auto(pcm, 8000, channels=1)
    sd = StreamDecoder(8000, channels=1, bits=16)
    got = []
    i = 0
    while i < len(mono):
        got += sd.feed(mono[i: i + 9000])
        i += 9000
    got += sd.finish()
    assert _key(sorted(got, key=lambda f: f["pos"])) == _key(ref)
    assert [f["payload"] for f in got if f["ok"]] == payloads
    # retirement keeps the analytic buffer bounded (frame span + lead,
    # far below the ~42 s recording)
    assert len(sd._an) < 80_000


def test_stream_rejects_float_mono():
    with pytest.raises(ValueError):
        StreamDecoder(8000, channels=1, bits=None)


def test_cli_decode_stream(two_frame_rec, tmp_path):
    from modem import wav
    from modem.cli import main
    rec, payloads = two_frame_rec
    wavf = str(tmp_path / "s.wav")
    wav.write_wav(wavf, rec.astype(np.complex64), 8000, 16, 2)
    prefix = str(tmp_path / "live")
    assert main(["decode-stream", prefix, wavf]) == 0
    assert (tmp_path / "live.000").read_bytes() == payloads[0]
    assert (tmp_path / "live.001").read_bytes() == payloads[1]

def test_stream_stereo_int16_and_mono_uint8(two_frame_rec):
    """The two remaining wire input paths: stereo int16 (on-device
    dequant, no Hilbert) and mono uint8 (128-offset silence fill)."""
    rec, payloads = two_frame_rec
    st = np.stack([rec.real, rec.imag], 1)
    sti = np.clip(np.rint(st * 32767), -32768, 32767).astype(np.int16)
    pcm = PcmRecording(data=sti, bits=16, rate=8000)
    ref = decode_recording_auto(pcm, 8000, channels=2)
    sd = StreamDecoder(8000, channels=2, bits=16)
    got = []
    i = 0
    while i < len(sti):
        got += sd.feed(sti[i: i + 9000])
        i += 9000
    got += sd.finish()
    assert _key(sorted(got, key=lambda f: f["pos"])) == _key(ref)
    assert [f["payload"] for f in got if f["ok"]] == payloads

    m8 = (np.clip(np.rint(rec.real * 127), -128, 127)
          + 128).astype(np.uint8)
    pcm8 = PcmRecording(data=m8, bits=8, rate=8000)
    ref8 = decode_recording_auto(pcm8, 8000, channels=1)
    sd = StreamDecoder(8000, channels=1, bits=8)
    got8 = []
    i = 0
    while i < len(m8):
        got8 += sd.feed(m8[i: i + 9000])
        i += 9000
    got8 += sd.finish()
    assert _key(sorted(got8, key=lambda f: f["pos"])) == _key(ref8)
    assert [f["payload"] for f in got8 if f["ok"]] == payloads

def test_cli_decode_stream_riff_quirks(two_frame_rec, tmp_path):
    """Odd-sized pre-data RIFF chunks are pad-aligned (RIFF word
    alignment); non-PCM / deep bit depths are rejected cleanly."""
    from modem import wav
    from modem.cli import main
    rec, payloads = two_frame_rec
    wavf = tmp_path / "s.wav"
    wav.write_wav(str(wavf), rec.astype(np.complex64), 8000, 16, 2)
    raw = wavf.read_bytes()
    # inject an odd-length junk chunk between fmt and data
    di = raw.index(b"data")
    junk = b"note" + (5).to_bytes(4, "little") + b"hello" + b"\x00"
    patched = tmp_path / "p.wav"
    patched.write_bytes(raw[:di] + junk + raw[di:])
    prefix = str(tmp_path / "q")
    assert main(["decode-stream", prefix, str(patched)]) == 0
    assert (tmp_path / "q.000").read_bytes() == payloads[0]

    # IEEE-float format tag must be rejected, not parsed as uint8
    bad = bytearray(raw)
    fi = raw.index(b"fmt ")
    bad[fi + 8: fi + 10] = (3).to_bytes(2, "little")
    badf = tmp_path / "f.wav"
    badf.write_bytes(bytes(bad))
    assert main(["decode-stream", prefix, str(badf)]) == 1

def test_stream_mixed_modes():
    """Two frames of DIFFERENT modes in one stream: each frame's mode
    comes from its own header and the payload stage groups per mode
    (the stream analog of decode_recording_auto's mixed-mode path)."""
    from modem.numerology import make_config as mk
    rng = np.random.default_rng(9)
    waves, payloads = [], []
    for mode, call in ((10, "AB1CDE"), (12, "N0CALL")):
        cfg = mk(8000, mode, 2000)
        p = rng.integers(0, 256, cfg.mode.data_bytes,
                         dtype=np.uint8).tobytes()
        wave, _ = cached_encoder(cfg).encode(p, B.base37_encode(call))
        waves.append(wave)
        payloads.append(p)
    gap = np.zeros(2000, dtype=np.complex64)
    rec = np.concatenate([gap, waves[0], gap, waves[1], gap])
    ref = decode_recording_auto(rec.copy(), 8000)
    x = cplx.from_np(rec).astype(np.float32)
    sd = StreamDecoder(8000, channels=2, bits=None)
    got = []
    i = 0
    while i < len(x):
        got += sd.feed(x[i: i + 8192])
        i += 8192
    got += sd.finish()
    got.sort(key=lambda f: f["pos"])
    assert _key(got) == _key(ref)
    assert [f["mode"] for f in got] == [10, 12]
    assert [f["call_sign"] for f in got] == ["AB1CDE", "N0CALL"]
    assert [f["payload"] for f in got] == payloads

def test_stream_silent_retirement():
    """A long event-free stream must not accumulate host buffers: the
    retirement watermark trims behind the scan horizon even when no
    candidate is pending."""
    sd = StreamDecoder(8000, channels=1, bits=16)
    chunk = np.zeros(sd.c, np.int16)
    for _ in range(40):
        assert sd.feed(chunk) == []
    assert len(sd._an) < 4 * sd.c
    assert len(sd._raw) < 4 * sd.c

def test_cli_decode_stream_trailing_chunk(two_frame_rec, tmp_path):
    """RIFF chunks AFTER the data body (LIST/INFO metadata many tools
    append) must not be parsed as PCM: the stream honors the declared
    data size."""
    from modem import wav
    from modem.cli import main
    rec, payloads = two_frame_rec
    wavf = tmp_path / "s.wav"
    wav.write_wav(str(wavf), rec.astype(np.complex64), 8000, 16, 2)
    raw = bytearray(wavf.read_bytes())
    junk = b"LIST" + (64).to_bytes(4, "little") + bytes(64)
    raw += junk
    # keep the RIFF size honest about the appended chunk
    riff_size = int.from_bytes(raw[4:8], "little") + len(junk)
    raw[4:8] = riff_size.to_bytes(4, "little")
    patched = tmp_path / "t.wav"
    patched.write_bytes(bytes(raw))
    prefix = str(tmp_path / "tc")
    assert main(["decode-stream", prefix, str(patched)]) == 0
    assert (tmp_path / "tc.000").read_bytes() == payloads[0]
    assert (tmp_path / "tc.001").read_bytes() == payloads[1]

def test_stream_16k_mono():
    """Rate plumbing: 16 kHz mono int16 stream (different symbol/guard
    lengths, Hilbert taps, front lead) matches the batch path."""
    rng = np.random.default_rng(13)
    payload = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    cfg = make_config(16000, 10, 2300)
    wave, _ = cached_encoder(cfg).encode([payload], B.base37_encode("AB1CDE"))
    rec = np.concatenate([np.zeros(16000, np.complex64), wave,
                          np.zeros(16000, np.complex64)])
    mono = np.clip(np.rint(rec.real * 32767), -32768,
                   32767).astype(np.int16)
    pcm = PcmRecording(data=mono, bits=16, rate=16000)
    ref = decode_recording_auto(pcm, 16000, channels=1)
    sd = StreamDecoder(16000, channels=1, bits=16)
    got = []
    i = 0
    while i < len(mono):
        got += sd.feed(mono[i: i + 17000])
        i += 17000
    got += sd.finish()
    assert _key(sorted(got, key=lambda f: f["pos"])) == _key(ref)
    assert got[0]["ok"] and got[0]["payload"] == payload

def test_stream_truncated_frame_past_recording_end(two_frame_rec):
    """Reference EOS semantics (decode.cc:296-297): a frame whose
    payload window extends past the true stream end is reported
    "past recording end" — never decoded against the silence pad."""
    rec, payloads = two_frame_rec
    x = cplx.from_np(rec).astype(np.float32)
    # cut mid-payload of frame 1: keep the second frame's preamble +
    # header but drop most of its payload rows.  Frame geometry: the
    # stream is [1s sil | pilot | frame0 | frame1 | flush | 1s sil].
    cfg = make_config(8000, 10, 2300)
    fsamp = cfg.frame_samples
    cut = 8000 + cfg.extended_len + fsamp + 4 * cfg.extended_len
    sd = StreamDecoder(8000, channels=2, bits=None)
    got = []
    i = 0
    while i < cut:
        got += sd.feed(x[i: min(i + 7001, cut)])
        i += 7001
    got += sd.finish()
    got.sort(key=lambda f: f["pos"])
    assert len(got) == 2
    assert got[0]["ok"] and got[0]["payload"] == payloads[0]
    assert not got[1]["ok"]
    assert got[1]["status"] == "past recording end"
    # the header HAD decoded (mode known) before the truncation hit
    assert got[1]["mode"] == 10

def test_stream_single_big_feed_matches_batch(two_frame_rec):
    """Whole-recording single feed: every chunk is ready at once, so
    the scan runs multi-chunk super-batches (m up to 16) — the file-
    replay fast path must produce exactly the live-paced result."""
    rec, payloads = two_frame_rec
    x = cplx.from_np(rec).astype(np.float32)
    ref = decode_recording_auto(x.copy(), 8000, channels=2)
    sd = StreamDecoder(8000, channels=2, bits=None)
    got = sd.feed(x)
    got += sd.finish()
    assert _key(sorted(got, key=lambda f: f["pos"])) == _key(ref)
    assert [f["payload"] for f in got if f["ok"]] == payloads

def test_stream_big_feed_mono_int16(two_frame_rec):
    """Same through the wire-dtype retain path (mono int16): the
    multi-chunk retain keep-blocks must assemble the identical
    analytic buffer."""
    rec, payloads = two_frame_rec
    mono = np.clip(np.rint(rec.real * 32767), -32768,
                   32767).astype(np.int16)
    pcm = PcmRecording(data=mono, bits=16, rate=8000)
    ref = decode_recording_auto(pcm, 8000, channels=1)
    sd = StreamDecoder(8000, channels=1, bits=16)
    got = sd.feed(mono)
    got += sd.finish()
    assert _key(sorted(got, key=lambda f: f["pos"])) == _key(ref)
    assert [f["payload"] for f in got if f["ok"]] == payloads
