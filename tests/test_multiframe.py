"""Multi-frame encode + SKIP-selected decode (decode.cc:448,583-585).

Multiple input blocks emit back-to-back frames (encode.cc:289); the
decoder's SKIP argument selects which frame to decode.
"""

import numpy as np
import pytest

from modem import bits as B
from modem.decoder import cached_decoder
from modem.encoder import cached_encoder
from modem.numerology import make_config


@pytest.fixture(scope="module")
def two_frames():
    cfg = make_config(8000, 6, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(2)]
    wave, _ = enc.encode(payloads, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])
    # two frames -> recording long enough for both
    assert len(wave) == (1 + 2 * cfg.frame_symbols + 1) * cfg.extended_len
    return cfg, payloads, rec


def test_skip_selects_frame(two_frames):
    cfg, payloads, rec = two_frames
    dec = cached_decoder(8000)
    r0 = dec.decode(rec, channels=2, skip=0)
    assert r0.ok and r0.payload == payloads[0]
    r1 = dec.decode(rec, channels=2, skip=1)
    assert r1.ok and r1.payload == payloads[1]
    # the second frame's preamble sits one frame later
    assert (r1.symbol_pos - r0.symbol_pos) == cfg.frame_samples


def test_decode_recording_batches_all_frames(two_frames):
    """Serving path: every frame in one recording decodes in a single
    batched call (pipeline.decode_recording)."""
    from modem.pipeline import cached_pipeline

    cfg, payloads, rec = two_frames
    pipe = cached_pipeline(8000, 6)
    res, pos = pipe.decode_recording(rec)
    assert res is not None and len(pos) == 2
    assert (pos[1] - pos[0]) == cfg.frame_samples
    assert np.asarray(res["ok"]).all()
    for i, want in enumerate(payloads):
        assert pipe.payload_bytes(res, i) == want


def test_decode_recording_auto_mixed_modes():
    """Auto-mode serving: two frames of DIFFERENT modes in one
    recording; mode + callsign come from each frame's header
    (decode.cc:398-446), then each mode group batch-decodes."""
    from modem.pipeline import decode_recording_auto

    rng = np.random.default_rng(9)
    waves, payloads = [], []
    for mode, call in ((10, "AB1CDE"), (12, "N0CALL")):
        cfg = make_config(8000, mode, 2000)
        enc = cached_encoder(cfg)
        p = rng.integers(0, 256, cfg.mode.data_bytes,
                         dtype=np.uint8).tobytes()
        wave, _ = enc.encode(p, B.base37_encode(call))
        waves.append(wave)
        payloads.append(p)
    gap = np.zeros(2000, dtype=np.complex64)
    rec = np.concatenate([gap, waves[0], gap, waves[1], gap])
    out = decode_recording_auto(rec, 8000)
    assert len(out) == 2
    assert [f["mode"] for f in out] == [10, 12]
    assert [f["call_sign"] for f in out] == ["AB1CDE", "N0CALL"]
    assert all(f["ok"] for f in out)
    assert [f["payload"] for f in out] == payloads
    assert out[1]["pos"] > out[0]["pos"]


def test_decode_recording_auto_reports_header_rejects(two_frames):
    """Auto-mode observability: a preamble whose HEADER is destroyed
    surfaces as a reject entry with the reference's rejection text
    (decode.cc:417-446) instead of silently disappearing, while the
    good frame still decodes."""
    from modem.pipeline import decode_recording_auto

    cfg, payloads, rec = two_frames
    rec = np.array(rec)
    s, g = cfg.symbol_len, cfg.guard_len
    pos1 = 8000 + cfg.extended_len + cfg.frame_samples  # 2nd frame p0
    rng = np.random.default_rng(11)
    lo = pos1 + s + g                  # metadata (header) symbol
    rec[lo: lo + s + g] = 0.3 * (
        rng.standard_normal(s + g) + 1j * rng.standard_normal(s + g))
    out = decode_recording_auto(rec, 8000)
    good = [f for f in out if f["mode"] is not None]
    rejected = [f for f in out if f["mode"] is None]
    assert len(good) == 1 and good[0]["ok"]
    assert good[0]["payload"] == payloads[0]
    assert good[0]["status"] == "ok"
    assert len(rejected) == 1
    assert rejected[0]["status"] in ("OSD error.", "header CRC error.",
                                     "call sign unsupported.") or \
        rejected[0]["status"].endswith("unsupported.")
    assert rejected[0]["pos"] > good[0]["pos"]


def test_decode_recording_isolates_corrupt_frame(two_frames):
    """A destroyed frame must fail alone: its neighbors still decode
    bit-exact through the batched serving path."""
    from modem.pipeline import cached_pipeline

    cfg, payloads, rec = two_frames
    rec = np.array(rec)
    # obliterate the second frame's payload region (keep its preamble
    # so it is still detected)
    pos1 = 8000 + cfg.extended_len + cfg.frame_samples  # 2nd frame p0
    lo = pos1 + 3 * cfg.extended_len
    rec[lo: lo + 40 * cfg.extended_len] = 0.0
    pipe = cached_pipeline(8000, 6)
    res, pos = pipe.decode_recording(rec)
    assert len(pos) == 2
    ok = np.asarray(res["ok"])
    assert bool(ok[0]) and pipe.payload_bytes(res, 0) == payloads[0]
    assert not bool(ok[1])          # CRC gate rejects the wreck


def test_chunked_encode_matches_whole_graph():
    """The pow2-ladder chunked continuous encode (bounded compiled
    graphs for ANY file count) must reproduce the whole-transmission
    graph to f32 reassociation tolerance — 1 ULP measured; far below
    the int16 wire quantisation step."""
    import jax
    import jax.numpy as jnp

    from modem import cplx
    from modem.parallel import toy_config

    cfg = toy_config()
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(0)
    whole = jax.jit(enc._encode_traced, static_argnames=("n_frames",))
    for n in (1, 3, 9):
        payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                                 dtype=np.uint8).tobytes()
                    for _ in range(n)]
        w_new, p_new = enc.encode(payloads, B.base37_encode("TOY"))
        ps = [B.scramble(p) for p in payloads]
        mesg = np.stack([enc.mesg_bits(p) for p in ps])
        meta = np.broadcast_to(
            cplx.from_np(enc.meta_fdom(B.base37_encode("TOY"))),
            (n, cfg.symbol_len, 2))
        w_old, p_old = whole(jnp.asarray(mesg), jnp.asarray(meta),
                             n_frames=n)
        assert np.allclose(w_new, cplx.to_np(np.asarray(w_old)),
                           atol=1e-6)
        assert np.allclose(p_new, np.asarray(p_old), rtol=1e-5,
                           atol=1e-7)
