"""Batched pipeline + sharded decode on the toy configuration."""

import jax
import numpy as np
import pytest

from modem import bits as B
from modem.parallel import (make_mesh, sharded_decode, toy_config,
                                toy_pipeline, toy_recordings)


@pytest.fixture(scope="module")
def toy_batch():
    recs, payloads = toy_recordings(4, seed=3)
    return recs, payloads


def test_toy_batch_pipeline(toy_batch):
    recs, payloads = toy_batch
    pipe = toy_pipeline()
    res = pipe.decode_batch(recs)
    ok = np.asarray(res["ok"])
    assert ok.all(), np.asarray(res["sync_gate"])
    for i, want in enumerate(payloads):
        assert pipe.payload_bytes(res, i) == want
    assert np.asarray(res["flips"]).max() == 0


def test_multiframe_recording_flagged(toy_batch):
    """BatchPipeline's single-frame-per-recording contract is guarded:
    a TWO-frame recording fed to decode_batch raises the `multiframe`
    flag (a second Schmitt-level timing peak outside the committed
    preamble's span) instead of silently decoding whichever frame wins
    the argmax; clean one-frame windows keep it False."""
    recs, payloads = toy_batch
    pipe = toy_pipeline()
    one = np.asarray(recs[0])
    two = np.concatenate([one, np.asarray(recs[1])], axis=0)
    batch = np.stack([two, np.concatenate([one, np.zeros_like(one)],
                                          axis=0)])
    res = pipe.decode_batch(batch)
    flag = np.asarray(res["multiframe"])
    assert flag[0] and not flag[1], flag
    # the single-frame windows of the ordinary batch stay unflagged
    res1 = pipe.decode_batch(recs)
    assert not np.asarray(res1["multiframe"]).any()


def test_toy_staged_matches_whole(toy_batch):
    recs, payloads = toy_batch
    pipe = toy_pipeline()
    res = pipe.decode_batch(recs, staged=True)
    assert np.asarray(res["ok"]).all()
    for i, want in enumerate(payloads):
        assert pipe.payload_bytes(res, i) == want


def test_toy_sharded_decode(toy_batch):
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    recs, payloads = toy_recordings(8, seed=4)
    mesh = make_mesh(min(8, len(jax.devices())))
    pipe = toy_pipeline()
    n = mesh.devices.size
    fn = sharded_decode(pipe, mesh)
    out = fn(recs[:n])
    bits = np.asarray(out["bits"])
    assert bits.shape == (n, toy_config().mode.data_bits)
    assert np.asarray(out["ok"]).all()
    for i in range(n):
        got = B.scramble(B.bits_to_bytes_le(bits[i]))
        assert got == payloads[i]


def test_sharded_sync_scan_matches_single_device():
    """Context-parallel chunk scan over the mesh: candidates must be
    exactly those of the single-device scan (cross-device Schmitt and
    argmax carries recovered by composing per-chunk summaries)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from modem.parallel import sharded_sync
    from modem.sync import Synchronizer

    recs, _ = toy_recordings(1, seed=5)
    x = np.concatenate([np.asarray(recs[0])] * 6, axis=0)
    rng = np.random.default_rng(7)
    x = x + rng.normal(0, 0.02, x.shape).astype(np.float32)
    cfg = toy_config()
    mesh = make_mesh(min(8, len(jax.devices())))
    ref = Synchronizer(cfg).scan(x, max_candidates=8,
                                 chunk_samples=2048)
    got = sharded_sync(cfg, mesh).scan(x, max_candidates=8,
                                       chunk_samples=2048)
    assert sum(c.ok for c in ref) >= 5
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert (a.p0, a.ok) == (b.p0, b.ok)
        assert abs(a.cfo_rad - b.cfo_rad) < 1e-6


def test_sharded_decode_recording_matches_single_device():
    """Capstone multi-chip serving path: mesh-sharded sync scan +
    frame-batch DP decode of one long recording must reproduce the
    single-device decode_recording byte-for-byte."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from modem.parallel import sharded_decode_recording

    recs, payloads = toy_recordings(1, seed=8)
    x = np.concatenate([np.asarray(recs[0])] * 6, axis=0)
    pipe = toy_pipeline()
    mesh = make_mesh(min(8, len(jax.devices())))
    ref, pos_ref = pipe.decode_recording(x, max_frames=8)
    got, pos = sharded_decode_recording(pipe, mesh, x, max_frames=8)
    assert list(pos) == list(pos_ref)
    assert np.asarray(got["ok"]).all()
    for i in range(len(pos)):
        assert pipe.payload_bytes(got, i) == payloads[0]
        assert pipe.payload_bytes(got, i) == pipe.payload_bytes(ref, i)


def test_toy_frame_has_wire_structure():
    cfg = toy_config()
    assert cfg.symbol_len == 256
    assert 2 * cfg.mls0_len <= cfg.symbol_len     # preamble fits
    assert cfg.mls1_len <= cfg.symbol_len
    assert cfg.mode.cons_bits % (cfg.mode.mod_bits *
                                 cfg.mode.cons_cols) == 0


def test_sharded_decode_recording_pcm_wire_input():
    """The mesh-sharded recording path composes with wire-dtype PCM
    ingest (decode.cc:294-301 on device): int16 stereo input through
    sharded_sync + frame-batch DP must match the single-device
    PcmRecording path byte-for-byte."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from modem.ingest import PcmRecording
    from modem.parallel import sharded_decode_recording

    recs, payloads = toy_recordings(4, seed=2)
    x = np.concatenate([np.asarray(r) for r in recs], axis=0)
    sti = np.clip(np.rint(x * 32767), -32768, 32767).astype(np.int16)
    pipe = toy_pipeline()

    def mkpcm():
        return PcmRecording(data=sti.copy(), bits=16,
                            rate=pipe.cfg.rate)

    mesh = make_mesh(min(8, len(jax.devices())))
    ref, pos_ref = pipe.decode_recording(mkpcm(), max_frames=8)
    got, pos = sharded_decode_recording(pipe, mesh, mkpcm(),
                                        max_frames=8)
    assert list(pos) == list(pos_ref)
    assert np.asarray(got["ok"]).all()
    for i in range(len(pos)):
        assert pipe.payload_bytes(got, i) == payloads[i]
        assert pipe.payload_bytes(got, i) == pipe.payload_bytes(ref, i)


def test_strided_sync_matches_exact():
    """The batch path's strided coarse metric (sync_stride=8,
    sync._metrics_parts_strided) must decode exactly what the
    full-rate metric decodes — the <=stride coarse-quantization is
    absorbed by the fine stage's pos_err correction
    (decode.cc:143-146) — on clean AND noisy recordings."""
    from modem.pipeline import BatchPipeline

    recs, payloads = toy_recordings(4, seed=11)
    rng = np.random.default_rng(13)
    noisy = np.asarray(recs) + rng.normal(
        0, 0.05, np.asarray(recs).shape).astype(np.float32)
    cfg = toy_config()
    pipes = {}
    for stride in (8, 1):
        pipes[stride] = BatchPipeline(
            rate=cfg.rate, oper_mode=0, list_size=4,
            mode_spec=cfg.mode, symbol_len_override=cfg.symbol_len,
            sync_stride=stride)
    assert pipes[8].sync_stride == 8 and pipes[1].sync_stride == 1
    for batch in (np.asarray(recs), noisy):
        res8 = pipes[8].decode_batch(batch)
        res1 = pipes[1].decode_batch(batch)
        assert np.asarray(res8["ok"]).all()
        assert (np.asarray(res8["ok"]) == np.asarray(res1["ok"])).all()
        assert (np.asarray(res8["bits"]) == np.asarray(res1["bits"])).all()
        # strided coarse p0 lands within one stride of the exact one
        # BEFORE fine correction; after it they must agree exactly
        assert (np.asarray(res8["p0"]) == np.asarray(res1["p0"])).all()
    for i, want in enumerate(payloads):
        assert pipes[8].payload_bytes(res1, i) == want


def test_sync_stride_fallback_when_indivisible():
    """44.1 kHz has match_del = 441 (not a multiple of 8): the
    pipeline must fall back to the exact full-rate metric rather than
    misalign the phase readout."""
    from modem.pipeline import BatchPipeline

    pipe = BatchPipeline(44100, 6)
    assert pipe.sync_stride == 1
