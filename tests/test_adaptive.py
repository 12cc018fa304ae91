"""Adaptive (SC -> exact-SCL) decode path: L=1 parity + pipeline.

The serving fast path decodes every frame with plain successive
cancellation (the list_size=1 schedule VM) and escalates only
CRC-failing frames to the exact list decoder — reference
path-selection semantics (decode.cc:530-555) with the same ~2^-32 CRC
false-accept exposure.  These tests pin:

  * L=1 bit-exactness of the VM against the numpy oracle, exact AND
    fast modes (the batched VM's L=1 parity is in test_scl_batch.py);
  * AdaptivePipeline == BatchPipeline on every result key for batches
    with failures (the fallback returns the exact-SCL result
    verbatim), and zero-fallback clean batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modem.fec.polar import PolarCode
from modem.fec.scl_np import scl_decode_np
from modem.fec.scl_vm import make_decoder
from modem.parallel import toy_config, toy_recordings
from modem.pipeline import AdaptivePipeline, BatchPipeline

TOY = PolarCode(n=224, k=144, order=8)


@pytest.fixture(scope="module")
def toy_llrs():
    rng = np.random.default_rng(9)
    m = rng.integers(0, 2, TOY.mesg_bits, dtype=np.uint8)
    m[TOY.k:] = 0
    cw = TOY.encode_systematic_np(m)
    tx = 1.0 - 2.0 * TOY.shorten_np(cw).astype(np.float64)
    llrs = np.stack([
        TOY.lengthen_np(2 * (tx + 0.9 * rng.standard_normal(TOY.n))
                        / 0.81) for _ in range(8)]).astype(np.float32)
    return llrs


@pytest.mark.parametrize("exact", [True, False])
def test_vm_l1_matches_numpy_sc(toy_llrs, exact):
    """The VM at list_size=1 IS successive cancellation: codeword and
    path metric equal the numpy oracle's single path on every frame
    (exact and fast modes coincide at L=1 — zero fork rounds)."""
    dec = jax.jit(jax.vmap(make_decoder(TOY.frozen, 1, exact=exact)))
    cws, pm = (np.asarray(v) for v in dec(jnp.asarray(toy_llrs)))
    for b in range(toy_llrs.shape[0]):
        cnp, pnp = scl_decode_np(toy_llrs[b].astype(np.float64),
                                 TOY.frozen, 1)
        assert (cws[b] == cnp).all()
        assert np.allclose(pm[b], pnp, rtol=1e-4, atol=1e-2)


@pytest.fixture(scope="module")
def toy_adaptive():
    cfg = toy_config()
    return AdaptivePipeline(rate=cfg.rate, oper_mode=0, list_size=4,
                            mode_spec=cfg.mode,
                            symbol_len_override=cfg.symbol_len)


@pytest.fixture(scope="module")
def toy_scl():
    cfg = toy_config()
    return BatchPipeline(rate=cfg.rate, oper_mode=0, list_size=4,
                         mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len)


def test_adaptive_clean_batch(toy_adaptive):
    """Clean frames all pass SC: zero escalations, exact payloads."""
    recs, payloads = toy_recordings(4, seed=3)
    res = toy_adaptive.decode_batch(recs)
    assert res["ok"].all()
    assert toy_adaptive.last_fallbacks == 0
    for i, want in enumerate(payloads):
        assert toy_adaptive.payload_bytes(res, i) == want
    assert res["flips"].max() == 0


def test_adaptive_matches_pure_scl_with_failures(toy_adaptive,
                                                 toy_scl):
    """A batch noisy enough that SC fails on most frames: the
    escalated frames return the exact list decoder's result verbatim,
    so the adaptive output equals BatchPipeline's on EVERY key — and
    the fallback genuinely adds sensitivity (>= 1 frame SC lost is
    recovered by SCL at this noise point)."""
    recs, payloads = toy_recordings(8, seed=3)
    rng = np.random.default_rng(42)
    noisy = (np.asarray(recs)
             + 0.3 * rng.standard_normal(np.asarray(recs).shape)
             .astype(np.float32))
    res_a = toy_adaptive.decode_batch(noisy)
    assert toy_adaptive.last_fallbacks > 0
    res_b = toy_scl.fetch(toy_scl.decode_batch(noisy))
    for k in res_a:
        assert (np.asarray(res_a[k]) == np.asarray(res_b[k])).all(), k
    # the SCL fallback recovered at least one SC-failed frame
    rec_ok = [i for i in np.flatnonzero(res_a["ok"])
              if toy_adaptive.payload_bytes(res_a, i) == payloads[i]]
    assert len(rec_ok) >= 1


def test_adaptive_decode_recording(toy_adaptive):
    """decode_recording on a two-frame recording routes through the
    scan + windows path and decodes both frames via SC."""
    recs, payloads = toy_recordings(2, seed=5)
    one = np.asarray(recs)
    x = np.concatenate([one[0], one[1]], axis=0)
    res, pos = toy_adaptive.decode_recording(x)
    assert len(pos) == 2 and res["ok"].all()
    for i, want in enumerate(payloads):
        assert toy_adaptive.payload_bytes(res, i) == want


@pytest.mark.slow
def test_adaptive_decode_recording_auto_wire():
    """Wire-size adaptive decode-all: a two-frame mode-6 recording
    through decode_recording_auto(adaptive=True) — clean frames all
    take the SC path and the payloads are exact (the group pipeline
    is AdaptivePipeline)."""
    from modem import bits as B
    from modem.encoder import cached_encoder
    from modem.numerology import make_config
    from modem.pipeline import decode_recording_auto

    cfg = make_config(8000, 6, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(2)]
    wave, _ = enc.encode(payloads, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])
    frames = decode_recording_auto(rec, 8000, adaptive=True)
    assert len(frames) == 2
    for f, want in zip(frames, payloads):
        assert f["ok"] and f["mode"] == 6 and f["payload"] == want
