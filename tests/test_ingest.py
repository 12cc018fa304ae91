"""Device-side PCM ingest (ingest.py): wire-dtype transfer + on-device
dequantise / DC-block / Hilbert, parity vs the host-numpy spec.

The reference reads int16/uint8 WAV and converts on the host
(decode.cc:294-301); here the raw samples go to the device and the
front-end runs inside the chunked scan graphs.  The contract mirrors
test_sync: candidates from the device PCM path must equal the host
spec path (PcmRecording.analytic_np -> metrics_host edge walk)
exactly.
"""

import numpy as np
import pytest

from modem import bits as B
from modem import dsp, wav
from modem.ingest import PcmRecording, front_lead
from modem.parallel import toy_config, toy_pipeline, toy_recordings
from modem.sync import Synchronizer


def _toy_offset_config():
    """Toy numerology at freq_off=2000 Hz: the mono (real-signal) path
    needs the band away from DC for the Hilbert front-end (the rx side
    is offset-free — the integer-CFO search absorbs it)."""
    import dataclasses

    cfg = toy_config()
    return dataclasses.replace(cfg, freq_off=2000)


def _toy_pcm(n_copies=5, seed=3, noise=0.01, bits=16, stereo=False):
    from modem import cplx
    from modem.encoder import cached_encoder

    cfg = _toy_offset_config()
    enc = cached_encoder(cfg)
    rng0 = np.random.default_rng(seed)
    payload = rng0.integers(0, 256, cfg.mode.data_bytes,
                            dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("TOY"))
    sil = np.zeros(cfg.symbol_len, dtype=np.complex64)
    one = cplx.from_np(np.concatenate([sil, np.asarray(wave), sil]))
    payloads = [payload]
    x = np.concatenate([np.asarray(one)] * n_copies, axis=0)
    rng = np.random.default_rng(42)
    x = x + rng.normal(0, noise, x.shape).astype(np.float32)
    x = x * (0.5 / np.abs(x).max())   # healthy quantisation headroom
    if not stereo:
        x = x[:, 0]
    if bits == 16:
        q = np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)
    else:
        q = (np.clip(np.rint(x * 127.0), -128, 127) + 128).astype(np.uint8)
    return PcmRecording(data=q, bits=bits, rate=8000), payloads


@pytest.mark.parametrize("bits,stereo", [(16, False), (16, True),
                                         (8, False)])
def test_pcm_scan_matches_host_spec(bits, stereo):
    """Device PCM candidate extraction == host spec front-end + edge
    walk, for mono (DC+Hilbert on device) and stereo (dequant only),
    int16 and uint8, across chunk sizes sweeping the S&C plateaus."""
    pcm, _ = _toy_pcm(bits=bits, stereo=stereo)
    sync = Synchronizer(toy_config())
    host = sync.scan(pcm, max_candidates=8, host=True)
    # the toy mono geometry is gate-marginal (21-tap Hilbert image
    # leakage cuts peak ratios ~8x vs stereo); the CI contract here is
    # device==host PARITY over the full candidate list, ok or not
    assert sum(c.ok for c in host) >= 3
    assert len(host) >= 5
    for chunk in (1024, 2048, None):
        dev = sync.scan(pcm, max_candidates=8, chunk_samples=chunk)
        assert len(dev) == len(host), chunk
        for a, b in zip(host, dev):
            assert (a.p0, a.ok) == (b.p0, b.ok), chunk
            assert abs(a.cfo_rad - b.cfo_rad) < 1e-6, chunk
            assert abs(a.frac_cfo - b.frac_cfo) < 1e-6, chunk


def test_analytic_np_matches_dsp_frontend():
    """The host spec front-end must agree with the jitted dsp.frontend
    the interactive decoder uses (same DC window / taps)."""
    import jax.numpy as jnp

    pcm, _ = _toy_pcm(n_copies=2)
    cfg = toy_config()
    dcw, taps = 2 * cfg.extended_len, cfg.filter_len
    spec = pcm.analytic_np(dcw, taps)
    ref = np.asarray(dsp.frontend(jnp.asarray(pcm.dequant_np()),
                                  1, dcw, taps))
    assert np.allclose(spec, ref, rtol=1e-4, atol=2e-5)


def test_analytic_chunk_matches_np():
    """Per-chunk device front-end == whole-recording numpy spec on the
    chunk's output span (512-aligned chunk, context carried)."""
    import jax
    import jax.numpy as jnp

    pcm, _ = _toy_pcm(n_copies=2)
    cfg = toy_config()
    dcw, taps = 2 * cfg.extended_len, cfg.filter_len
    fl = front_lead(dcw, taps)
    full = pcm.analytic_np(dcw, taps)
    from modem.ingest import analytic_chunk
    n0, out_len = 1024, 2048        # both multiples of 512
    raw = np.zeros(fl + out_len, pcm.data.dtype)
    lo = n0 - fl
    seg = pcm.data[max(lo, 0): lo + fl + out_len]
    raw[max(0, -lo): max(0, -lo) + len(seg)] = seg
    got = np.asarray(jax.jit(
        lambda r, a: analytic_chunk(r, a, fl, out_len, 16, dcw, taps)
    )(jnp.asarray(raw), jnp.int32(lo)))
    assert np.allclose(got, full[n0: n0 + out_len], rtol=1e-4,
                       atol=2e-5)


@pytest.mark.parametrize("bits,stereo", [(16, False), (16, True),
                                         (8, False)])
def test_pcm_decode_recording(bits, stereo):
    """End-to-end: PcmRecording -> decode_recording byte-exact (the
    device-resident analytic windows feed the batch decode without a
    host round trip)."""
    pcm, payloads = _toy_pcm(n_copies=3, noise=0.005, bits=bits,
                             stereo=stereo)
    pipe = toy_pipeline()
    res, pos = pipe.decode_recording(pcm, max_frames=8)
    # mono detection is gate-marginal at toy scale (see above): >= 1
    # frame must survive and every surviving frame must be byte-exact;
    # stereo has full margins
    need = 1 if not stereo else 3
    assert res is not None and len(pos) >= need
    ok = np.asarray(res["ok"])
    assert ok[: len(pos)].sum() >= need
    for i in range(len(pos)):
        if ok[i]:
            assert pipe.payload_bytes(res, i) == payloads[0]


@pytest.mark.parametrize("bits,stereo", [(16, False), (16, True),
                                         (8, False)])
def test_cached_windows_match_raw_path(bits, stereo):
    """sync.scan retains the on-device analytic recording
    (pcm._analytic_dev) and _pcm_windows slices it directly; those
    windows must match the raw-PCM re-front-end path to f32
    reassociation tolerance, including spans reaching past the
    recording edges (zero-pad parity)."""
    import jax.numpy as jnp

    pcm, _ = _toy_pcm(n_copies=2, bits=bits, stereo=stereo)
    sync = Synchronizer(toy_config())
    sync.scan(pcm, max_candidates=8)
    an = getattr(pcm, "_analytic_dev", None)
    assert an is not None            # retention on for small PCM
    t = pcm.n_samples
    assert an.shape[0] >= t
    out_len = 3000
    starts = [-500, 0, 137, t // 2, t - out_len, t - 100]
    cached = np.asarray(sync._cached_windows(an, starts, out_len))
    del pcm._analytic_dev            # force the raw re-front-end path
    raw = np.asarray(sync._pcm_windows(pcm, starts, out_len))
    assert cached.shape == raw.shape == (len(starts), out_len, 2)
    assert np.allclose(cached, raw, rtol=1e-4, atol=2e-5)


def test_read_wav_raw_roundtrip(tmp_path):
    """write_wav -> read_wav_raw keeps wire dtype and samples."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 0.1).astype(np.float32)
    for bits, dt in ((16, np.int16), (8, np.uint8)):
        p = str(tmp_path / f"t{bits}.wav")
        wav.write_wav(p, x, 8000, bits=bits, channels=1)
        pcm = wav.read_wav_raw(p)
        assert pcm is not None and pcm.bits == bits
        assert pcm.data.dtype == dt and pcm.channels == 1
        assert pcm.rate == 8000
        ref = wav.read_wav(p)
        assert np.allclose(pcm.dequant_np().reshape(-1),
                           ref.samples[:, 0], atol=1e-7)
