#!/usr/bin/env python
"""Decode a one-hour recording in constant device memory.

SURVEY §5 long-signal analog: the reference
decodes arbitrarily long streams through a fixed 8,640-sample BipBuffer
(decode.cc:188-194).  Here a 1-hour 8 kHz recording (28.8M samples)
holding N frames at random offsets is scanned by the CHUNKED
Schmidl-Cox pass and every found frame batch-decodes in one jitted
call.

Round 3: the recording is a mono int16 PCM stream by default (the
reference's acoustic use case, decode.cc:294-301: 16-bit WAV ->
dequantise -> BlockDC -> Hilbert) — raw samples go to the device in
wire dtype (2 B/sample vs 8 B/sample f32 split-complex) and the
front-end runs ON DEVICE inside the chunk graphs (modem/ingest.py).
``--f32`` restores the round-2 split-complex input.  Reported numbers:
cold (compile) pass, then warm end-to-end, plus a measured
transfer-vs-device split (a pure device_put of the same chunk bytes).

Usage: python bench/long_recording.py [hours] [n_frames] [--f32]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from modem import bits as B
    from modem.encoder import Encoder
    from modem.ingest import PcmRecording
    from modem.numerology import make_config
    from modem.pipeline import BatchPipeline

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    use_f32 = "--f32" in sys.argv
    hours = float(args[0]) if args else 1.0
    n_frames = int(args[1]) if len(args) > 1 else 12
    rate = 8000
    cfg = make_config(rate, 6, 2000)
    t_total = int(hours * 3600 * rate)

    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(n_frames)]
    enc = Encoder(cfg)
    waves, _ = enc.encode_batch(payloads, B.base37_encode("N0CALL"))
    waves = np.asarray(waves)
    flen = waves.shape[1]

    # non-overlapping random frame starts with 1 s clearance
    gap = rate
    slot = (t_total - gap) // n_frames
    assert slot > flen + gap, "recording too short for n_frames"
    starts = np.sort(rng.integers(0, slot - flen - gap, n_frames)
                     + np.arange(n_frames) * slot + gap)

    if use_f32:
        x = np.zeros((t_total, 2), dtype=np.float32)
        for s, w in zip(starts, waves):
            x[s: s + flen, 0] = w.real
            x[s: s + flen, 1] = w.imag
        x += 1e-4 * rng.standard_normal(x.shape).astype(np.float32)
        rec = x
        nbytes = x.nbytes
        kind = "f32 split-complex"
    else:
        # mono real recording, quantised to the 16-bit wire format
        xm = np.zeros(t_total, dtype=np.float32)
        for s, w in zip(starts, waves):
            xm[s: s + flen] += w.real
        xm += 1e-4 * rng.standard_normal(t_total).astype(np.float32)
        q = np.clip(np.rint(xm * 32767.0), -32768, 32767).astype(
            np.int16)
        rec = PcmRecording(data=q, bits=16, rate=rate)
        nbytes = q.nbytes
        kind = "mono int16 PCM"
    print(f"# recording: {hours:.2f} h = {t_total} samples, {kind} "
          f"({nbytes / 1e6:.0f} MB host), {n_frames} frames",
          file=sys.stderr, flush=True)

    pipe = BatchPipeline(rate, 6)

    def one_pass(tag):
        t0 = time.time()
        res, pos = pipe.decode_recording(rec, max_frames=n_frames + 4)
        dt = time.time() - t0
        ok = np.asarray(res["ok"])
        exact = sum(pipe.payload_bytes(res, i) == payloads[j]
                    for j, s in enumerate(starts)
                    for i, p in enumerate(pos)
                    if abs(int(p) - int(s)) < rate)
        print(f"# {tag}: found {len(pos)}, ok {int(ok.sum())}, "
              f"byte-exact {exact}/{n_frames}; {dt:.1f} s "
              f"({hours * 3600 / dt:.0f}x real time end-to-end)",
              file=sys.stderr, flush=True)
        return dt, exact

    one_pass("cold")
    dt_warm, exact = one_pass("warm")

    # transfer-vs-device split: pure device_put of the same chunk bytes
    # (chunk shape + context overhead as _events_device ships them)
    sync = pipe.sync
    c = sync.CHUNK_SMALL
    fl = sync.front_lead if not use_f32 else 0
    ctx = -(-(2 * sync.L + sync.match_len) // 512) * 512
    want = fl + ctx + c + 2 * sync.L
    n_chunks = -(-(t_total - 2 * sync.L) // c)
    if use_f32:
        seg = np.zeros((16, want, 2), np.float32)
    else:
        seg = rec.data[: 16 * want].reshape(16, want).copy()
    t0 = time.time()
    done = None
    for _ in range(-(-n_chunks // 16)):
        done = jax.device_put(seg)
    np.asarray(done)     # wait for the last copy
    t_xfer = time.time() - t0
    print(f"# transfer-only (same bytes, device_put): {t_xfer:.1f} s "
          f"-> est. device+dispatch {max(dt_warm - t_xfer, 0):.1f} s",
          file=sys.stderr, flush=True)
    print(f'{{"hours": {hours}, "kind": "{kind}", '
          f'"warm_s": {dt_warm:.2f}, '
          f'"x_realtime": {hours * 3600 / dt_warm:.0f}, '
          f'"transfer_s": {t_xfer:.2f}, '
          f'"byte_exact": {exact}, "n_frames": {n_frames}}}')
    return 0 if exact == n_frames else 1


if __name__ == "__main__":
    sys.exit(main())
