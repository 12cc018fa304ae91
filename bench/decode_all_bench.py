#!/usr/bin/env python
"""Throughput of the auto-mode serving path (CLI `decode-all`).

decode_recording_auto: chunk-scanned sync -> ONE batched header
demod+OSD jit over all preambles -> per-mode batched payload decode.
Steady-state timing on the second pass (first pass compiles).

Usage: python bench/decode_all_bench.py [n_frames]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from modem import bits as B
    from modem.encoder import Encoder
    from modem.numerology import make_config
    from modem.pipeline import decode_recording_auto

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    use_f32 = "--f32" in sys.argv
    n = int(args[0]) if args else 16
    rate = 8000
    cfg = make_config(rate, 6, 2000)
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes() for _ in range(n)]
    enc = Encoder(cfg)
    waves, _ = enc.encode_batch(payloads, B.base37_encode("N0MODEM"))
    gap = rate // 2
    flen = waves.shape[1]
    if use_f32:
        x = np.zeros(((flen + gap) * n + gap, 2), dtype=np.float32)
        for i, w in enumerate(waves):
            s = gap + i * (flen + gap)
            x[s: s + flen, 0] = w.real
            x[s: s + flen, 1] = w.imag
        channels = 2
    else:
        # mono int16 wire format (the reference's acoustic use case):
        # raw transfer + on-device front-end (modem/ingest.py)
        from modem.ingest import PcmRecording
        xm = np.zeros((flen + gap) * n + gap, dtype=np.float32)
        for i, w in enumerate(waves):
            s = gap + i * (flen + gap)
            xm[s: s + flen] = w.real
        q = np.clip(np.rint(xm * 32767.0), -32768, 32767).astype(
            np.int16)
        x = PcmRecording(data=q, bits=16, rate=rate)
        channels = 1

    t0 = time.time()
    frames = decode_recording_auto(x, rate, channels=channels,
                                   max_frames=n)
    print(f"# first pass (compiles): {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    ok = sum(f["ok"] for f in frames)
    exact = sum(f["payload"] == payloads[i] for i, f in enumerate(frames))
    assert len(frames) == n and ok == n and exact == n, (
        len(frames), ok, exact)

    t0 = time.time()
    frames = decode_recording_auto(x, rate, channels=channels,
                                   max_frames=n)
    dt = time.time() - t0
    fps = n / dt
    xrt = fps * cfg.frame_samples / rate
    print(f"# decode-all steady: {n} frames in {dt:.2f} s = "
          f"{fps:.1f} frames/s = {xrt:.0f}x real time "
          f"(mode {frames[0]['mode']}, call {frames[0]['call_sign']})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
