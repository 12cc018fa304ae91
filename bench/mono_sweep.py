#!/usr/bin/env python
"""Mono-path robustness envelope vs the analytic path.

The reference's headline acoustic workflow is ONE-channel 16-bit WAV
(decode.cc:294-301: dequantise -> BlockDC -> Hilbert).  Every earlier
impairment sweep fed the 2-channel analytic path; this harness runs
the SAME channel realizations through both receivers:

  analytic: complex impaired baseband -> BatchPipeline.decode_batch
  mono:     Re(impaired baseband) -> int16 WAV wire format ->
            PcmRecording -> decode_recording (device Hilbert front-end)

The mono observation keeps only the real projection (the microphone),
so its noise statistics match the reference's acoustic use exactly:
same channel, observed mono.  Hilbert tap design (SURVEY Appendix A)
affects exactly this margin.

The expected gap is EXACTLY 3 dB by physics, not a defect: a single
real observation halves the noise power but the one-sided analytic
reconstruction doubles the in-band noise PSD (2 sigma^2/fs vs
sigma^2/fs for two independent quadratures), so signal recovery is
identical and in-band noise is +3 dB.  A measured offset of ~3 dB
therefore means the front-end has ~zero excess implementation loss.

Usage: python bench/mono_sweep.py [--window=W] [--mono-only]
                                  [batch] [mode] [spread] [levels...]
  levels: AWGN dB levels (default -40..-16 coarse grid)
  --window=W: Hilbert FIR window A/B (blackman/hamming/hann/rect/
    kaiser6/kaiser9 — dsp.HILBERT_WINDOW); wire-format irrelevant,
    mono-sensitivity relevant
  --mono-only: skip the analytic column (window A/Bs only move mono)
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    sys.argv = [sys.argv[0]] + args
    mono_only = "--mono-only" in flags
    from modem import dsp
    for f in flags:
        if f.startswith("--window="):
            dsp.HILBERT_WINDOW = f.split("=", 1)[1]
    from modem import bits as B
    from modem import channel
    from modem.encoder import Encoder
    from modem.ingest import PcmRecording
    from modem.numerology import make_config
    from modem.pipeline import BatchPipeline

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    mode = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    spread = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    cfg = make_config(8000, mode, 2000)
    enc = Encoder(cfg)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(batch)]
    sil = np.zeros(cfg.rate // 2, dtype=np.complex64)
    waves, _ = enc.encode_batch(payloads, B.base37_encode("N0CALL"))
    clean = [np.concatenate([sil, w, sil]) for w in waves]

    pipe = BatchPipeline(8000, mode)
    print(f"mode {mode}, batch {batch}, spread x{spread}; chain = "
          "multipath + CFO 234.567 Hz + SFO 147 ppm + AWGN; "
          "analytic vs mono-int16 (device Hilbert front-end, "
          f"window={dsp.HILBERT_WINDOW}):",
          flush=True)
    levels = ([float(a) for a in sys.argv[4:]] if len(sys.argv) > 4
              else [-40, -35, -30, -25, -22, -20, -18, -17, -16])
    for awgn_db in levels:
        recs = []
        for i, c in enumerate(clean):
            y = channel.multipath(c, spread=spread)
            y = channel.cfo(y, 234.567, cfg.rate)
            y = channel.sfo(y, 147.0)
            y = channel.awgn(y, awgn_db, np.random.default_rng(100 + i))
            recs.append(y[: len(clean[0])])
        if mono_only:
            ok_a = "-"
        else:
            res = pipe.decode_batch(np.stack(recs))
            ok_a = sum(bool(np.asarray(res["ok"])[i]) and
                       pipe.payload_bytes(res, i) == payloads[i]
                       for i in range(batch))
        ok_m = 0
        for i, y in enumerate(recs):
            q = np.clip(np.rint(y.real * 32767.0), -32768,
                        32767).astype(np.int16)
            pcm = PcmRecording(data=q, bits=16, rate=cfg.rate)
            r, pos = pipe.decode_recording(pcm, max_frames=2)
            if r is not None and len(pos) and \
                    bool(np.asarray(r["ok"])[0]) and \
                    pipe.payload_bytes(r, 0) == payloads[i]:
                ok_m += 1
        print(f"  awgn {awgn_db:+g} dB: analytic {ok_a}/{batch}, "
              f"mono {ok_m}/{batch}", flush=True)


if __name__ == "__main__":
    main()
