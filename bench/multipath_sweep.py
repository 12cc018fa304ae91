#!/usr/bin/env python
"""Delay-spread envelope: frame success vs multipath spread.

A robustness table at spread=1 runs the invented 4-tap profile
well inside the guard; the reference demo runs its file at x10
(README.md:49).  This sweeps the spread factor through and past the
guard interval (160 samples at 8 kHz) at the demo's other settings
(CFO 234.567 Hz, SFO 147 ppm, AWGN -30 dB) and reports where the chain
degrades.  Taps beyond the guard are structural ISI for the wire
format itself.

Usage: python bench/multipath_sweep.py [batch] [mode] [estimator]
  estimator: disjoint (default) | all_pairs  — Theil-Sen A/B switch
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    from modem import bits as B
    from modem import channel, track
    from modem.encoder import Encoder
    from modem.numerology import make_config
    from modem.pipeline import BatchPipeline

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    mode = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    if len(sys.argv) > 3:
        track.ESTIMATOR = sys.argv[3]
    cfg = make_config(8000, mode, 2000)
    enc = Encoder(cfg)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                             dtype=np.uint8).tobytes()
                for _ in range(batch)]
    sil = np.zeros(cfg.rate // 2, dtype=np.complex64)
    waves, _ = enc.encode_batch(payloads, B.base37_encode("N0CALL"))
    clean = [np.concatenate([sil, w, sil]) for w in waves]
    max_delay = max(d for d, _ in channel.DEFAULT_MULTIPATH)

    pipe = BatchPipeline(8000, mode)
    print(f"mode {mode}, batch {batch}, Theil-Sen {track.ESTIMATOR}; "
          f"chain = multipath(spread) + CFO 234.567 Hz + SFO 147 ppm "
          f"+ AWGN -30 dB; guard {cfg.guard_len} samples:", flush=True)
    for spread in [1, 5, 10, 13, 16, 20, 26]:
        recs = []
        for i, c in enumerate(clean):
            y = channel.multipath(c, spread=spread)
            y = channel.cfo(y, 234.567, cfg.rate)
            y = channel.sfo(y, 147.0)
            y = channel.awgn(y, -30.0, np.random.default_rng(100 + i))
            recs.append(y[: len(clean[0])])
        res = pipe.decode_batch(np.stack(recs))
        ok = 0
        for i in range(batch):
            ok += (bool(np.asarray(res["ok"])[i]) and
                   pipe.payload_bytes(res, i) == payloads[i])
        flips = np.asarray(res["flips"])
        print(f"  spread x{spread:2d} (max delay {spread * max_delay:4d}"
              f" = {spread * max_delay / cfg.guard_len:4.2f} guard): "
              f"{ok}/{batch} bit-exact, mean flips {flips.mean():.0f}",
              flush=True)


if __name__ == "__main__":
    main()
