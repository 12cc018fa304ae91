#!/usr/bin/env python
"""Frame-success-rate sweep vs AWGN level (BASELINE config 4 evidence).

Encodes a batch of mode-6 frames, applies the reference impairment
chain (multipath + CFO 234.567 Hz + SFO 147 ppm) plus a sweep of AWGN
levels, and reports the frame success rate and mean bit flips at each
level through the batched pipeline.

Usage: python bench/ber_sweep.py [batch] [mode] [spread] [estimator]
  spread: multipath delay-spread factor (default 10, the demo's x10)
  estimator: disjoint (default) | all_pairs — Theil-Sen A/B switch
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    from modem import bits as B
    from modem import channel
    from modem.encoder import Encoder
    from modem.numerology import make_config
    from modem.pipeline import BatchPipeline

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    mode = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    spread = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    if len(sys.argv) > 4:
        from modem import track
        track.ESTIMATOR = sys.argv[4]
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
    from modem import track as _track
    print(f"mode {mode}, batch {batch}, spread x{spread}, Theil-Sen "
          f"{_track.ESTIMATOR}; chain = multipath + CFO 234.567 Hz + "
          "SFO 147 ppm + AWGN:", flush=True)
    for awgn_db in [-40, -35, -30, -25, -22, -20, -18, -17, -16]:
        recs = []
        for i, c in enumerate(clean):
            y = channel.multipath(c, spread=spread)
            y = channel.cfo(y, 234.567, cfg.rate)
            y = channel.sfo(y, 147.0)
            y = channel.awgn(y, awgn_db, np.random.default_rng(100 + i))
            recs.append(y[: len(clean[0])])
        res = pipe.decode_batch(np.stack(recs))
        ok = 0
        for i in range(batch):
            ok += (bool(np.asarray(res["ok"])[i]) and
                   pipe.payload_bytes(res, i) == payloads[i])
        flips = np.asarray(res["flips"])
        print(f"  awgn {awgn_db:+d} dB: {ok}/{batch} frames bit-exact, "
              f"mean flips {flips.mean():.0f}", flush=True)


if __name__ == "__main__":
    main()
