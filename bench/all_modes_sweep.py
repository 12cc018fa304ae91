#!/usr/bin/env python
"""All modes x all sample rates through the reference demo chain.

The reference README demonstrates bit-exact recovery through
`multipath(x10) | cfo 234.567 | sfo 147 | awgn -30` (README.md:42-49).
This sweeps every operating mode (6-13) at every supported sample rate
(8/16/44.1/48 kHz) through that chain at the -30 dB operating point
and reports frames bit-exact + mean payload bit flips — the honest
whole-surface robustness table.

The multipath base delays are in SAMPLES, so the spread factor is
scaled by rate/8000 to keep the PHYSICAL channel (delays in seconds)
identical across rates — every cell sees taps at 75% of its guard
interval, the same acoustic room.

Usage: python bench/all_modes_sweep.py [batch] [awgn_db] [rate,...]
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    from modem import bits as B
    from modem import channel
    from modem.numerology import MODES, SUPPORTED_RATES, make_config
    from modem.encoder import Encoder
    from modem.pipeline import BatchPipeline

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    awgn_db = float(sys.argv[2]) if len(sys.argv) > 2 else -30.0
    rates = ([int(r) for r in sys.argv[3].split(",")]
             if len(sys.argv) > 3 else SUPPORTED_RATES)
    print(f"batch {batch}; chain = multipath x10 + CFO 234.567 Hz + "
          f"SFO 147 ppm + AWGN {awgn_db:g} dB:", flush=True)
    for rate in rates:
        for mode in sorted(MODES):
            cfg = make_config(rate, mode, 2000)
            enc = Encoder(cfg)
            rng = np.random.default_rng(1000 + mode)
            payloads = [rng.integers(0, 256, cfg.mode.data_bytes,
                                     dtype=np.uint8).tobytes()
                        for _ in range(batch)]
            waves, _ = enc.encode_batch(payloads,
                                        B.base37_encode("N0CALL"))
            sil = np.zeros((batch, cfg.rate // 2), dtype=np.complex64)
            clean = np.concatenate([sil, waves, sil], axis=1)
            recs = []
            for i in range(batch):
                y = channel.multipath(clean[i],
                                      spread=10 * rate // 8000)
                y = channel.cfo(y, 234.567, cfg.rate)
                y = channel.sfo(y, 147.0)
                y = channel.awgn(y, awgn_db,
                                 np.random.default_rng(100 + i))
                recs.append(y[: clean.shape[1]])
            pipe = BatchPipeline(rate, mode)
            res = pipe.decode_batch(np.stack(recs))
            ok = sum(bool(res["ok"][i]) and
                     pipe.payload_bytes(res, i) == payloads[i]
                     for i in range(batch))
            flips = np.asarray(res["flips"])
            print(f"  {rate:5d} Hz mode {mode:2d}: {ok}/{batch} "
                  f"bit-exact, mean flips {flips.mean():.0f}",
                  flush=True)


if __name__ == "__main__":
    main()
