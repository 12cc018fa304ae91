#!/usr/bin/env python
"""A/B the matmul OSD (fec/osd.py) against the exhaustive numpy oracle.

The header gate is
CODE::OrderedStatisticsDecoder<255,71,4> (decode.cc:417) with a
uniqueness flag ("false when the best two candidates tie").  The
device decoder enumerates weight<=4 patterns as a meet-in-the-middle
matmul with a canonical-split mask; this harness drives both decoders
over noisy headers spanning the OSD sensitivity edge plus
tie-inducing (coarse quantisation) and erasure-heavy cases, and
requires BIT-EXACT decoded data AND identical unique flags.

Usage: python bench/ab_osd.py [--frames N] [--sigmas a,b,c]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_soft(rng, cw, sigma, quant=32, erase_frac=0.0):
    x = (1.0 - 2.0 * cw) + rng.normal(0, sigma, cw.shape[0])
    if erase_frac > 0.0:
        n_erase = int(cw.shape[0] * erase_frac)
        idx = rng.choice(cw.shape[0], n_erase, replace=False)
        x[idx] = 0.0
    return np.clip(np.rint(x * quant), -127, 127).astype(np.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40,
                    help="headers per case")
    ap.add_argument("--sigmas", type=str, default="0.7,0.9,1.1")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from modem.fec import bch
    from modem.fec.osd import osd_decode
    from modem.fec.osd_np import osd_decode_np

    G = bch.generator_matrix()
    dev = jax.jit(lambda s: osd_decode(s))
    cases = [(f"awgn s={s}", float(s), 32, 0.0)
             for s in args.sigmas.split(",")]
    cases += [("tie-inducing q=4 s=1.0", 1.0, 4, 0.0),
              ("erasures 30% s=0.8", 0.8, 32, 0.3)]

    rng = np.random.default_rng(20240817)
    total = bits_agree = flag_agree = 0
    rows = []
    for name, sigma, quant, efrac in cases:
        n_ok_o = n_uni_o = n_bits = n_flag = 0
        for _ in range(args.frames):
            data = rng.integers(0, 2, 71).astype(np.uint8)
            cw = (data @ G) % 2
            soft = make_soft(rng, cw, sigma, quant, efrac)
            db, ub = (np.asarray(v) for v in dev(jnp.asarray(soft)))
            ob, uo = osd_decode_np(soft)
            n_bits += int((db == ob).all())
            n_flag += int(bool(ub) == uo)
            n_ok_o += int((ob == data).all())
            n_uni_o += int(uo)
        total += args.frames
        bits_agree += n_bits
        flag_agree += n_flag
        row = dict(case=name, frames=args.frames, bits_agree=n_bits,
                   flag_agree=n_flag, oracle_correct=n_ok_o,
                   oracle_unique=n_uni_o)
        rows.append(row)
        print(json.dumps(row), flush=True)
        print(f"# {name}: bits {n_bits}/{args.frames} flags "
              f"{n_flag}/{args.frames} (oracle correct {n_ok_o}, "
              f"unique {n_uni_o})", file=sys.stderr, flush=True)
    print(f"# TOTAL: bits {bits_agree}/{total}, flags "
          f"{flag_agree}/{total}", file=sys.stderr, flush=True)
    return 0 if bits_agree == total and flag_agree == total else 1


if __name__ == "__main__":
    sys.exit(main())
