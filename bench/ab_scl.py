#!/usr/bin/env python
"""A/B the device SCL decoder against the exact numpy oracle at wire size.

The reference forks at every information bit
(decode.cc:530, 165-169); the device backends decode Fast-SSC
constituent nodes with least-reliable-bit forks.  This harness bounds
the fidelity gap statistically on the 2^16 wire code: same LLR inputs
through scl_np (exact, f64) and scl_vm (device semantics, f32), frame
recovery compared per seed across the sensitivity edge.

Usage:
  JAX_PLATFORMS=cpu python bench/ab_scl.py [--frames N] [--t T]
      [--sigmas 0.64,0.68,...] [--code 64800] [--skip-oracle]

Writes one JSON line per (sigma, decoder) to stdout and a summary table
to stderr.  Oracle results are cached in bench/ab_scl_oracle_<code>.json
keyed by (sigma, frame index) so device-side re-runs (e.g. after a T
change) do not repeat the 2 s/frame numpy decodes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--t", type=int, default=None,
                    help="T_RATE1 override for the device decoder")
    ap.add_argument("--sigmas", type=str,
                    default="0.64,0.68,0.70,0.72,0.76")
    ap.add_argument("--code", type=int, default=64800)
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--exact", action="store_true",
                    help="no-SPC, T=L-1 exact schedule")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from modem.fec import scl_vm
    from modem.fec.polar import PolarCode
    from modem.fec.scl_np import scl_decode_np

    if args.t is not None:
        scl_vm.T_RATE1 = args.t

    code = PolarCode(n=args.code, k=43072, order=16)
    sigmas = [float(s) for s in args.sigmas.split(",")]
    dec = jax.jit(scl_vm.make_decoder(code.frozen, 8, exact=args.exact))

    cache_path = os.path.join(os.path.dirname(__file__),
                              f"ab_scl_oracle_{args.code}.json")
    oracle_cache: dict[str, bool] = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            oracle_cache = json.load(f)

    # One codeword per frame (message varies with the frame seed).
    def frame(seed):
        rng = np.random.default_rng(seed)
        m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
        m[code.k:] = 0
        cw = code.encode_systematic_np(m)
        tx = 1.0 - 2.0 * code.shorten_np(cw).astype(np.float64)
        return cw, tx, rng

    rows = []
    for sigma in sigmas:
        hits_np = hits_vm = 0
        diff_frames = []
        for i in range(args.frames):
            seed = int(sigma * 1000) * 100000 + i
            cw, tx, rng = frame(seed)
            rx = tx + sigma * rng.standard_normal(code.n)
            llr = code.lengthen_np(2.0 * rx / sigma**2)

            cands, _ = dec(jnp.asarray(llr.astype(np.float32)))
            hit_vm = bool((np.asarray(cands) == cw).all(axis=1).any())

            key = f"{sigma}:{i}"
            if key in oracle_cache:
                hit_np = oracle_cache[key]
            elif args.skip_oracle:
                hit_np = None
            else:
                cnp, _ = scl_decode_np(llr, code.frozen, 8)
                hit_np = bool((cnp == cw).all(axis=1).any())
                oracle_cache[key] = hit_np
                if (i + 1) % 10 == 0:
                    with open(cache_path, "w") as f:
                        json.dump(oracle_cache, f)
            hits_vm += hit_vm
            if hit_np is not None:
                hits_np += hit_np
                if hit_np != hit_vm:
                    diff_frames.append((i, hit_np, hit_vm))
            print(f"# sigma={sigma} frame {i+1}/{args.frames} "
                  f"np={hit_np} vm={hit_vm}",
                  file=sys.stderr, flush=True)
        row = dict(sigma=sigma,
                   esn0_db=round(-20 * np.log10(sigma), 2),
                   frames=args.frames, hits_np=hits_np,
                   hits_vm=hits_vm, t_rate1=scl_vm.T_RATE1,
                   exact=args.exact,
                   diffs=diff_frames)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if not args.skip_oracle:
        with open(cache_path, "w") as f:
            json.dump(oracle_cache, f)

    print("\nsigma  Es/N0   oracle   device   delta", file=sys.stderr)
    for r in rows:
        print(f"{r['sigma']:.2f}  {r['esn0_db']:5.2f}  "
              f"{r['hits_np']:3d}/{r['frames']}  "
              f"{r['hits_vm']:3d}/{r['frames']}  "
              f"{r['hits_vm'] - r['hits_np']:+d}", file=sys.stderr)


if __name__ == "__main__":
    main()
