#!/usr/bin/env python
"""Decompose Synchronizer._metrics_parts cost on the device.

The coarse-sync metrics are part of the batch demod front-end; where
they cost more than their window-sum arithmetic predicts, something
in the composition (pads/reshapes/repeats under vmap,
HIGHEST-precision passes, poor fusion) costs more than the math.
This probe times each sub-expression in isolation (in-graph digest,
one fetch per rep, distinct inputs).

Usage: python bench/probe_sync_parts.py [batch] [T]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def clock(name, fn, *argsets):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def digest(*a):
        out = fn(*a)
        return sum(jnp.sum(leaf.astype(jnp.float32))
                   for leaf in jax.tree_util.tree_leaves(out))

    t0 = time.time()
    np.asarray(digest(*argsets[0]))
    t1 = time.time()
    best = float("inf")
    timed = list(argsets[1:])
    for i in range(4):
        t2 = time.time()
        np.asarray(digest(*timed[i % len(timed)]))
        best = min(best, time.time() - t2)
    print(f"{name}: compile {t1 - t0:.1f} s, steady {best * 1e3:.1f} ms",
          flush=True)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from modem import cplx
    from modem.pipeline import BatchPipeline
    from modem.sync import window_sum

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 88320
    rng = np.random.default_rng(0)
    pipe = BatchPipeline(8000, 6)
    s = pipe.sync
    L = s.L

    recs = [jnp.asarray(rng.normal(0, .1, (batch, T, 2))
                        .astype(np.float32)) for _ in range(3)]
    clock("full _metrics_parts", jax.vmap(s._metrics_parts),
          (recs[0],), (recs[1],), (recs[2],))

    def prods(x):
        a = x[:, L:-L]
        b = x[:, 2 * L:]
        a = a[:, : b.shape[1]]
        return cplx.cmul_conj(a, b), cplx.abs2(b)

    clock("prod+pb elementwise", prods, (recs[0],), (recs[1],),
          (recs[2],))

    Tp = T - 2 * L
    xs = [jnp.asarray(rng.normal(0, 1, (batch, Tp))
                      .astype(np.float32)) for _ in range(3)]
    for w, tag in ((L, "w=640"), (2 * L, "w=1280"),
                   (s.match_len, "w=161")):
        clock(f"window_sum {tag}", lambda v, w=w: window_sum(v, w),
              (xs[0],), (xs[1],), (xs[2],))

    def ratio_stage(p_re, p_im, power):
        r = jnp.maximum(0.5 * power, 1e-4 * L)
        return window_sum((p_re**2 + p_im**2) / (r * r), s.match_len)

    ps = [(xs[i], xs[(i + 1) % 3], xs[(i + 2) % 3]) for i in range(3)]
    clock("ratio + timing window_sum", ratio_stage, *ps)


if __name__ == "__main__":
    main()
