"""BCH encoder + ordered-statistics header decoder tests."""

import numpy as np
import pytest

from modem.fec import bch
from modem.fec.osd import osd_decode


def test_generator_poly_degree():
    g = bch.generator_poly()
    assert len(g) == 185 and g[0] == 1 and g[-1] == 1


def test_generator_matrix_systematic_and_valid():
    g = bch.generator_matrix()
    assert (g[:, :71] == np.eye(71, dtype=np.uint8)).all()
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, 71, dtype=np.uint8)
    assert bch.is_codeword((u @ g) % 2)


def test_osd_noiseless():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, 71, dtype=np.uint8)
    cw = (u @ bch.generator_matrix()) % 2
    soft = (127 * (1 - 2 * cw.astype(np.int32))).astype(np.int8)
    data, unique = osd_decode(soft)
    assert bool(unique)
    assert (np.asarray(data) == u).all()


@pytest.mark.parametrize("sigma", [0.5, 0.8])
def test_osd_awgn(sigma):
    rng = np.random.default_rng(2)
    g = bch.generator_matrix()
    ok = 0
    for _ in range(5):
        u = rng.integers(0, 2, 71, dtype=np.uint8)
        cw = (u @ g) % 2
        rx = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(255)
        soft = np.clip(np.round(127 * rx / 4), -128, 127).astype(np.int8)
        data, unique = osd_decode(soft)
        ok += bool(unique) and (np.asarray(data) == u).all()
    assert ok >= 4


def test_osd_with_erasures():
    """Erased positions (soft 0) behave like the reference's
    demod_or_erase zeros (decode.cc:62-70)."""
    rng = np.random.default_rng(3)
    g = bch.generator_matrix()
    u = rng.integers(0, 2, 71, dtype=np.uint8)
    cw = (u @ g) % 2
    soft = (100 * (1 - 2 * cw.astype(np.int32))).astype(np.int8)
    erase = rng.choice(255, 40, replace=False)
    soft[erase] = 0
    data, unique = osd_decode(soft)
    assert bool(unique)
    assert (np.asarray(data) == u).all()


def test_osd_matches_exhaustive_oracle():
    """The matmul OSD (meet-in-the-middle half patterns + canonical
    split) must equal the serial exhaustive weight<=4 oracle
    (fec/osd_np.py) BIT-EXACTLY, including the uniqueness flag's tie
    semantics (SURVEY Appendix A: "false when the best two candidates
    tie") — across the sensitivity edge, coarse-quantisation
    tie-inducing cases, and erasure-heavy cases.  The full 200-header
    A/B lives in bench/ab_osd.py (last run: 200/200 bits, 200/200
    flags); this pins a seeded subset in CI."""
    import jax
    import jax.numpy as jnp

    from modem.fec.osd_np import osd_decode_np

    g = bch.generator_matrix()
    dev = jax.jit(lambda s: osd_decode(s))
    rng = np.random.default_rng(777)
    # one seeded case per regime (the full 200-header A/B plus
    # repetition depth lives in bench/ab_osd.py; the serial oracle
    # enumerates 972k patterns per case, so CI keeps the minimal
    # regime-covering set)
    cases = ([(0.9, 32, 0.0)] * 2 + [(1.2, 32, 0.0)]
             + [(1.0, 4, 0.0)]          # coarse quant -> frequent ties
             + [(0.8, 32, 0.3)])        # erasure-heavy
    softs = []
    for sigma, quant, efrac in cases:
        u = rng.integers(0, 2, 71, dtype=np.uint8)
        cw = (u @ g) % 2
        x = (1.0 - 2.0 * cw) + rng.normal(0, sigma, 255)
        if efrac:
            x[rng.choice(255, int(255 * efrac), replace=False)] = 0.0
        softs.append(np.clip(np.rint(x * quant), -127,
                             127).astype(np.float64))
    # deterministic all-erased block: every weight<=4 candidate scores
    # 0 -> a maximal tie, unique must be False on BOTH decoders
    softs.append(np.zeros(255))
    n_unique = 0
    for soft in softs:
        db, ub = (np.asarray(v) for v in dev(jnp.asarray(soft)))
        ob, uo = osd_decode_np(soft)
        assert (db == ob).all()
        assert bool(ub) == uo
        n_unique += int(uo)
    # the case mix must actually exercise both flag values
    assert 0 < n_unique < len(softs)
