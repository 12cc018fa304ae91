"""Device SCL VM vs the numpy reference decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modem.fec.polar import PolarCode
from modem.fec.scl_np import scl_decode_np
from modem.fec.scl_vm import build_schedule, make_decoder

TOY = PolarCode(n=224, k=144, order=8)


@pytest.fixture(scope="module")
def toy_dec():
    return jax.jit(make_decoder(TOY.frozen, 8))


def _tx(rng):
    m = rng.integers(0, 2, TOY.mesg_bits, dtype=np.uint8)
    m[TOY.k:] = 0
    cw = TOY.encode_systematic_np(m)
    return cw, 1.0 - 2.0 * TOY.shorten_np(cw).astype(np.float64)


def test_schedule_covers_tree():
    sched = build_schedule(TOY.frozen.tobytes())
    assert sched.n_ops > 0
    ops = sched.ops
    from modem.fec.scl_vm import (C_WIDTH, OP_COMBINE, OP_RATE0,
                                      OP_RATE1, OP_REP)
    # every emitted leaf op fits a single chunk
    leaf = ops[np.isin(ops[:, 0], (OP_RATE0, OP_REP, OP_RATE1))]
    assert (leaf[:, C_WIDTH] <= 512).all()
    # last instruction is the root combine
    assert ops[-1, 0] == OP_COMBINE and ops[-1, 1] == 0


def test_noiseless_exact(toy_dec):
    rng = np.random.default_rng(0)
    cw, tx = _tx(rng)
    llr = TOY.lengthen_np(4.0 * tx).astype(np.float32)
    cws, pm = toy_dec(jnp.asarray(llr))
    best = int(np.argmin(np.asarray(pm)))
    assert np.asarray(pm)[best] == 0.0
    assert (np.asarray(cws)[best] == cw).all()


def test_noisy_matches_numpy_quality(toy_dec):
    rng = np.random.default_rng(1)
    cw, tx = _tx(rng)
    hits_vm = hits_np = 0
    for _ in range(15):
        rx = tx + 0.6 * rng.standard_normal(TOY.n)
        llr = TOY.lengthen_np(2 * rx / 0.36)
        cws, _ = toy_dec(jnp.asarray(llr.astype(np.float32)))
        hits_vm += bool((np.asarray(cws) == cw).all(axis=1).any())
        cnp, _ = scl_decode_np(llr, TOY.frozen, 8)
        hits_np += bool((cnp == cw).all(axis=1).any())
    assert hits_vm >= hits_np - 2   # fast-node approximation tolerance
    assert hits_vm >= 10


def test_exact_mode_strict_toy_parity():
    """exact=True (exact SPC parity-adjuster rule + L-1 RATE1 forks)
    must reproduce the bit-by-bit oracle's surviving set EXACTLY —
    codeword sets equal and path metrics equal to f32 tolerance — not
    just recover the frame (Sarkis et al. equivalence)."""
    rng = np.random.default_rng(5)
    dec = jax.jit(make_decoder(TOY.frozen, 8, exact=True))
    cw, tx = _tx(rng)
    for _ in range(10):
        rx = tx + 0.6 * rng.standard_normal(TOY.n)
        llr = TOY.lengthen_np(2 * rx / 0.36)
        cws, pm = dec(jnp.asarray(llr.astype(np.float32)))
        cnp, pnp = scl_decode_np(llr, TOY.frozen, 8)
        assert np.allclose(np.sort(np.asarray(pm)), np.sort(pnp),
                           rtol=1e-4, atol=1e-2)
        assert (np.sort(np.asarray(cws), axis=0)
                == np.sort(cnp, axis=0)).all()


def test_exact_spc_vs_decomposed_subtrees():
    """The exact SPC leaf op (round 3) must agree with the round-2
    decomposed-subtree exact schedule AND the oracle, at HIGH noise
    where paths accumulate multiple SPC flips — the regime the old
    one-pair-flip approximation cannot reach."""
    from modem.fec.scl_vm import OP_SPC
    sched = build_schedule(TOY.frozen.tobytes())
    assert (sched.ops[:, 0] == OP_SPC).sum() >= 5   # toy exercises SPC
    rng = np.random.default_rng(11)
    dec_x = jax.jit(make_decoder(TOY.frozen, 8, exact=True))
    dec_d = jax.jit(make_decoder(TOY.frozen, 8, exact=True,
                                 decompose_spc=True))
    cw, tx = _tx(rng)
    for _ in range(8):
        rx = tx + 0.9 * rng.standard_normal(TOY.n)
        llr = TOY.lengthen_np(2 * rx / 0.81).astype(np.float32)
        cx, px = dec_x(jnp.asarray(llr))
        cd, pd = dec_d(jnp.asarray(llr))
        cnp, pnp = scl_decode_np(llr, TOY.frozen, 8)
        assert (np.sort(np.asarray(cx), axis=0)
                == np.sort(np.asarray(cd), axis=0)).all()
        assert (np.sort(np.asarray(cx), axis=0)
                == np.sort(cnp, axis=0)).all()
        assert np.allclose(np.sort(np.asarray(px)), np.sort(pnp),
                           rtol=1e-4, atol=1e-2)


# Oracle outcomes from the wire-size A/B sweep (bench/ab_scl.py,
# oracle cache bench/ab_scl_oracle_64800.json; seed scheme
# int(sigma*1000)*100000 + i).  Fast mode (T=4, SPC leaves) matches
# the oracle on 499/500 sweep frames; its one divergence is
# (0.72, 52), which exact mode recovers.
WIRE_ORACLE = [
    (0.70, 0, True), (0.70, 1, True), (0.70, 2, True),
    (0.72, 0, False),
]
WIRE_GAP_FRAME = (0.72, 52)


def _wire_llr(code, sigma, i):
    seed = int(sigma * 1000) * 100000 + i
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic_np(m)
    tx = 1.0 - 2.0 * code.shorten_np(cw).astype(np.float64)
    rx = tx + sigma * rng.standard_normal(code.n)
    return cw, code.lengthen_np(2.0 * rx / sigma**2).astype(np.float32)


def test_wire_size_oracle_parity():
    """Device decoders vs the exact-SCL oracle at the 2^16 WIRE size,
    on seeded frames across the sensitivity edge (CLAUDE.md contract:
    the device backends must match the oracle at wire size)."""
    code = PolarCode(n=64800, k=43072, order=16)
    dec_x = jax.jit(make_decoder(code.frozen, 8))       # exact default
    dec_f = jax.jit(make_decoder(code.frozen, 8, exact=False))
    for sigma, i, expect in WIRE_ORACLE:
        cw, llr = _wire_llr(code, sigma, i)
        for dec in (dec_x, dec_f):      # fast agrees on these frames
            cws, _ = dec(jnp.asarray(llr))
            hit = bool((np.asarray(cws) == cw).all(axis=1).any())
            assert hit == expect, (sigma, i)
    # the one sweep frame fast mode loses; exact mode recovers it
    cw, llr = _wire_llr(code, *WIRE_GAP_FRAME)
    cws, _ = dec_x(jnp.asarray(llr))
    assert bool((np.asarray(cws) == cw).all(axis=1).any())
    cws, _ = dec_f(jnp.asarray(llr))
    assert not bool((np.asarray(cws) == cw).all(axis=1).any())


def test_batched_vmap(toy_dec):
    rng = np.random.default_rng(2)
    cw, tx = _tx(rng)
    batch = np.stack([
        TOY.lengthen_np(2 * (tx + 0.5 * rng.standard_normal(TOY.n)) / 0.25)
        for _ in range(4)]).astype(np.float32)
    dec_b = jax.jit(jax.vmap(make_decoder(TOY.frozen, 8)))
    cws, pm = dec_b(jnp.asarray(batch))
    assert np.asarray(cws).shape == (4, 8, 256)
    hit = (np.asarray(cws) == cw).all(axis=2).any(axis=1)
    assert hit.sum() >= 3
