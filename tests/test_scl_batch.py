"""Batched schedule VM (fec/scl_vm.make_batch_decoder) — the device
polar decoder every serving path runs — against the single-frame VM
and the numpy oracle.

The batched VM lays all paths of all frames side by side on one lane
axis ([SZ, batch*list]) and moves list lanes with permute_lanes, so
these tests pin it on the same inputs the single-frame VM is pinned
on: toy codes in every batch layout, a code wider than one chunk, a
hand-built mask that emits every op class, exact-mode oracle parity,
and the L=1 successive-cancellation case the adaptive path serves.
"""

import importlib.util
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modem.fec import scl_vm
from modem.fec.polar import PolarCode, polar_transform_np
from modem.fec.scl_np import scl_decode_np
from modem.fec.scl_vm import (C_OP, OP_COMBINE, OP_F, OP_G, OP_RATE0,
                              OP_RATE1, OP_REP, OP_SPC, build_schedule,
                              make_batch_decoder, make_decoder,
                              permute_lanes)

TOY = PolarCode(n=224, k=144, order=8)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _noisy(code, sigma, frames, seed):
    """(true codeword, [frames, code_len] channel LLRs)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    cw = code.encode_systematic_np(m)
    tx = 1.0 - 2.0 * code.shorten_np(cw).astype(np.float64)
    llrs = np.stack([
        code.lengthen_np(2 * (tx + sigma * rng.standard_normal(code.n))
                         / sigma**2) for _ in range(frames)])
    return cw, llrs.astype(np.float32)


def _run(dec, llrs):
    return tuple(np.asarray(v) for v in dec(jnp.asarray(llrs)))


def _assert_same_lists(frozen, llrs, list_size, exact=True):
    """Batched VM == vmapped single-frame VM: the same surviving
    codeword set and the same path metrics per frame (path ORDER may
    differ: the two layouts break exact metric ties differently)."""
    ref = jax.jit(jax.vmap(make_decoder(frozen, list_size, exact=exact)))
    bat = jax.jit(make_batch_decoder(frozen, llrs.shape[0], list_size,
                                     exact=exact))
    cws_r, pm_r = _run(ref, llrs)
    cws_b, pm_b = _run(bat, llrs)
    assert cws_b.shape == cws_r.shape and pm_b.shape == pm_r.shape
    assert np.allclose(np.sort(pm_r, axis=1), np.sort(pm_b, axis=1))
    for b in range(llrs.shape[0]):
        assert (np.sort(cws_r[b], axis=0)
                == np.sort(cws_b[b], axis=0)).all()
    return cws_b, pm_b


@pytest.mark.parametrize("exact,batch", [(True, 1), (True, 4),
                                         (False, 2)])
def test_batch_vm_matches_single_frame_vm(exact, batch):
    """Toy code, exact and fast leaf rules, one and several frames per
    lane axis; every frame keeps the transmitted codeword."""
    cw, llrs = _noisy(TOY, 0.5, batch, seed=0)
    cws, _ = _assert_same_lists(TOY.frozen, llrs, 8, exact=exact)
    assert (cws == cw).all(axis=2).any(axis=1).all()


def test_batch_vm_split_d0_chunked_code():
    """A code wider than one chunk (code_len 1024 > CHUNK): depth-0
    F/G ops run as several chunked instructions."""
    big = PolarCode(n=960, k=480, order=10)
    assert build_schedule(big.frozen.tobytes()).code_len > scl_vm.CHUNK
    cw, llrs = _noisy(big, 0.4, 2, seed=7)
    cws, _ = _assert_same_lists(big.frozen, llrs, 8)
    assert (cws == cw).all(axis=2).any(axis=1).all()


def test_batch_vm_all_op_classes():
    """A hand-built 2048-bit frozen mask whose schedule emits every op
    class of the VM (F, G, COMBINE, RATE0, REP, RATE1, SPC at full and
    sub-chunk widths); batched == single-frame on noisy codewords."""
    n = 2048
    frozen = np.zeros(n, dtype=np.uint8)
    frozen[0:512] = 1                      # RATE0 512
    # [512:1024) all info -> RATE1 512
    frozen[1024:1280] = 1                  # REP 256
    frozen[1279] = 0
    # [1280:1536) info -> RATE1 256
    frozen[1536] = 1                       # SPC 256
    frozen[1792:1919] = 1                  # REP 128
    frozen[1919] = 0
    # [1920:2048) info -> RATE1 128
    sched = build_schedule(frozen.tobytes())
    seen = set(sched.ops[:, C_OP].tolist())
    needed = {OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC}
    assert needed <= seen, sorted(needed - seen)

    rng = np.random.default_rng(3)
    msg = np.where(frozen == 1, 0, rng.integers(0, 2, n)).astype(np.uint8)
    tx = 1.0 - 2.0 * polar_transform_np(msg).astype(np.float64)
    llrs = np.stack([2 * (tx + 0.5 * rng.standard_normal(n)) / 0.25
                     for _ in range(2)]).astype(np.float32)
    _assert_same_lists(frozen, llrs, 8)


def test_batch_vm_exact_mode_oracle_parity():
    """exact=True reproduces the bit-by-bit numpy oracle's surviving
    set strictly, frame by frame, through the batched layout."""
    _, llrs = _noisy(TOY, 0.5, 4, seed=0)
    bat = jax.jit(make_batch_decoder(TOY.frozen, 4, 8, exact=True))
    cws, pm = _run(bat, llrs)
    for b in range(llrs.shape[0]):
        cnp, pnp = scl_decode_np(llrs[b], TOY.frozen, 8)
        assert np.allclose(np.sort(pm[b]), np.sort(pnp),
                           rtol=1e-4, atol=1e-2)
        assert (np.sort(cws[b], axis=0) == np.sort(cnp, axis=0)).all()


@pytest.mark.parametrize("exact", [True, False])
def test_batch_vm_l1_matches_single_frame_vm(exact):
    """list_size=1 (the adaptive path's SC stage): bit-exact against
    the single-frame VM, codewords and path metrics, at a noise level
    where SC fails on some frames."""
    _, llrs = _noisy(TOY, 0.9, 8, seed=9)
    ref = jax.jit(jax.vmap(make_decoder(TOY.frozen, 1, exact=exact)))
    bat = jax.jit(make_batch_decoder(TOY.frozen, 8, 1, exact=exact))
    cws_r, pm_r = _run(ref, llrs)
    cws_b, pm_b = _run(bat, llrs)
    assert (cws_b == cws_r).all()
    assert np.allclose(pm_b, pm_r, rtol=1e-5, atol=1e-3)


def test_permute_lanes_matches_fancy_indexing():
    """The lane permutation moves whole columns exactly, for every
    dtype the VM permutes (f32 values incl. the 3e38 sentinel, int32
    indices, bool flags), with repeated source lanes (list forks)."""
    rng = np.random.default_rng(4)
    w = 24
    lanes = rng.integers(0, w, w).astype(np.int32)
    f = rng.standard_normal((5, w)).astype(np.float32)
    f[0, 3] = 3.0e38
    i = rng.integers(0, 1 << 20, (3, w)).astype(np.int32)
    b = rng.integers(0, 2, w).astype(bool)
    for x in (f, i, b):
        got = np.asarray(jax.jit(permute_lanes)(jnp.asarray(x),
                                                jnp.asarray(lanes)))
        assert got.dtype == x.dtype
        assert np.array_equal(got, x[..., lanes])


def test_pipelines_build_the_vm():
    """BatchPipeline and Decoder decode through the schedule VM on
    every backend: no kernel package, no backend option."""
    from modem import decoder
    from modem.parallel import toy_config
    from modem.pipeline import BatchPipeline

    assert importlib.util.find_spec("modem.kernels") is None
    params = inspect.signature(BatchPipeline).parameters
    assert set(params) == {"rate", "oper_mode", "list_size", "mode_spec",
                           "symbol_len_override", "scl_exact", "estimator",
                           "mls_convention", "sync_stride"}
    cfg = toy_config()
    pipe = BatchPipeline(rate=cfg.rate, oper_mode=0, list_size=4,
                         mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len)
    scl = pipe._make_scl(2)
    assert scl.__module__ == scl_vm.__name__
    assert scl.__qualname__.startswith("make_batch_decoder.")
    assert decoder.cached_jit_decoder is scl_vm.cached_jit_decoder


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py's device check stops on a CPU device with a
    message naming the platform, before any phase runs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="cpu"):
        smoke.require_gpu(jax.devices())
