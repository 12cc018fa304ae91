"""Polar transform / systematic encode / shorten / SCL decode tests."""

import numpy as np
import pytest

from modem.fec.polar import PolarCode, polar_transform, polar_transform_np
from modem.fec.scl_np import scl_decode_np

TOY = PolarCode(n=224, k=150, order=8)


def test_transform_involution():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(4, 512), dtype=np.uint8)
    assert (polar_transform_np(polar_transform_np(u)) == u).all()


def test_transform_jax_matches_np():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, size=(3, 256), dtype=np.uint8)
    got = np.asarray(polar_transform(u))
    assert (got == polar_transform_np(u)).all()


def test_systematic_property():
    rng = np.random.default_rng(2)
    m = rng.integers(0, 2, size=(5, TOY.mesg_bits), dtype=np.uint8)
    cw = TOY.encode_systematic_np(m)
    assert (cw[..., TOY.info_idx] == m).all()
    # u-domain must vanish on frozen positions
    u = polar_transform_np(cw)
    assert (u[..., np.nonzero(TOY.frozen)[0]] == 0).all()


def test_jax_encode_matches_np():
    rng = np.random.default_rng(3)
    m = rng.integers(0, 2, size=(2, TOY.mesg_bits), dtype=np.uint8)
    got = np.asarray(TOY.encode_systematic(m))
    assert (got == TOY.encode_systematic_np(m)).all()


def test_shorten_lengthen_roundtrip():
    rng = np.random.default_rng(4)
    llr = rng.standard_normal(TOY.n).astype(np.float32)
    full = TOY.lengthen_np(llr)
    assert (full[TOY.kept_idx] == llr).all()
    assert (full[TOY.shortened_idx] == 9000.0).all()
    jfull = np.asarray(TOY.lengthen(llr))
    assert np.allclose(jfull, full)


def test_scl_noiseless_and_noisy():
    rng = np.random.default_rng(5)
    m = rng.integers(0, 2, size=TOY.mesg_bits, dtype=np.uint8)
    m[TOY.k:] = 0  # shortened tail pinned to bit 0
    cw = TOY.encode_systematic_np(m)
    tx = 1.0 - 2.0 * TOY.shorten_np(cw).astype(np.float64)

    # noiseless: best path must be exact
    full = TOY.lengthen_np(4.0 * tx)
    cws, pm = scl_decode_np(full, TOY.frozen, 4)
    assert (TOY.extract_info_np(cws)[0] == m[: TOY.k]).all()
    assert pm[0] == 0.0

    # moderate noise: some path in the list recovers the message
    sigma = 10 ** (-4.0 / 20)
    hits = 0
    for _ in range(10):
        rx = tx + sigma * rng.standard_normal(TOY.n)
        full = TOY.lengthen_np(2 * rx / sigma**2)
        cws, _ = scl_decode_np(full, TOY.frozen, 8)
        info = TOY.extract_info_np(cws)
        hits += bool((info == m[: TOY.k]).any(axis=-1).all() and
                     any((row == m[: TOY.k]).all() for row in info))
    assert hits >= 8


def test_scl_list_rescues_crc_candidate():
    """With CRC selection, a non-best list path still yields the payload."""
    from modem import bits as B
    TOY = PolarCode(n=224, k=144, order=8)  # 112 payload bits + CRC32
    rng = np.random.default_rng(6)
    payload = rng.integers(0, 256, (TOY.k - 32) // 8, dtype=np.uint8)
    pbits = B.bytes_to_bits_le(payload.tobytes())
    reg = B.crc32.over_bytes(payload.tobytes())
    crc_bits = np.array([(reg >> i) & 1 for i in range(32)], dtype=np.uint8)
    m = np.zeros(TOY.mesg_bits, dtype=np.uint8)
    m[: TOY.k] = np.concatenate([pbits, crc_bits])
    cw = TOY.encode_systematic_np(m)
    tx = 1.0 - 2.0 * TOY.shorten_np(cw).astype(np.float64)
    sigma = 10 ** (-3.5 / 20)
    found = 0
    for _ in range(10):
        rx = tx + sigma * rng.standard_normal(TOY.n)
        cws, _ = scl_decode_np(TOY.lengthen_np(2 * rx / sigma**2),
                               TOY.frozen, 8)
        for row in TOY.extract_info_np(cws):
            if B.crc32.update_bits(0, row) == 0:
                assert (row == m[: TOY.k]).all()
                found += 1
                break
    assert found >= 7
