"""PSK map/hard/soft tests against the psk.hh behavioural spec
(split-complex device API)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from modem import psk


def as_c(sym):
    sym = np.asarray(sym)
    return sym[..., 0] + 1j * sym[..., 1]


@pytest.mark.parametrize("mod_bits", [1, 2, 3])
def test_map_hard_roundtrip(mod_bits):
    rng = np.random.default_rng(0)
    bits = 1 - 2 * rng.integers(0, 2, size=(64, mod_bits))
    syms = np.asarray(psk.mod_map(mod_bits, bits.astype(np.float32)))
    assert np.allclose(np.abs(as_c(syms)), 1.0, atol=1e-6)  # unit power
    back = np.asarray(psk.mod_hard(mod_bits, syms))
    assert (back == bits).all()


@pytest.mark.parametrize("mod_bits", [1, 2, 3])
def test_soft_sign_matches_hard(mod_bits):
    rng = np.random.default_rng(1)
    bits = 1 - 2 * rng.integers(0, 2, size=(128, mod_bits))
    syms = np.asarray(psk.mod_map(mod_bits, bits.astype(np.float32)))
    syms = syms + 0.01  # tiny offset that cannot cross boundaries
    soft = np.asarray(psk.mod_soft(mod_bits, syms, 8.0))
    hard = np.asarray(psk.mod_hard(mod_bits, syms))
    assert (np.sign(soft) == hard).all()


def test_qpsk_map_values():
    s = as_c(psk.mod_map(2, np.array([[1.0, 1.0]])))[0]
    assert abs(s - (psk.RCP_SQRT_2 + 1j * psk.RCP_SQRT_2)) < 1e-6


def test_psk8_axis_swap_layout():
    """psk.hh:132-139: b0 selects which axis gets cos(pi/8)."""
    s1 = as_c(psk.mod_map(3, np.array([[1.0, 1.0, 1.0]])))[0]
    assert abs(s1 - (psk.COS_PI_8 + 1j * psk.SIN_PI_8)) < 1e-6
    s2 = as_c(psk.mod_map(3, np.array([[-1.0, 1.0, 1.0]])))[0]
    assert abs(s2 - (psk.SIN_PI_8 + 1j * psk.COS_PI_8)) < 1e-6


def test_int8_saturation():
    soft = np.asarray(psk.mod_soft(2, np.array([100.0, 0.0]), 8.0,
                                   int8=True))
    assert soft.max() == 127.0


def test_mod_phase_matches_map():
    rng = np.random.default_rng(2)
    for mod_bits in (2, 3):
        bits = (1 - 2 * rng.integers(0, 2, (32, mod_bits))).astype(
            np.float32)
        sym = as_c(psk.mod_map(mod_bits, bits))
        ph = np.asarray(psk.mod_phase(mod_bits, bits))
        assert np.allclose(np.exp(1j * ph), sym, atol=1e-6)


@pytest.mark.parametrize("mod_bits", [1, 2, 3])
def test_mod_phase_table_is_correctly_rounded(mod_bits):
    """The angle table equals the float64 arctan2 of each f32 point
    rounded once to f32, and XLA-CPU's own f32 arctan2 bit for bit (the
    transmitted waveform was pinned with the latter)."""
    bits = np.array(list(itertools.product((1.0, -1.0), repeat=mod_bits)),
                    np.float32)
    sym = np.asarray(psk.mod_map(mod_bits, bits))
    ph = np.asarray(psk.mod_phase(mod_bits, bits))
    want = np.arctan2(sym[:, 1].astype(np.float64),
                      sym[:, 0].astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(ph, want)
    np.testing.assert_array_equal(
        ph, np.asarray(jnp.arctan2(sym[:, 1], sym[:, 0])))


def test_np_map_matches_jax():
    rng = np.random.default_rng(3)
    for mod_bits in (1, 2, 3):
        bits = (1 - 2 * rng.integers(0, 2, size=(32, mod_bits))).astype(
            np.float64)
        a = psk.mod_map_np(mod_bits, bits)
        b = as_c(psk.mod_map(mod_bits, bits.astype(np.float32)))
        assert np.allclose(a, b, atol=1e-6)
