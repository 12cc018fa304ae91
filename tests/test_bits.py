"""Unit tests for host-side bit plumbing (bits.py)."""

import numpy as np

from modem import bits


def test_le_be_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    assert bits.bits_to_bytes_le(bits.bytes_to_bits_le(data)) == data
    assert bits.bits_to_bytes_be(bits.bytes_to_bits_be(data)) == data
    # LE bit order: bit 0 of the stream is the LSB of byte 0.
    assert bits.bytes_to_bits_le(b"\x01")[0] == 1
    assert bits.bytes_to_bits_be(b"\x01")[7] == 1


def test_nrz():
    assert list(bits.nrz(np.array([0, 1, 0]))) == [1, -1, 1]


def test_scramble_self_inverse():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    scrambled = bits.scramble(data)
    assert scrambled != data
    assert bits.scramble(scrambled) == data


def test_xorshift32_first_values():
    # Marsaglia xorshift32 from seed 2463534242: first full state is
    # 723471715; we keep the low byte of each state.
    y = 2463534242
    y ^= (y << 13) & 0xFFFFFFFF
    y ^= y >> 17
    y ^= (y << 5) & 0xFFFFFFFF
    assert y == 723471715
    assert bits.xorshift32_bytes(1)[0] == 723471715 & 0xFF


def test_crc_check_identity():
    """crc(data || crc_lsb_first) == 0 — the decoder's select idiom
    (decode.cc:533-541) pins init=0 / no-xorout semantics."""
    rng = np.random.default_rng(2)
    for crc, width in [(bits.crc16, 16), (bits.crc32, 32)]:
        payload = rng.integers(0, 2, 333, dtype=np.uint8)
        reg = crc.update_bits(0, payload)
        crc_bits = np.array([(reg >> i) & 1 for i in range(width)],
                            dtype=np.uint8)
        full = np.concatenate([payload, crc_bits])
        assert crc.update_bits(0, full) == 0


def test_crc_bytes_vs_bits():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    as_bits = bits.bytes_to_bits_le(data)
    assert bits.crc32.over_bytes(data) == bits.crc32.update_bits(0, as_bits)


def test_crc_over_value_matches_bits():
    v = 0x123456789ABCD << 9
    as_bits = np.array([(v >> i) & 1 for i in range(64)], dtype=np.uint8)
    assert bits.crc16.over_value(v) == bits.crc16.update_bits(0, as_bits)


def test_crc_check_matrix():
    rng = np.random.default_rng(4)
    for crc in (bits.crc16, bits.crc32):
        n = 200
        m = crc.check_matrix(n)
        for _ in range(5):
            payload = rng.integers(0, 2, n, dtype=np.uint8)
            want = crc.update_bits(0, payload)
            got_bits = (payload @ m) % 2
            got = sum(int(b) << i for i, b in enumerate(got_bits))
            assert got == want


def test_mls_period_and_balance():
    """MLS over a primitive polynomial has period 2^deg - 1 and is
    balanced (2^(deg-1) ones)."""
    from modem import numerology as num
    for poly, length in [(num.MLS0_POLY, 127), (num.MLS1_POLY, 255),
                         (num.MLS2_POLY, 2047)]:
        seq = bits.mls_bits(poly, 2 * length)
        assert (seq[:length] == seq[length:]).all()          # periodic
        assert seq[:length].sum() == (length + 1) // 2        # balanced
        # all-zero state never occurs => no run of deg zeros of length deg
        deg = poly.bit_length() - 1
        runs = np.convolve(1 - seq[:length], np.ones(deg), "valid")
        assert runs.max() < deg


def test_base37_roundtrip():
    for cs in ["N0CALL", "DL7AD", "AB1CDE XY"]:
        v = bits.base37_encode(cs)
        assert 0 < v < 37 ** 9
        assert bits.base37_decode(v).strip() == cs.strip()
    assert bits.base37_encode("bad!") == -1
