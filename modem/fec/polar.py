"""Polar transform, systematic encoding, and shortening plumbing.

Array-program polar stack (reference call sites: CODE::PolarSysEnc at
encode.cc:48,302; CODE::PolarEncoder at decode.cc:200,256; shorten at
encode.cc:180-186; lengthen at decode.cc:245-253).

The mother code is natural-order x = u * F^{(x)m} over GF(2) with
F = [[1,0],[1,1]]; since F^{(x)m} is an involution mod 2, systematic
encoding is encode -> mask frozen positions -> encode (the same
construction PolarSysEnc uses, expressed in the +/-1 NRZ domain by the
reference and in the 0/1 bit domain here).

Shortening keeps every frozen position plus the first `crc_bits`
information positions; the dropped information tail is pinned to bit 0
(encoder: +1 fill at encode.cc:300-301, decoder: a large known-bit LLR at
decode.cc:252).  All index maps are precomputed host-side from the frozen
mask and enter jitted code as static constant arrays.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from .freezer import cached_frozen_mask


def polar_transform_np(u: np.ndarray) -> np.ndarray:
    """x = u F^{(x)m} over GF(2); u is [..., N] of 0/1, N a power of two."""
    x = np.asarray(u, dtype=np.uint8).copy()
    n = x.shape[-1]
    lead = x.shape[:-1]
    stages = n.bit_length() - 1
    for s in range(stages):
        x = x.reshape(*lead, 1 << s, 2, n >> (s + 1))
        x[..., 0, :] ^= x[..., 1, :]
        x = x.reshape(*lead, n)
    return x


def polar_transform(u):
    """JAX twin of :func:`polar_transform_np` (int dtype, 0/1 domain)."""
    x = jnp.asarray(u)
    n = x.shape[-1]
    lead = x.shape[:-1]
    stages = n.bit_length() - 1
    for s in range(stages):
        x = x.reshape(*lead, 1 << s, 2, n >> (s + 1))
        x = x.at[..., 0, :].set(x[..., 0, :] ^ x[..., 1, :])
        x = x.reshape(*lead, n)
    return x


@dataclasses.dataclass(frozen=True)
class PolarCode:
    """Static description of one shortened systematic polar code."""

    n: int            # shortened (transmitted) length, e.g. 64800
    k: int            # payload + crc bits carried, e.g. 43072
    order: int        # mother code log2 length

    @property
    def code_len(self) -> int:
        return 1 << self.order

    @property
    def mesg_bits(self) -> int:
        """Info positions of the mother code (incl. the shortened tail)."""
        return self.k + self.code_len - self.n

    @functools.cached_property
    def frozen(self) -> np.ndarray:
        return cached_frozen_mask(self.n, self.k, self.order)

    @functools.cached_property
    def info_idx(self) -> np.ndarray:
        """Mother-code positions of the mesg_bits info bits, ascending."""
        return np.nonzero(self.frozen == 0)[0].astype(np.int32)

    @functools.cached_property
    def kept_idx(self) -> np.ndarray:
        """Mother-code positions transmitted after shortening, ascending.

        encode.cc:180-186: all frozen positions plus the first k
        information positions survive; the info tail is dropped.
        """
        frozen_pos = np.nonzero(self.frozen)[0]
        kept = np.union1d(frozen_pos, self.info_idx[: self.k])
        assert len(kept) == self.n
        return kept.astype(np.int32)

    @functools.cached_property
    def shortened_idx(self) -> np.ndarray:
        """Dropped mother-code positions (known bit 0)."""
        return self.info_idx[self.k:]

    # -- encoding ----------------------------------------------------------

    def encode_systematic_np(self, mesg_bits: np.ndarray) -> np.ndarray:
        """[..., mesg_bits] info bits -> [..., code_len] codeword with the
        info bits appearing verbatim at ``info_idx``."""
        u = np.zeros(mesg_bits.shape[:-1] + (self.code_len,), dtype=np.uint8)
        u[..., self.info_idx] = mesg_bits
        x = polar_transform_np(u)
        x[..., np.nonzero(self.frozen)[0]] = 0
        x = polar_transform_np(x)
        return x

    def encode_systematic(self, mesg_bits):
        u = jnp.zeros(mesg_bits.shape[:-1] + (self.code_len,),
                      dtype=jnp.uint8)
        u = u.at[..., jnp.asarray(self.info_idx)].set(mesg_bits)
        x = polar_transform(u)
        x = x * jnp.asarray(1 - self.frozen, dtype=jnp.uint8)
        return polar_transform(x)

    def shorten_np(self, codeword: np.ndarray) -> np.ndarray:
        return codeword[..., self.kept_idx]

    def lengthen_np(self, llrs: np.ndarray,
                    known_llr: float = 9000.0) -> np.ndarray:
        """Scatter received LLRs back to mother-code positions; shortened
        positions get the known-bit-0 LLR (decode.cc:245-253)."""
        out = np.full(llrs.shape[:-1] + (self.code_len,), known_llr,
                      dtype=llrs.dtype)
        out[..., self.kept_idx] = llrs
        return out

    def lengthen(self, llrs, known_llr: float = 9000.0):
        out = jnp.full(llrs.shape[:-1] + (self.code_len,), known_llr,
                       dtype=llrs.dtype)
        return out.at[..., jnp.asarray(self.kept_idx)].set(llrs)

    def extract_info_np(self, codeword: np.ndarray) -> np.ndarray:
        """Codeword -> k payload+crc bits (systematic positions)."""
        return codeword[..., self.info_idx[: self.k]]


@functools.lru_cache(maxsize=None)
def wire_code(n: int, k: int = 43072, order: int = 16) -> PolarCode:
    return PolarCode(n=n, k=k, order=order)
