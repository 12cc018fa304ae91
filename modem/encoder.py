"""Encode pipeline: payload bytes -> OFDM waveform.

Array-program re-design of the reference Encoder (encode.cc:27-318).  The
reference's constructor-as-pipeline synthesises one symbol at a time;
here a frame is assembled as a [frame_symbols, N, 2] split-complex
spectrum array and synthesised with one batched matmul-IFFT pass
(ofdm.synthesize).  The time-differential PSK accumulation across
payload rows (encode.cc:304-308) becomes a cumulative *phase* sum over
the row axis — exact for unit-modulus PSK factors, with no error
accumulation.

Frame layout on air (encode.cc:288-313):
  [1 s silence] [pilot] { [schmidl_cox] [metadata] [pilot] [payload rows] }
  per input block, then [zero flush symbol] [1 s silence].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import bits as B
from . import cplx, ofdm, psk
from .fec import bch
from .fec.polar import PolarCode
from .numerology import MLS2_POLY, ModemConfig


class Encoder:
    """Precomputes per-config constants; encode() runs the jitted path."""

    def __init__(self, cfg: ModemConfig):
        cfg.validate()
        if cfg.mls_convention == "auto":
            raise ValueError("mls_convention='auto' is receive-only; "
                             "a transmitter must commit to one")
        self.cfg = cfg
        mode = cfg.mode
        n = cfg.symbol_len
        conv = cfg.mls_convention
        self.code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                              order=mode.code_order)

        # --- pilot block spectrum (encode.cc:132-141) ---------------------
        self.code_fac = float(np.sqrt(n / mode.cons_cols))
        pilot = np.zeros(n, dtype=np.complex64)
        seq2 = B.mls_nrz(MLS2_POLY, mode.cons_cols, convention=conv)
        cols_bins = ofdm.bin_index(
            np.arange(cfg.code_off, cfg.code_off + mode.cons_cols), n)
        pilot[cols_bins] = self.code_fac * seq2
        self.pilot_fdom = pilot
        self.cols_bins = cols_bins
        # pilot carrier phases: 0 or pi (the +/-1 MLS2 signs)
        self.pilot_phase = np.where(seq2 > 0, 0.0, np.pi).astype(np.float32)

        # --- Schmidl-Cox preamble spectrum (encode.cc:142-154) ------------
        mls0_fac = np.sqrt(2.0 * n / cfg.mls0_len)
        sc = np.zeros(n, dtype=np.complex64)
        sc[ofdm.bin_index(cfg.mls0_off - 2, n)] = mls0_fac
        seq0 = B.mls_nrz(cfg.mls0_poly, cfg.mls0_len, convention=conv)
        even_bins = ofdm.bin_index(
            2 * np.arange(cfg.mls0_len) + cfg.mls0_off, n)
        # cumulative differential over the even bins, seeded by the
        # reference-amplitude carrier two bins below
        sc[even_bins] = mls0_fac * np.cumprod(seq0)
        self.sc_fdom = sc

        # --- metadata scrambler (encode.cc:165-177) -----------------------
        self.mls1_seq = B.mls_nrz(cfg.mls1_poly, cfg.mls1_len,
                                  convention=conv)
        self.mls1_fac = float(np.sqrt(n / cfg.mls1_len))

        # continuous encode compiles per CHUNK size from a pow2 ladder
        # (1/2/4/8 frames + a tiny pilot/flush graph), so ANY file
        # count reuses one bounded set of graphs — the old whole-
        # transmission graph recompiled per distinct frame count (a
        # 387 s compile-bomb class at large counts)
        self._encode_chunk_jit = jax.jit(
            self._encode_chunk, static_argnames=("n_frames",))
        self._edge_jit = jax.jit(self._encode_edges)
        # one-frame recordings vmapped over a batch (the serving path)
        self._encode_batch_jit = jax.jit(jax.vmap(
            lambda m, f: self._encode_traced(m[None], f[None], 1)))

        def _enc_pcm16(m, f):
            wave, papr = self._encode_traced(m[None], f[None], 1)
            q = jnp.clip(jnp.round(wave * 32767.0), -32768, 32767)
            return q.astype(jnp.int16), papr

        self._encode_pcm16_jit = jax.jit(jax.vmap(_enc_pcm16))

    # -- host-side metadata spectrum (encode.cc:155-179) -------------------
    def meta_fdom(self, call_sign: int) -> np.ndarray:
        cfg = self.cfg
        md = (call_sign << 8) | cfg.mode.oper_mode
        hdr = np.array([(md >> i) & 1 for i in range(55)], dtype=np.uint8)
        cs = B.crc16.over_value(md << 9, 64)
        cs_bits = np.array([(cs >> i) & 1 for i in range(16)],
                           dtype=np.uint8)
        data71 = np.concatenate([hdr, cs_bits])
        parity = bch.encode(data71)
        nrz = B.nrz(np.concatenate([data71, parity])).astype(np.float64)
        # Differential encode seeded by the reference-amplitude carrier at
        # mls1_off - 1, then MLS1 scrambling (encode.cc:169-177).
        diff = self.mls1_fac * np.cumprod(nrz)
        fdom = np.zeros(cfg.symbol_len, dtype=np.complex64)
        fdom[ofdm.bin_index(cfg.mls1_off - 1, cfg.symbol_len)] = \
            self.mls1_fac
        bins = ofdm.bin_index(np.arange(cfg.mls1_len) + cfg.mls1_off,
                              cfg.symbol_len)
        fdom[bins] = diff * self.mls1_seq
        return fdom

    # -- payload framing (encode.cc:293-301) -------------------------------
    def mesg_bits(self, payload: bytes) -> np.ndarray:
        mode = self.cfg.mode
        assert len(payload) == mode.data_bytes
        pbits = B.bytes_to_bits_le(payload)
        crc = B.crc32.over_bytes(payload)
        crc_bits = np.array([(crc >> i) & 1 for i in range(32)],
                            dtype=np.uint8)
        mesg = np.zeros(mode.mesg_bits, dtype=np.uint8)
        mesg[: mode.data_bits] = pbits
        mesg[mode.data_bits: mode.crc_bits] = crc_bits
        # tail stays 0: shortened info bits pinned to bit 0 (+1 NRZ)
        return mesg

    def _frame_rows(self, mesg, meta_fdom, n_frames: int):
        """Per-frame symbol spectra [F*frame_symbols, N, 2] (traced)."""
        cfg = self.cfg
        mode = cfg.mode
        n = cfg.symbol_len

        # payload bits -> per-(row, carrier) unit PSK phase increments
        cw = self.code.encode_systematic(mesg)
        short = cw[..., jnp.asarray(self.code.kept_idx)]
        grouped = short.reshape(n_frames, mode.cons_rows, mode.cons_cols,
                                mode.mod_bits)
        theta = psk.mod_phase(mode.mod_bits,
                              1.0 - 2.0 * grouped.astype(jnp.float32))

        # Time-differential accumulation seeded by the pilot
        # (encode.cc:304-308), exact in the phase domain.
        phase = jnp.asarray(self.pilot_phase)[None, None, :] + jnp.cumsum(
            theta, axis=1)
        carriers = self.code_fac * cplx.expi(phase)   # [F, rows, cols, 2]
        payload_rows = jnp.zeros((n_frames, mode.cons_rows, n, 2),
                                 dtype=jnp.float32)
        payload_rows = payload_rows.at[
            :, :, jnp.asarray(self.cols_bins), :].set(carriers)

        sc = jnp.asarray(cplx.from_np(self.sc_fdom))
        pil = jnp.asarray(cplx.from_np(self.pilot_fdom))
        per_frame = jnp.concatenate([
            jnp.broadcast_to(sc, (n_frames, 1, n, 2)),
            meta_fdom[:, None],
            jnp.broadcast_to(pil, (n_frames, 1, n, 2)),
            payload_rows], axis=1)                    # [F, 3+rows, N, 2]
        return per_frame.reshape(-1, n, 2)

    def _encode_traced(self, mesg, meta_fdom, n_frames: int):
        """Whole continuous transmission in one graph (the batch path
        still uses this via vmap at n_frames=1)."""
        cfg = self.cfg
        rows = self._frame_rows(mesg, meta_fdom, n_frames)
        pil = jnp.asarray(cplx.from_np(self.pilot_fdom))
        fdom = jnp.concatenate([
            pil[None],                                # leading pilot
            rows,
            jnp.zeros((1,) + rows.shape[1:], jnp.float32)], axis=0)
        papr_mask = np.ones(fdom.shape[0], dtype=bool)
        papr_mask[1 + np.arange(n_frames) * cfg.frame_symbols] = False  # S&C
        return ofdm.synthesize(fdom, cfg.guard_len, papr_mask)

    def _encode_chunk(self, mesg, meta_fdom, prev_head, n_frames: int):
        """Frame chunk with explicit crossfade carry (bounded graphs)."""
        cfg = self.cfg
        rows = self._frame_rows(mesg, meta_fdom, n_frames)
        papr_mask = np.ones(rows.shape[0], dtype=bool)
        papr_mask[np.arange(n_frames) * cfg.frame_symbols] = False  # S&C
        return ofdm.synthesize_carry(rows, cfg.guard_len, papr_mask,
                                     prev_head)

    def _encode_edges(self, prev_head):
        """Leading pilot symbol (stream start) and, given the LAST
        payload symbol's head, the flush symbol (encode.cc:311-313)."""
        cfg = self.cfg
        pil = jnp.asarray(cplx.from_np(self.pilot_fdom))
        w_p, papr_p, head_p = ofdm.synthesize_carry(
            pil[None], cfg.guard_len, None, None)
        flush = jnp.zeros((1, cfg.symbol_len, 2), jnp.float32)
        w_f, papr_f, _ = ofdm.synthesize_carry(
            flush, cfg.guard_len, None, prev_head)
        return w_p, papr_p, head_p, w_f, papr_f

    ENCODE_CHUNK_FRAMES = 8        # pow2 ladder cap: graphs for 1/2/4/8

    def encode(self, payloads, call_sign: int, scramble: bool = True):
        """payload blocks -> (complex waveform [T], papr metrics).

        ``payloads``: bytes (one frame) or list of bytes.  The returned
        waveform excludes the 1 s silence pads; wav writing adds them
        (encode.cc:423,441).  Frames synthesise in pow2-ladder chunks
        with the guard-crossfade head carried between chunks, so any
        frame count reuses ONE bounded set of compiled graphs.
        """
        if isinstance(payloads, (bytes, bytearray)):
            payloads = [bytes(payloads)]
        if scramble:
            payloads = [B.scramble(p) for p in payloads]
        mesg = np.stack([self.mesg_bits(p) for p in payloads])
        meta = np.broadcast_to(
            cplx.from_np(self.meta_fdom(call_sign)),
            (len(payloads), self.cfg.symbol_len, 2))
        waves, paprs = [], []
        n = len(payloads)
        g0 = 0
        head = None
        pilot_parts = None
        while g0 < n:
            rem = n - g0
            c = min(self.ENCODE_CHUNK_FRAMES,
                    1 << (rem.bit_length() - 1))
            if head is None:
                # pilot graph also primes the carry for chunk 0
                w_p, papr_p, head, w_f_unused, _pf = self._edge_jit(
                    jnp.zeros((self.cfg.guard_len, 2), jnp.float32))
                pilot_parts = (w_p, papr_p)
            w, papr, head = self._encode_chunk_jit(
                jnp.asarray(mesg[g0: g0 + c]),
                jnp.asarray(meta[g0: g0 + c]), head, n_frames=c)
            waves.append(w)
            paprs.append(papr)
            g0 += c
        _wp, _pp, _hp, w_f, papr_f = self._edge_jit(head)
        wave = jnp.concatenate(
            [pilot_parts[0]] + waves + [w_f], axis=0)
        papr = jnp.concatenate(
            [pilot_parts[1]] + paprs + [papr_f], axis=0)
        return cplx.to_np(wave), np.asarray(papr)


    def encode_batch(self, payloads, call_sign: int,
                     scramble: bool = True, pcm_bits: int = 0):
        """Batch of INDEPENDENT single-frame recordings in one jit.

        Unlike encode(list), which concatenates the frames into one
        continuous transmission (encode.cc:289), every payload here
        becomes its own recording [pilot | S&C | meta | pilot | rows |
        flush] — the shape a batched serving decoder consumes.

        pcm_bits=16 quantises on device (wav.hh semantics, matching
        wav._quantize int16) and returns int16 [B, T, 2]: half the
        host-fetch bytes, and the quantisation runs on the device
        instead of the host codec.  pcm_bits=0 returns float32 complex.

        Returns (waveforms [B, T] complex or [B, T, 2] int16,
        papr [B, n_sym, 2]).
        """
        if scramble:
            payloads = [B.scramble(p) for p in payloads]
        mesg = jnp.asarray(np.stack([self.mesg_bits(p) for p in payloads]))
        meta = jnp.asarray(np.broadcast_to(
            cplx.from_np(self.meta_fdom(call_sign)),
            (len(payloads), self.cfg.symbol_len, 2)))
        if pcm_bits == 16:
            wave, papr = self._encode_pcm16_jit(mesg, meta)
            return np.asarray(wave), np.asarray(papr)
        wave, papr = self._encode_batch_jit(mesg, meta)
        return cplx.to_np(wave), np.asarray(papr)


@functools.lru_cache(maxsize=None)
def cached_encoder(cfg: ModemConfig) -> Encoder:
    return Encoder(cfg)
