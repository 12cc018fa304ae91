"""Decode pipeline: WAV samples -> payload bytes.

Array-program re-design of the reference Decoder (decode.cc:161-557).  The
reference is one constructor that streams samples through sync, header
and payload stages; here the stages are jitted array passes over the
whole recording, orchestrated host-side:

  1. front-end (dsp.frontend): DC-block + Hilbert for mono input,
  2. sync (sync.Synchronizer): vectorised Schmidl-Cox scan -> candidates,
  3. header (jitted): CFO mixdown, N-point FFT, MLS1 descramble,
     bin-differential int8 soft bits, order-4 OSD, CRC16 -> mode+callsign,
  4. payload (jitted per (rate, mode)): batched per-row FFT demod with a
     continuous CFO phasor, time-differential constellation, Theil-Sen
     derotation, cumulative-SNR soft demap, lengthen,
  5. SCL polar decode + CRC32 candidate select (device VM when available,
     numpy reference otherwise), bit-flip count, descramble.

The receiver's carrier layout is offset-free (code_off = -cols/2,
mls1_off = -127; decode.cc:183-186,454): the coarse CFO estimate absorbs
the transmit frequency offset.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import bits as B
from . import cplx, dsp, fft, ofdm, psk, sync, track
from .fec.osd import osd_decode
from .fec.polar import PolarCode
from .fec.scl_np import scl_decode_np
from .fec.scl_vm import cached_jit_decoder
from .numerology import MAX_CALL_SIGN, MODES, ModemConfig, make_config


@dataclasses.dataclass
class DecodeResult:
    ok: bool
    payload: Optional[bytes] = None
    oper_mode: int = -1
    call_sign: str = ""
    symbol_pos: int = -1
    cfo_hz: float = 0.0
    sfo_ppm: float = 0.0
    snr_db: Optional[np.ndarray] = None
    bit_flips: int = -1
    status: str = ""
    # True when the final ``status`` text was already written to the
    # transcript log — callers (cli.py) print unemitted statuses
    # instead of keeping a duplicate status-string list in sync
    status_emitted: bool = False


def _rx_config(rate: int, oper_mode: int) -> ModemConfig:
    """Receiver-side config: offset-free carrier layout."""
    return ModemConfig(rate=rate, mode=MODES[oper_mode], freq_off=0)


class Decoder:
    """Per-rate decoder; payload pipelines jit-specialise per mode."""

    def __init__(self, rate: int, list_size: int = 8,
                 device_scl="auto", scl_exact: bool = True,
                 estimator: str | None = "all_pairs",
                 mls_convention: str = "galois"):
        # mode choice does not affect the front-end/sync/header stages
        from .numerology import SUPPORTED_RATES
        if rate not in SUPPORTED_RATES:
            raise ValueError(f"unsupported sample rate {rate}")
        self.rate = rate
        # mls_convention="auto": the receiver builds one matched sync
        # kernel per LFSR convention, keeps every gate-passing
        # convention as a ranked hypothesis, and the header stage
        # commits the first whose OSD+CRC16 validates (the MLS phase
        # is a wire-format unknown with no golden waveform to pin it;
        # sync alone cannot separate the hypotheses — sync._fine_stage
        # and docs/WIRE_FORMAT.md).  Default "galois": the framework's
        # wire convention, single-hypothesis, reference-transcript
        # semantics.
        self.cfg = ModemConfig(rate=rate, mode=MODES[6], freq_off=0,
                               mls_convention=mls_convention)
        self.list_size = list_size
        # scl_exact (default True): provably bit-by-bit-SCL-equivalent
        # device decode via the one-shot RATE1/SPC enumeration
        # (scl_vm._oneshot) — the reference's fork-at-every-info-bit
        # semantics (decode.cc:530) at ~5% over the Fast-SSC-List
        # approximation, whose measured wire-size gap was 1 frame in
        # 500 (bench/ab_scl.py)
        self.scl_exact = scl_exact
        # device_scl: run list decoding through the on-device schedule
        # VM instead of the host numpy reference.  The
        # numpy SCL is leaf-exact but takes ~minutes at the 2^16 wire
        # size, so "auto" (device) is the default; pass False to use it
        # as a correctness oracle.
        if device_scl == "auto":
            device_scl = True
        self.device_scl = device_scl
        # Theil-Sen variant, captured at construction and passed at
        # trace time (a module-global flip after jit had no effect).
        # The INTERACTIVE decoder defaults to the reference's exact
        # all-pairs median (DSP::TheilSenEstimator, decode.cc:488-494)
        # so reference-transcript parity never rides the approximation;
        # the batch serving path keeps the O(n) disjoint variant, whose
        # decode outcomes matched all-pairs in an A/B over the
        # impaired channel.
        self.estimator = estimator
        self._payload_cache: dict[int, object] = {}
        self.sync = sync.Synchronizer(self.cfg)
        # one MLS1 header descrambler per sync-kernel convention; the
        # per-candidate detected index selects the row at trace time
        self._mls1_seqs = np.stack(
            [B.mls_nrz(self.cfg.mls1_poly, self.cfg.mls1_len,
                       convention=c).astype(np.float32)
             for c in self.sync.conventions])
        self._header_jit = jax.jit(self._header_soft)
        # one compiled call instead of eager per-op dispatch
        self._osd_jit = jax.jit(lambda soft: osd_decode(soft))
        self._frontend_jit = jax.jit(
            functools.partial(
                dsp.frontend, channels=1,
                dc_window=2 * self.cfg.extended_len,
                taps=self.cfg.filter_len))

    # ------------------------------------------------------------------
    # header stage (decode.cc:398-446)
    # ------------------------------------------------------------------
    def _header_soft(self, window, cfo_rad, conv=0):
        """window: [N, 2] samples of the metadata symbol; returns int8-ish
        soft bits [255] for the OSD.  ``conv`` (traced int32) selects
        the MLS1 descrambler matching the sync stage's detected LFSR
        convention (constant 0 for a single-convention receiver)."""
        cfg = self.cfg
        n = cfg.symbol_len
        idx = jnp.arange(n, dtype=jnp.float32)
        mixed = cplx.cmul(window, cplx.expi(-cfo_rad * idx))
        spec = fft.fwd(mixed)
        mls1_off = -(cfg.mls1_len // 2)
        bins = jnp.asarray(
            ofdm.bin_index(np.arange(cfg.mls1_len) + mls1_off, n))
        seq = jnp.asarray(self._mls1_seqs)[conv]
        carriers = spec[bins] * seq[:, None]
        prev_bins = jnp.asarray(
            ofdm.bin_index(np.arange(cfg.mls1_len) + mls1_off - 1, n))
        prev = spec[prev_bins]
        # the i-1 carrier is descrambled by seq[i-1] for i>0; position
        # -1 is the unscrambled amplitude reference (encode.cc:169)
        prev_seq = jnp.concatenate(
            [jnp.ones(1, jnp.float32), seq[:-1]])
        prev = prev * prev_seq[:, None]
        cons = ofdm.demod_or_erase(carriers, prev)
        return jnp.clip(jnp.round(127.0 * cons[..., 0]), -128, 127)

    @staticmethod
    def _validate_header(data: np.ndarray, emit=lambda s: None):
        """71 decoded header bits -> ((mode, call), status).  Emits the
        reference's stderr lines in its order — "oper mode" prints as
        soon as the mode validates, BEFORE the callsign check
        (decode.cc:422-446); error statuses match its text exactly."""
        md = 0
        for i in range(55):
            md |= int(data[i]) << i
        cs = 0
        for i in range(16):
            cs |= int(data[55 + i]) << i
        if B.crc16.over_value(md << 9, 64) != cs:
            return None, "header CRC error."
        oper_mode = md & 255
        if oper_mode not in MODES:
            return None, f"operation mode {oper_mode} unsupported."
        emit(f"oper mode: {oper_mode}")
        call = md >> 8
        if call == 0 or call >= MAX_CALL_SIGN:
            return None, "call sign unsupported."
        emit(f"call sign: {B.base37_decode(call).lstrip()}")
        return (oper_mode, call), "ok"

    def _decode_header(self, x: np.ndarray, cand: sync.SyncCandidate,
                       emit=lambda s: None):
        """Walk the candidate's convention hypotheses (one for a
        single-convention receiver) and commit the first whose header
        validates; the failure status reported is the BEST-ranked
        hypothesis's (what a single-kernel reference receiver would
        see, decode.cc:417-432)."""
        cfg = self.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        alts = cand.alts or ((cand.conv, cand.p0, cand.cfo_rad,
                              cand.peak_ratio),)
        first_fail = None
        first_fail_pend: list[str] = []
        for alt in alts:
            conv, p0, cfo_rad, _ratio = alt
            pend: list[str] = []
            if p0 + s + g < 0 or p0 + 2 * s + g > len(x):
                fail = (None, "header window out of range")
            else:
                lo = p0 + s + g
                soft = self._header_jit(jnp.asarray(x[lo: lo + s]),
                                        jnp.float32(cfo_rad),
                                        jnp.int32(conv))
                data, unique = self._osd_jit(soft)
                if not bool(unique):
                    fail = (None, "OSD error.")
                else:
                    hdr, status = self._validate_header(
                        np.asarray(data), pend.append)
                    if hdr is not None:
                        cand.accept(alt)
                        for line in pend:
                            emit(line)
                        return hdr, status
                    fail = (None, status)
            if first_fail is None:
                # report (and transcribe) only the BEST-ranked
                # hypothesis's failure — what a single-kernel
                # reference receiver would print (decode.cc:417-446);
                # emitting every hypothesis's diagnostics would
                # duplicate transcript lines under "auto"
                first_fail = fail
                first_fail_pend = pend
        for line in first_fail_pend:
            emit(line)
        return first_fail

    # -- batched header path (serving; decode.cc:398-446 over all
    #    detected preambles in ONE jit) ---------------------------------
    def _headers_batch_jit(self, batch: int):
        fn = self._payload_cache.get(("headers", batch))
        if fn is None:
            def run(wins, cfos, convs):
                soft = jax.vmap(self._header_soft)(wins, cfos, convs)
                data, unique = jax.vmap(lambda s_: osd_decode(s_))(soft)
                # pack (unique, data) into ONE int32 block: one
                # device-to-host copy instead of two
                return jnp.concatenate(
                    [unique.astype(jnp.int32)[:, None],
                     data.astype(jnp.int32)], axis=1)
            fn = jax.jit(run)
            self._payload_cache[("headers", batch)] = fn
        return fn

    def decode_headers_batch(self, x, cands):
        """Demod + OSD + CRC16 for ALL sync candidates in one jitted
        call (the auto-mode serving path's header stage; the
        interactive decoder keeps the per-candidate retry loop).

        ``x``: analytic [T, 2] f32 or an ingest.PcmRecording (header
        windows then go to the device in wire dtype and convert
        there).  Returns a list aligned with ``cands``: (header,
        status) pairs where header is (oper_mode, call) or None and
        status carries the reference's rejection text ("OSD error." /
        "header CRC error." / ... — decode.cc:417-446) so auto-mode
        callers can report WHY a preamble was rejected.  The batch
        pads to the next power of two so jit shapes are reused across
        recordings.

        Under mls_convention="auto" each candidate contributes one
        hypothesis per gate-passing convention (SyncCandidate.alts);
        all hypotheses demod+OSD in the same single jit, the first
        validating one is committed into its candidate (accept()), and
        a candidate whose hypotheses all fail reports its best-ranked
        hypothesis's status.
        """
        from . import ingest
        cfg = self.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        nc = len(cands)
        if nc == 0:
            return []
        pcm = x if isinstance(x, ingest.PcmRecording) else None
        t_all = pcm.n_samples if pcm is not None else len(x)
        hyps = []          # (cand index, alt, window in range, start)
        for i, c in enumerate(cands):
            alts = c.alts or ((c.conv, c.p0, c.cfo_rad, c.peak_ratio),)
            for alt in alts:
                lo = alt[1] + s + g
                hyps.append((i, alt, lo >= 0 and lo + s <= t_all,
                             max(lo, 0)))
        pad = 1 << max(0, (len(hyps) - 1).bit_length())
        cfos = np.zeros(pad, dtype=np.float32)
        convs = np.zeros(pad, dtype=np.int32)
        starts = [0] * pad
        for j, (_i, alt, ok_rng, lo) in enumerate(hyps):
            if not ok_rng:
                continue
            starts[j] = lo
            cfos[j] = alt[2]
            convs[j] = alt[0]
        if pcm is not None:
            wins = self.sync._pcm_windows(pcm, starts, s)
        else:
            wins = np.zeros((pad, s, 2), dtype=np.float32)
            for j, (_i, _alt, ok_rng, lo) in enumerate(hyps):
                if ok_rng:
                    wins[j] = x[lo: lo + s]
        packed = np.asarray(self._headers_batch_jit(pad)(
            jnp.asarray(wins), jnp.asarray(cfos),
            jnp.asarray(convs)))   # ONE fetch
        unique = packed[:, 0] != 0
        data = packed[:, 1:]
        out: list = [None] * nc
        for j, (i, alt, ok_rng, _lo) in enumerate(hyps):
            if out[i] is not None and out[i][0] is not None:
                continue                    # already committed
            if not ok_rng:
                res = (None, "past recording end")
            elif not unique[j]:
                res = (None, "OSD error.")   # decode.cc:417-418
            else:
                res = self._validate_header(data[j])
            if res[0] is not None:
                cands[i].accept(alt)
                out[i] = res
            elif out[i] is None:
                out[i] = res    # best-ranked hypothesis's failure
        return out

    # ------------------------------------------------------------------
    # payload stage (decode.cc:453-529)
    # ------------------------------------------------------------------
    def _payload_jit(self, oper_mode: int):
        # per-instance cache (an lru_cache on a method would pin every
        # Decoder instance, and its jit caches, for the process life)
        fn = self._payload_cache.get(oper_mode)
        if fn is None:
            fn = self._build_payload_jit(oper_mode)
            self._payload_cache[oper_mode] = fn
        return fn

    def _build_payload_jit(self, oper_mode: int):
        cfg = _rx_config(self.rate, oper_mode)
        mode = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        code_off = -mode.cons_cols // 2
        bins = ofdm.bin_index(
            np.arange(code_off, code_off + mode.cons_cols), s)

        def run(windows, cfo_rad):
            """windows: [rows+1, S, 2] starting at the pilot symbol."""
            w = jnp.arange(mode.cons_rows + 1,
                           dtype=jnp.float32)[:, None]
            k = jnp.arange(s, dtype=jnp.float32)[None, :]
            # oscillator phase continues from the metadata symbol
            # (advanced S there), through every guard (decode.cc:458-470)
            phase = -cfo_rad * (s + w * (s + g) + k)
            mixed = cplx.cmul(windows, cplx.expi(phase))
            spec = fft.fwd(mixed)
            carriers = spec[:, jnp.asarray(bins)]      # [rows+1, cols, 2]
            cons = ofdm.demod_or_erase(carriers[1:], carriers[:-1])
            cons, slope, yint = track.derotate_rows(
                cons, code_off, mode.mod_bits, self.estimator)
            llrs, snr = track.soft_llrs(cons, mode.mod_bits)
            return llrs.reshape(-1), snr, slope, yint

        return jax.jit(run)

    def _decode_payload(self, x: np.ndarray, cand: sync.SyncCandidate,
                        oper_mode: int):
        cfg = _rx_config(self.rate, oper_mode)
        mode = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        q0 = cand.p0 + 2 * (s + g)              # pilot symbol start
        rows = mode.cons_rows
        offs = q0 + np.arange(rows + 1) * (s + g)
        if offs[0] < 0 or offs[-1] + s > len(x):
            return None
        windows = np.stack([x[o: o + s] for o in offs])
        llrs, snr, slope, yint = self._payload_jit(oper_mode)(
            jnp.asarray(windows), jnp.float32(cand.cfo_rad))

        code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                         order=mode.code_order)
        full = code.lengthen_np(np.asarray(llrs, dtype=np.float64))
        if self.device_scl:
            # process-wide cache: the wire-size VM compile is identical
            # across Decoder instances
            dec = cached_jit_decoder(
                np.asarray(code.frozen, dtype=np.uint8).tobytes(),
                self.list_size, self.scl_exact)
            cands, pm = dec(jnp.asarray(full, dtype=jnp.float32))
            order = np.argsort(np.asarray(pm), kind="stable")
            cands = np.asarray(cands)[order]
        else:
            cands, _ = scl_decode_np(full, code.frozen, self.list_size)
        info = code.extract_info_np(cands)
        best = -1
        for k_ in range(info.shape[0]):
            if B.crc32.update_bits(0, info[k_]) == 0:
                best = k_
                break
        sfo_ppm = float(-slope * s / (s + g) / (2 * np.pi) * 1e6)
        cfo_fine = cand.cfo_rad + float(yint) / (s + g)
        stats = dict(payload=None, flips=None, snr=np.asarray(snr),
                     sfo_ppm=sfo_ppm,
                     cfo_hz=cfo_fine * self.rate / (2 * np.pi))
        if best < 0:
            # the reference prints sfo/cfo/Es-N0 BEFORE the polar
            # decode (decode.cc:502-523), so a CRC-less list still
            # reports its demod statistics ahead of `payload decoding
            # error.` (decode.cc:543) — payload=None marks the failure
            return stats
        mesg = info[best]
        # bit flips vs received hard decisions (decode.cc:546-555)
        received = full[code.info_idx[: mode.data_bits]] < 0
        stats["flips"] = int(np.sum(received != mesg[: mode.data_bits]))
        stats["payload"] = B.scramble(
            B.bits_to_bytes_le(mesg[: mode.data_bits]))
        return stats

    # ------------------------------------------------------------------
    # public API (decode.cc:559-620 semantics)
    # ------------------------------------------------------------------
    def decode(self, samples: np.ndarray, channels: int = 1,
               skip: int = 0, log=None) -> DecodeResult:
        """samples: [T] real mono or complex/[T,2] analytic recording.

        ``log``: optional text stream; when given, the decoder emits
        the reference binary's stderr transcript line-for-line
        (per-attempt sync position and coarse CFO decode.cc:400-401,
        header statuses :417-446, per-row demod dots :463-478, sfo/cfo
        :502-503, Es/N0 :506-523, bit flips :555).  The demod dots are
        emitted together after the batched row FFT returns — the
        transcript matches the reference at stage completion, not
        sample-by-sample.
        """
        emit = ((lambda m: print(m, file=log, flush=True))
                if log is not None else (lambda m: None))
        if channels == 1 and not np.iscomplexobj(samples):
            x = np.asarray(self._frontend_jit(
                jnp.asarray(samples, dtype=jnp.float32)))
        else:
            if np.iscomplexobj(samples):
                x = cplx.from_np(samples)
            else:
                x = np.asarray(samples, dtype=np.float32)

        result = DecodeResult(ok=False, status="no preamble found")
        for cand in self.sync.scan(x):
            if not cand.ok:
                continue
            # the header stage may commit a different convention
            # hypothesis (and with it p0 / cfo); buffer its transcript
            # lines so "symbol pos"/"coarse cfo" print the committed
            # values in the reference's order (decode.cc:400-401)
            pend: list[str] = []
            hdr, status = self._decode_header(x, cand, pend.append)
            emit(f"symbol pos: {cand.p0}")
            emit(f"coarse cfo: "
                 f"{cand.cfo_rad * self.rate / (2 * np.pi):.6g} Hz ")
            for line in pend:
                emit(line)
            result.status = status
            if hdr is None:
                emit(status)
                # in-loop header statuses ARE the transcript when a
                # log is given; the flag holds for whichever ends up
                # terminal
                result.status_emitted = log is not None
                continue
            if skip > 0:
                skip -= 1
                result.status = "ran out of frames while skipping"
                result.status_emitted = False
                continue
            oper_mode, call = hdr
            result.oper_mode = oper_mode
            result.call_sign = B.base37_decode(call).lstrip()
            result.symbol_pos = cand.p0
            result.cfo_hz = cand.cfo_rad * self.rate / (2 * np.pi)
            rows = MODES[oper_mode].cons_rows
            pay = self._decode_payload(x, cand, oper_mode)
            emit("demod " + "." * rows + " done")
            if pay is not None:
                # the reference prints these ahead of the decode
                # outcome (decode.cc:502-523 before :543)
                emit(f"coarse sfo: {pay['sfo_ppm']:.6g} ppm")
                emit(f"finer cfo: {pay['cfo_hz']:.6g} Hz ")
                emit("Es/N0 (dB): "
                     + " ".join(f"{v:.6g}" for v in pay["snr"]))
            if pay is None or pay["payload"] is None:
                result.status = "payload decoding error."
                emit(result.status)
                result.status_emitted = log is not None
                if pay is not None:
                    result.snr_db = pay["snr"]
                    result.sfo_ppm = pay["sfo_ppm"]
                    result.cfo_hz = pay["cfo_hz"]
                return result
            emit(f"bit flips: {pay['flips']}")
            result.ok = True
            result.payload = pay["payload"]
            result.bit_flips = pay["flips"]
            result.snr_db = pay["snr"]
            result.sfo_ppm = pay["sfo_ppm"]
            result.cfo_hz = pay["cfo_hz"]
            result.status = "ok"
            return result
        return result


@functools.lru_cache(maxsize=None)
def cached_decoder(rate: int, list_size: int = 8,
                   mls_convention: str = "galois") -> Decoder:
    return Decoder(rate, list_size, mls_convention=mls_convention)
