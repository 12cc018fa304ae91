"""Streaming (live) decode: feed PCM as it arrives, emit each frame as
soon as its last payload sample lands.

The reference decodes live audio one sample at a time from a pipe
(decode.cc:294-301; the README's `arecord -f S16_LE | decode`
workflow), so a reference user gets output the moment a frame ends.
The batch pipeline here wants the whole recording up front — this
module closes that gap on the device:

* raw samples accumulate into the SAME fixed-shape chunked scan graphs
  as ``sync.scan`` (one compiled graph per stream, m=1 super-batches);
  the Schmitt-trigger state and the segmented-argmax running maximum
  thread across ``feed()`` calls as device scalars, exactly as they
  thread across super-batches in the offline pass;
* sync candidates finalize (fine timing / CFO, uniqueness gates) as
  soon as their fine window is buffered;
* headers (BCH+OSD metadata) decode as soon as the metadata symbol is
  buffered, payloads as soon as the frame tail is buffered — grouped
  per ``feed()`` call into the same batched jits as
  ``decode_recording_auto``.

End-to-end added latency is ~2 scan chunks of audio (default 8192
samples ≈ 1 s at 8 kHz) + the stage jit calls, independent of stream
length.  Host memory stays bounded: buffers retire behind a watermark
that protects the oldest pending frame's payload window.

Supported inputs: integer wire PCM (int16 / uint8; mono ``[n]`` runs
the dequantise + BlockDC + Hilbert front-end ON DEVICE inside the scan
graphs, stereo ``[n, 2]`` dequantises there too) or float analytic
(``[n, 2]`` split-complex or complex).  Float mono is rejected —
quantise to int16 (the wire format) instead.

Parity: on a complete stream the emitted frames match
``pipeline.decode_recording_auto`` on the same recording
(tests/test_stream.py).  A frame whose header or payload window
extends past the true stream end is reported "past recording end"
(never decoded against the silence pad) — the reference stops at read
failure, decode.cc:296-297.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from . import bits as B
from . import cplx
from .numerology import MODES, ModemConfig
from .sync import _BLK


def _silence(bits) -> int:
    return 128 if bits == 8 else 0


class StreamDecoder:
    """Incremental decoder for one PCM stream (one rate/channel config).

    Usage::

        sd = StreamDecoder(rate=8000, channels=1, bits=16)
        for chunk in source:          # np int16 [n]
            for frame in sd.feed(chunk):
                ...                   # frame dicts, decode_recording_auto
        for frame in sd.finish():     # flush the tail
            ...
    """

    # per-chunk falling-edge cap.  The batch path keeps 4*max_frames
    # (= 256 by default) edges per 2^17-sample chunk; 32 per
    # 8192-sample chunk is twice that density, so spurious noise
    # edges cannot consume slots ahead of a real preamble any earlier
    # than they would offline (sync.scan's documented per-chunk cap
    # caveat applies equally here).
    EDGES_PER_CHUNK = 32

    def __init__(self, rate: int, channels: int = 2, bits=16,
                 chunk_samples: int = 8192,
                 mls_convention: str = "galois"):
        from .decoder import cached_decoder
        self.rate = rate
        self.dec = cached_decoder(rate, mls_convention=mls_convention)
        self.sync = self.dec.sync
        cfg = self.sync.cfg
        self.cfg = cfg
        self.channels = channels
        self.bits = bits                     # None => float analytic
        L = self.sync.L
        self.L = L
        self.ctx = -(-(2 * L + self.sync.match_len) // _BLK) * _BLK
        self.c = max(-(-int(chunk_samples) // _BLK) * _BLK, self.ctx)
        if bits is None:
            if channels == 1:
                raise ValueError(
                    "float mono streaming is unsupported; feed int16 "
                    "wire PCM (the on-device front-end path)")
            self.front = None
            self.fl = 0
        else:
            self.front = ("mono" if channels == 1 else "stereo", bits)
            self.fl = self.sync.front_lead if channels == 1 else 0

        # raw wire-dtype buffer (integer PCM only); _r0 = absolute
        # sample index of _raw[0]
        self._raw = None
        self._r0 = 0
        self._nraw = 0                       # total samples received
        # analytic float buffer; _a0 = absolute index of _an[0];
        # canonical coverage is [_a0, _a0 + len(_an))
        self._an = np.zeros((0, 2), np.float32)
        self._a0 = 0
        self._tail = None                    # final 2L analytic tail
        self._n_chunks = 0                   # completed scan chunks
        self._st = jnp.asarray(False)        # Schmitt carry
        self._mx = (jnp.float32(-np.inf), jnp.int32(0),
                    jnp.float32(0.0))        # argmax carry
        self._events = []                    # (p0, frac_cfo) pending
        self._cands = []                     # ok SyncCandidates pending
        self._frames = []                    # (cand, mode, call) pending
        self._finished = False
        self._eos = None                     # true stream length (finish)

    # -- input plumbing ----------------------------------------------------

    def _norm(self, samples: np.ndarray) -> np.ndarray:
        if self.bits is None:
            x = np.asarray(samples)
            if np.iscomplexobj(x):
                x = cplx.from_np(x)
            x = np.asarray(x, np.float32)
            if x.ndim != 2 or x.shape[1] != 2:
                raise ValueError("float stream must be [n, 2] or complex")
            return x
        want = np.int16 if self.bits == 16 else np.uint8
        x = np.asarray(samples)
        if x.dtype != want:
            raise ValueError(f"bits={self.bits} stream needs {want}")
        if self.channels == 1 and x.ndim != 1:
            raise ValueError("mono stream must be [n]")
        if self.channels == 2 and (x.ndim != 2 or x.shape[1] != 2):
            raise ValueError("stereo stream must be [n, 2]")
        return x

    def _append_raw(self, x: np.ndarray) -> None:
        if self.bits is None:
            # float analytic: the raw buffer IS the analytic buffer
            self._an = np.concatenate([self._an, x]) if len(self._an) \
                else x.copy()
            self._nraw += len(x)
            return
        self._raw = x.copy() if self._raw is None or not len(self._raw) \
            else np.concatenate([self._raw, x])
        self._nraw += len(x)

    def _raw_slice(self, lo: int, hi: int) -> np.ndarray:
        """Absolute [lo, hi) of the wire stream, silence-padded outside
        what has been received (the recording-start pad and, after
        finish(), the tail pad)."""
        if self.bits is None:
            out = np.zeros((hi - lo, 2), np.float32)
            src, s0 = self._an, self._a0
        else:
            fill = _silence(self.bits)
            shape = ((hi - lo,) if self.channels == 1
                     else (hi - lo, self.channels))
            out = np.full(shape, fill, self._raw.dtype)
            src, s0 = self._raw, self._r0
        a = max(lo, s0)
        b = min(hi, s0 + len(src))
        if b > a:
            out[a - lo: b - lo] = src[a - s0: b - s0]
        return out

    def _an_slice(self, lo: int, n: int) -> np.ndarray:
        """Absolute [lo, lo + n) of the analytic signal, zero-padded
        outside coverage; the final tail extends coverage by 2L."""
        out = np.zeros((n, 2), np.float32)
        a = max(lo, self._a0)
        b = min(lo + n, self._a0 + len(self._an))
        if b > a:
            out[a - lo: b - lo] = self._an[a - self._a0: b - self._a0]
        if self._tail is not None:
            t0 = self._a0 + len(self._an)
            a = max(lo, t0)
            b = min(lo + n, t0 + len(self._tail))
            if b > a:
                out[a - lo: b - lo] = self._tail[a - t0: b - t0]
        return out

    # -- the incremental scan ----------------------------------------------

    # Ready chunks per feed() batch in pow2 super-batches up to this
    # (the offline scan's vmapped path, sync.MAX_CHUNKS_PER_CALL):
    # live pacing delivers <1 chunk per feed (m=1, one compiled graph),
    # while file replay with large feeds amortizes the per-call
    # dispatch 16x.  The cross-chunk Schmitt/argmax carries compose
    # inside the batch exactly as offline (_extract_batch_fn).
    MAX_CHUNKS_PER_FEED = 16

    def _run_chunks(self, n0: int, m: int) -> list:
        """One m-chunk super-batch of the chunked scan starting at
        chunk start n0; returns raw (edge, n_max, phase) events
        (sync._events_device's step with the carries threaded on this
        object)."""
        retain = self.front is not None
        fn = self.sync._extract_batch_fn(
            self.c, self.ctx, self.EDGES_PER_CHUNK, m, self.front,
            retain)
        segs = np.stack([self._raw_slice(
            n0 + j * self.c - self.ctx - self.fl,
            n0 + j * self.c + self.c + 2 * self.L) for j in range(m)])
        n0s = np.asarray([n0 + j * self.c for j in range(m)], np.int32)
        if retain:
            edges, nmax, ph, self._st, self._mx, keep = fn(
                segs, n0s, self._st, self._mx)
            k = np.asarray(keep)
            canon = np.ascontiguousarray(
                k[:, :self.c].reshape(-1, 2))
            self._tail = k[-1, self.c:]
            self._an = (np.concatenate([self._an, canon])
                        if len(self._an) else canon)
        else:
            edges, nmax, ph, self._st, self._mx = fn(
                segs, n0s, self._st, self._mx)
            self._tail = None          # float _an already covers it
        self._n_chunks += m
        edges, nmax, ph = (np.asarray(v) for v in (edges, nmax, ph))
        out = []
        for j in range(m):
            for e, nm, p_ in zip(edges[j], nmax[j], ph[j]):
                if e >= 0:
                    out.append((int(n0s[j] + e), int(nm), float(p_)))
        return out

    def _ready_chunks(self) -> int:
        """Chunks whose full metric window is buffered."""
        fit = (self._nraw - self.c - 2 * self.L) // self.c
        return max(0, int(fit) + 1 - self._n_chunks)

    def _events_from(self, raw_events) -> None:
        self._events.extend(self.sync.assemble_events(raw_events))

    def _an_end(self) -> int:
        """Absolute end of analytic coverage (canonical + final tail)."""
        return (self._a0 + len(self._an)
                + (len(self._tail) if self._tail is not None else 0))

    # -- staged completion -------------------------------------------------

    def _finalize_events(self) -> None:
        """Fine stage + gates for every event whose window is buffered
        (sync.scan's candidate assembly, decode.cc:110-146)."""
        ready = [e for e in self._events
                 if e[0] + 2 * self.L <= self._an_end()] \
            if not self._finished else list(self._events)
        if not ready:
            return
        self._events = [e for e in self._events if e not in ready]
        wins = np.stack([self._an_slice(p + self.L, self.L)
                         for p, _ in ready])
        # auto-mode semantics: not-ok candidates drop
        self._cands.extend(c for c in self.sync.fine_candidates(
            wins, ready) if c.ok)

    def _decode_headers(self, emitted: list) -> None:
        s, g = self.cfg.symbol_len, self.cfg.guard_len

        def hdr_end(c):
            # every convention hypothesis's window must be buffered
            # (alts' p0 differ by up to ~g under "auto"; gating on the
            # best-ranked one alone could mark a later-positioned true
            # hypothesis "past recording end" mid-stream)
            ps = [p for _k, p, _cf, _r in c.alts] or [c.p0]
            return max(ps) + 2 * s + g

        ready = [c for c in self._cands
                 if hdr_end(c) <= self._an_end()] \
            if not self._finished else list(self._cands)
        if not ready:
            return
        self._cands = [c for c in self._cands if c not in ready]
        if self._finished:
            # reference EOS semantics (decode.cc:296-297: the decoder
            # stops at read failure): a header window extending past
            # the true stream end must NOT decode against the silence
            # pad — report it instead
            past = [c for c in ready if c.p0 + 2 * s + g > self._eos]
            ready = [c for c in ready if c.p0 + 2 * s + g <= self._eos]
            for c in past:
                emitted.append(dict(
                    pos=int(c.p0), mode=None, call_sign="", ok=False,
                    payload=b"", flips=None, snr=None,
                    status="past recording end"))
            if not ready:
                return
        lo = self._a0
        view = self._an if self._tail is None else \
            np.concatenate([self._an, self._tail])
        shifted = [dataclasses.replace(
            c, p0=c.p0 - lo,
            alts=tuple((k, p - lo, cf, r) for k, p, cf, r in c.alts))
            for c in ready]
        for c, sh, (hdr, status) in zip(
                ready, shifted,
                self.dec.decode_headers_batch(view, shifted)):
            if hdr is not None:
                # copy the committed convention hypothesis back into
                # the un-shifted candidate (accept() mutated the copy)
                c.accept((sh.conv, sh.p0 + lo, sh.cfo_rad,
                          sh.peak_ratio))
            if hdr is None:
                emitted.append(dict(
                    pos=int(c.p0), mode=None, call_sign="", ok=False,
                    payload=b"", flips=None, snr=None, status=status))
            else:
                mode, call = hdr
                self._frames.append(
                    (c, mode, B.base37_decode(call).lstrip()))

    def _decode_payloads(self, emitted: list) -> None:
        from .pipeline import cached_pipeline
        g = self.cfg.guard_len
        by_mode: dict[tuple, list] = {}
        rest = []
        for f in self._frames:
            c, mode, call = f
            # frame_samples is convention-independent; do NOT build a
            # BatchPipeline just to read it (that would construct and
            # cache an unused default-convention pipeline)
            fsamp = ModemConfig(rate=self.rate, mode=MODES[mode],
                                freq_off=0).frame_samples
            if self._finished and c.p0 + fsamp - g > self._eos:
                # frame truncated by the true stream end: its tail
                # would decode against the silence pad (see
                # _decode_headers; decode.cc:296-297)
                emitted.append(dict(
                    pos=int(c.p0), mode=mode, call_sign=call, ok=False,
                    payload=b"", flips=None, snr=None,
                    status="past recording end"))
            # + g//2: windows_at slices through p0 + fsamp - g + g//2
            # (the late-sync margin); gate on the window TAIL so the
            # stream never zero-fills samples the batch path reads
            elif self._finished or \
                    c.p0 + fsamp - g + g // 2 <= self._an_end():
                cv = self.sync.conventions[getattr(c, "conv", 0)]
                by_mode.setdefault((mode, cv), []).append(f)
            else:
                rest.append(f)
        self._frames = rest
        if not by_mode:
            return
        lo = self._a0
        view = self._an if self._tail is None else \
            np.concatenate([self._an, self._tail])
        for (mode, cv), fs in by_mode.items():
            pipe = cached_pipeline(self.rate, mode, mls_convention=cv)
            wins, _ = pipe.windows_at(view, [f[0].p0 - lo for f in fs])
            res = pipe.fetch(pipe.decode_windows(wins))
            for j, (c, _m, call) in enumerate(fs):
                ok = bool(res["ok"][j])
                emitted.append(dict(
                    pos=int(c.p0), mode=mode, call_sign=call, ok=ok,
                    payload=pipe.payload_bytes(res, j),
                    flips=int(res["flips"][j]), snr=res["snr"][j],
                    status="ok" if ok else "payload decoding error."))

    # -- memory retirement ---------------------------------------------------

    def _retire(self) -> None:
        s, g = self.cfg.symbol_len, self.cfg.guard_len
        md = self.sync.match_del
        # the oldest absolute index any pending stage may still read:
        # a future event's p0 can reach (L + g + md + 1) behind the
        # next chunk, and an accepted frame's payload window leads its
        # p0 by 2s + g (pipeline.windows_at)
        horizon = self._n_chunks * self.c - (self.L + g + md + 1)
        # the float path slices the NEXT chunk's left context from _an
        horizon = min(horizon,
                      self._n_chunks * self.c - self.ctx - self.fl)
        pend = [p for p, _ in self._events]
        pend += [c.p0 for c in self._cands]
        pend += [f[0].p0 for f in self._frames]
        low = min([horizon] + pend) - (2 * s + g) - _BLK
        cut = low - self._a0
        if cut > 0:
            self._an = self._an[cut:]
            self._a0 = low
        if self._raw is not None:
            raw_low = (self._n_chunks * self.c - self.ctx - self.fl
                       - _BLK)
            cut = raw_low - self._r0
            if cut > 0:
                self._raw = self._raw[cut:]
                self._r0 = raw_low

    # -- public API ----------------------------------------------------------

    def feed(self, samples) -> list:
        """Append stream samples; returns frames completed by them
        (dicts exactly as pipeline.decode_recording_auto emits)."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._append_raw(self._norm(samples))
        emitted: list = []
        while True:
            rem = self._ready_chunks()
            if rem <= 0:
                break
            m = min(self.MAX_CHUNKS_PER_FEED,
                    1 << (rem.bit_length() - 1))
            self._events_from(
                self._run_chunks(self._n_chunks * self.c, m))
        self._finalize_events()
        self._decode_headers(emitted)
        self._decode_payloads(emitted)
        self._retire()
        emitted.sort(key=lambda f: f["pos"])
        return emitted

    def finish(self) -> list:
        """Flush: pad the stream tail with silence so the last metric
        outputs are produced, then complete every pending stage (late
        windows read front-ended silence).  Returns the remaining
        frames."""
        if self._finished:
            return []
        self._eos = self._nraw
        n_out = self._nraw - 2 * self.L
        emitted: list = []
        while self._n_chunks * self.c < n_out:
            rem = -(-(n_out - self._n_chunks * self.c) // self.c)
            m = min(self.MAX_CHUNKS_PER_FEED,
                    1 << (rem.bit_length() - 1))
            evs = self._run_chunks(self._n_chunks * self.c, m)
            self._events_from([e for e in evs if e[0] < n_out])
        self._finished = True
        self._finalize_events()
        self._decode_headers(emitted)
        self._decode_payloads(emitted)
        emitted.sort(key=lambda f: f["pos"])
        return emitted
