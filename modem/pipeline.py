"""Fully-jitted batched decode pipeline (the throughput path).

The interactive decoder (decoder.py) orchestrates host-side for the
general case (unknown mode, retry semantics).  This module is the
serving path for SURVEY.md §2.5 / BASELINE config 5: a batch of
recordings with a known (rate, mode) decodes as ONE jitted function —
sync argmax, fine CFO, batched FFT demod, Theil-Sen, soft demap,
lengthen, SCL VM, CRC select — with no host round-trips, vmapped over
frames and shard_map-able over a device mesh (parallel.py).

Single-candidate sync: the batch path assumes one frame per recording
and takes the global timing argmax instead of the Schmitt-trigger retry
scan (the reference's acquisition loop, decode.cc:390-448, exists for
streaming; batch jobs know their framing).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import bits as B
from . import cplx, fft, ingest, ofdm, sync, track
from .fec.polar import PolarCode
from .fec.scl_vm import make_batch_decoder, make_decoder
from .numerology import MODES, ModemConfig


class BatchPipeline:
    """Jit-once batched decoder for one (rate, mode, recording length)."""

    def __init__(self, rate: int, oper_mode: int, list_size: int = 8,
                 mode_spec=None, symbol_len_override=None,
                 scl_exact: bool = True, estimator: str | None = None,
                 mls_convention: str = "galois",
                 sync_stride: int = 8):
        """The polar decoder is the batched schedule VM
        (fec/scl_vm.make_batch_decoder) on every backend.

        mls_convention: the transmit LFSR convention this pipeline's
        internal fine-sync stage matches against (the batch path knows
        its framing, so there is no auto-detect here; decode-all groups
        frames by the convention the scan detected and builds one
        pipeline per (mode, convention) — docs/WIRE_FORMAT.md).

        scl_exact (default True) selects the provably bit-by-bit-SCL-
        equivalent one-shot RATE1/SPC enumeration — the reference's
        fork-at-every-info-bit semantics (decode.cc:530) at ~5% cost
        over the Fast-SSC-List approximation (scl_exact=False), whose
        measured gap was 1 frame in 500 across the sensitivity edge
        (bench/ab_scl.py).

        sync_stride: evaluate the batch path's coarse timing metric
        every N samples (sync._metrics_parts_strided) — the fine
        stage's |pos_err| <= guard/2 correction absorbs the <=N-sample
        coarse quantization, and the window sums shrink Nx.  Applied
        only when the numerology divides cleanly
        (Synchronizer.stride_ok); 1 = exact full-rate metric.  The
        scan/stream paths always use the exact metric."""
        if mls_convention == "auto":
            # _demod_one pins kernel index 0; silently accepting
            # "auto" would decode a foreign convention as noise
            raise ValueError(
                "BatchPipeline needs a committed mls_convention (the "
                "batch path knows its framing); use "
                "decode_recording_auto / Decoder for auto-detect")
        mode = mode_spec if mode_spec is not None else MODES[oper_mode]
        self.cfg = ModemConfig(rate=rate, mode=mode, freq_off=0,
                               symbol_len_override=symbol_len_override,
                               mls_convention=mls_convention)
        cfg = self.cfg
        self.code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                              order=mode.code_order)
        self.sync = sync.Synchronizer(cfg)
        self.scl_exact = scl_exact
        # Theil-Sen variant, captured at construction (trace time)
        self.estimator = estimator
        self.scl = make_decoder(self.code.frozen, list_size,
                                exact=scl_exact)
        self.crc_mat = np.asarray(
            B.crc32.check_matrix(mode.crc_bits), dtype=np.float32)
        self.list_size = list_size
        self.sync_stride = (sync_stride
                            if self.sync.stride_ok(sync_stride) else 1)
        self._decode_batch = jax.jit(jax.vmap(self._decode_one))
        self._batched_cache: dict[int, object] = {}

    def _batched_fn(self, batch: int):
        """Whole-batch decode with the batched SCL backend (fast path)."""
        if batch in self._batched_cache:
            return self._batched_cache[batch]
        fn = jax.jit(self.batched_run_fn(batch))
        self._batched_cache[batch] = fn
        return fn

    def _make_scl(self, batch: int):
        """Batched SCL decoder at this batch size (fast path)."""
        return make_batch_decoder(self.code.frozen, batch,
                                  self.list_size,
                                  exact=self.scl_exact)

    def _fec_select(self, front, scl):
        """SCL + CRC32 lane select on a demodulated batch
        (decode.cc:530-555, batched)."""
        mode = self.cfg.mode
        codewords, pm = scl(front["llrs"])         # [B, L, code_len]
        info = codewords[
            ..., jnp.asarray(self.code.info_idx[: mode.crc_bits])]
        # HIGHEST: a GPU runs a default-precision f32 dot in TF32; the
        # 0/1 operands would survive that, but the wire format's CRC
        # gate should not rest on the argument
        rem = jnp.mod(jnp.dot(info.astype(jnp.float32),
                              jnp.asarray(self.crc_mat),
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST),
                      2.0)
        crc_ok = jnp.sum(rem, axis=-1) == 0        # [B, L]
        pm_sel = jnp.where(crc_ok, pm, jnp.inf)
        best = jnp.argmin(pm_sel, axis=-1)         # [B]
        bits = jnp.take_along_axis(
            info, best[:, None, None], axis=1)[:, 0, : mode.data_bits]
        received = front["llrs"][
            :, jnp.asarray(self.code.info_idx[: mode.data_bits])] < 0
        flips = jnp.sum(received != bits.astype(bool), axis=-1)
        return dict(ok=jnp.any(crc_ok, axis=-1),
                    bits=bits.astype(jnp.uint8), p0=front["p0"],
                    cfo_rad=front["cfo_rad"], snr=front["snr"],
                    flips=flips, sync_gate=front["sync_gate"],
                    multiframe=front["multiframe"])

    def batched_run_fn(self, batch: int):
        """Unjitted whole-batch decode fn (for shard_map composition)."""
        scl = self._make_scl(batch)

        def run(recs):
            front = jax.vmap(self._demod_one)(recs)
            return self._fec_select(front, scl)

        return run

    # -- single recording, fully traced ------------------------------------
    def _sync_argmax(self, x):
        """Single-candidate sync: global timing argmax (no Schmitt scan).

        Also guards the single-frame-per-recording contract this path
        trades the reference's Schmitt-retry acquisition loop for
        (decode.cc:390-448): any timing sample above the Schmitt upper
        threshold OUTSIDE the committed frame's whole sample span
        marks a second frame; the flag surfaces as ``multiframe`` in
        the result dict so a multi-frame recording fails loudly
        instead of silently decoding whichever frame wins the argmax.
        The exclusion is the frame span (not just the preamble
        neighborhood) because the metric has in-frame secondary
        bumps above thr_hi; a second frame's own preamble peak always
        lies >= frame_samples after the first, outside the span.

        With sync_stride > 1 the metric is evaluated on a stride grid
        (sync._metrics_parts_strided): the argmax lands within one
        stride of the full-rate peak and the fine stage's pos_err
        correction (|pos_err| <= guard/2, decode.cc:143-146) recovers
        the rest; the phase readout index stays exact because
        match_del is a stride multiple (Synchronizer.stride_ok)."""
        s = self.sync
        S = self.sync_stride
        if S > 1:
            timing, p_re, p_im = s._metrics_parts_strided(x, S)
        else:
            timing, p_re, p_im = s._metrics_parts(x)
        m_max = jnp.argmax(timing)
        n_max = m_max * S + (S - 1) if S > 1 else m_max
        p0 = n_max - s.match_del
        # phase only at the committed index: a full-length arctan2 is
        # ~45M transcendentals per 512-batch the argmax never reads
        i = jnp.maximum(m_max - s.match_del // S, 0)
        fc = jnp.arctan2(p_im[i], p_re[i]) / s.L
        idx = jnp.arange(timing.shape[0]) * S + (S - 1) if S > 1 \
            else jnp.arange(timing.shape[0])
        sg = self.cfg.symbol_len + self.cfg.guard_len
        inside = ((idx >= n_max - 2 * sg)
                  & (idx <= n_max + self.cfg.frame_samples))
        extra = jnp.max(jnp.where(inside, -jnp.inf, timing))
        return p0, fc, extra > s.thr_hi

    def _demod_one(self, x):
        """x: [T, 2] analytic recording -> channel LLRs + metrics."""
        cfg = self.cfg
        mode = cfg.mode
        s, g = cfg.symbol_len, cfg.guard_len
        rows = mode.cons_rows
        code_off = -mode.cons_cols // 2
        bins = ofdm.bin_index(
            np.arange(code_off, code_off + mode.cons_cols), s)

        p0, fc, multiframe = self._sync_argmax(x)
        window = jax.lax.dynamic_slice(x, (p0 + self.sync.L, 0),
                                       (self.sync.L, 2))
        # the batch path's config pins ONE convention (K = 1)
        shift, pos_err, peak, nxt, _ = (
            v[0] for v in self.sync._fine_stage(window, fc))
        p0 = p0 - pos_err
        cfo = shift.astype(jnp.float32) * (2.0 * np.pi / self.sync.L) - fc
        cfo = jnp.where(cfo >= np.pi, cfo - 2.0 * np.pi, cfo)

        # payload windows: pilot + rows (decode.cc:456-470).  One
        # dynamic_slice + static reshape, not a traced-index gather of
        # [rows+1, S] computed indices: the contiguous slice is
        # bit-identical and needs no index arithmetic.  The slice
        # length is exactly rows*(s+g) + s — ending at the last used
        # sample, so a window that ends flush with the recording needs
        # no padding (no jnp.pad of the whole recording under vmap);
        # the final row concatenates from the slice tail.
        q0 = p0 + 2 * (s + g)
        flat = jax.lax.dynamic_slice(
            x, (q0, 0), (rows * (s + g) + s, 2))
        head = flat[: rows * (s + g)].reshape(rows, s + g, 2)[:, :s]
        windows = jnp.concatenate(
            [head, flat[None, rows * (s + g):]], axis=0)
        w = jnp.arange(rows + 1, dtype=jnp.float32)[:, None]
        k = jnp.arange(s, dtype=jnp.float32)[None, :]
        phase = -cfo * (s + w * (s + g) + k)
        spec = fft.fwd(cplx.cmul(windows, cplx.expi(phase)))
        carriers = spec[:, jnp.asarray(bins)]
        cons = ofdm.demod_or_erase(carriers[1:], carriers[:-1])
        cons, slope, yint = track.derotate_rows(
            cons, code_off, mode.mod_bits, self.estimator)
        llrs, snr = track.soft_llrs(cons, mode.mod_bits)
        full = self.code.lengthen(llrs.reshape(-1))
        return dict(llrs=full, p0=p0, cfo_rad=cfo, snr=snr,
                    sync_gate=(peak > 4.0 * nxt), multiframe=multiframe)

    def _decode_one(self, x):
        """x: [T, 2] analytic recording -> dict of results."""
        mode = self.cfg.mode
        front = self._demod_one(x)
        full = front["llrs"]
        p0, cfo, snr = front["p0"], front["cfo_rad"], front["snr"]

        codewords, pm = self.scl(full)                # [L, code_len]
        info = codewords[:, jnp.asarray(self.code.info_idx[: mode.crc_bits])]
        # CRC32 over each path via GF(2) matmul (decode.cc:533-541)
        rem = jnp.mod(jnp.dot(info.astype(jnp.float32),
                              jnp.asarray(self.crc_mat),
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST), 2.0)
        crc_ok = jnp.sum(rem, axis=-1) == 0
        # best = lowest-metric path passing CRC
        pm_sel = jnp.where(crc_ok, pm, jnp.inf)
        best = jnp.argmin(pm_sel)
        payload_bits = info[best, : mode.data_bits]
        received = full[jnp.asarray(
            self.code.info_idx[: mode.data_bits])] < 0
        flips = jnp.sum(received != payload_bits.astype(bool))
        return dict(ok=jnp.any(crc_ok), bits=payload_bits.astype(jnp.uint8),
                    p0=p0, cfo_rad=cfo, snr=snr, flips=flips,
                    sync_gate=front["sync_gate"],
                    multiframe=front["multiframe"])

    # -- staged fast path: two jits (front-end, SCL+select) -----------------
    # One whole-batch jit is the lowest-dispatch-overhead design, but its
    # XLA graph is large and any change to either half recompiles both.
    # The staged variant splits at the natural seam — channel LLRs — so the demod
    # front-end and the SCL/CRC back-end compile (and cache) separately
    # at the cost of one extra dispatch per batch.
    def _staged_fns(self, batch: int):
        key = ("staged", batch)
        if key in self._batched_cache:
            return self._batched_cache[key]
        scl = self._make_scl(batch)
        front_fn = jax.jit(lambda recs: jax.vmap(self._demod_one)(recs))
        back_fn = jax.jit(lambda front: self._fec_select(front, scl))
        fns = (front_fn, back_fn)
        self._batched_cache[key] = fns
        return fns

    # -- public ------------------------------------------------------------
    def decode_batch(self, recordings, flat_lane: bool = True,
                     staged: bool = False):
        """recordings: [B, T] complex np or [B, T, 2] -> result dict.

        flat_lane=True uses the [SZ, batch*list] SCL layout (fast path);
        False falls back to the vmapped single-frame decoder.  staged=True
        splits the batch decode into two jits (front-end / FEC) that
        compile separately.
        """
        if np.iscomplexobj(recordings):
            recordings = cplx.from_np(recordings)
        recordings = jnp.asarray(recordings)
        if staged:
            front_fn, back_fn = self._staged_fns(recordings.shape[0])
            return back_fn(front_fn(recordings))
        if flat_lane:
            return self._batched_fn(recordings.shape[0])(recordings)
        return self._decode_batch(recordings)

    def frame_windows(self, x, max_frames: int = 64):
        """Scan a recording and slice one window per detected frame.

        ``x`` may be an ingest.PcmRecording: the scan chunks and the
        frame windows then go to the device in wire dtype and the
        dequantise (+ mono DC-block/Hilbert) front-end runs on device
        (sync.scan / sync._pcm_windows), never materialising the f32
        analytic recording on the host.

        Each window spans [p0 - (2s+g), p0 + frame_samples - g) —
        through its last payload sample and stopping before the NEXT
        frame's preamble, so the batch path's global timing argmax sees
        exactly one preamble.  The lead holds the in-frame pilot
        symbol before the S&C: the timing metric's peak needs
        L + match_len samples of window-sum history, and a lead of
        only s+g leaves L + g — one sample SHORT (g = 160 < match_len
        = 161 at 8 kHz; the wire loopbacks passed inside that hair,
        the toy config did not).  Returns (windows [n, w, 2],
        positions)."""
        if not isinstance(x, ingest.PcmRecording):
            if np.iscomplexobj(x):
                x = cplx.from_np(x)
            x = np.asarray(x, dtype=np.float32)
        cands = [c for c in self.sync.scan(x, max_candidates=max_frames)
                 if c.ok]
        return self.windows_at(x, [c.p0 for c in cands])

    def windows_at(self, x, positions):
        """Slice one frame window per preamble position (see
        frame_windows for the geometry).  PcmRecording input returns
        device-resident analytic windows (raw slices go to the device
        in wire dtype; front-end on device)."""
        cfg = self.cfg
        s, g = cfg.symbol_len, cfg.guard_len
        # + g//2: the payload dynamic_slice (_demod_one) ends at
        # p0 + frame_samples + 2s - (2s + g) + ... = window end + e
        # when sync resolves p0 e samples late (|pos_err| <= g/2,
        # decode.cc:143-145); without the margin the slice start would
        # clamp and shift every row by e
        w = cfg.frame_samples + 2 * s + g // 2
        pos = np.asarray([int(p) for p in positions], dtype=np.int64)
        if isinstance(x, ingest.PcmRecording):
            if not len(pos):
                return np.zeros((0, w, 2), np.float32), pos
            wins = self.sync._pcm_windows(
                x, [int(p) - (2 * s + g) for p in positions], w)
            return wins, pos
        if np.iscomplexobj(x):
            x = cplx.from_np(x)
        x = np.asarray(x, dtype=np.float32)
        wins = np.zeros((len(positions), w, 2), dtype=np.float32)
        for i, p0 in enumerate(positions):
            lo = int(p0) - (2 * s + g)
            seg = x[max(lo, 0): max(lo + w, 0)]
            off = max(0, -lo)       # recording-start left pad
            wins[i, off: off + len(seg)] = seg
        return wins, pos

    def decode_windows(self, wins):
        """Batch-decode pre-sliced frame windows, padding the batch up
        to the next multiple of 8 (next power of two below 8) so
        recordings with similar frame counts share compiled shapes."""
        n = len(wins)
        target = -(-n // 8) * 8 if n > 8 else \
            1 << max(0, (n - 1).bit_length())
        pad = target - n
        if pad:
            cat = np.concatenate if isinstance(wins, np.ndarray) \
                else jnp.concatenate
            z = (np.zeros if isinstance(wins, np.ndarray)
                 else jnp.zeros)((pad,) + wins.shape[1:],
                                 dtype=np.float32)
            wins = cat([wins, z])
        res = self.decode_batch(wins)
        if pad:
            res = {k: v[:n] for k, v in res.items()}
        return res

    def decode_recording(self, x, max_frames: int = 64):
        """Find and decode every frame in one long recording.

        The streaming analog of the reference's acquisition loop
        (decode.cc:390-448) on the serving path: the Schmitt-trigger
        scan locates preambles, then all frames decode as ONE batched
        call.  Window geometry (lead 2s+g through the last payload
        sample, stopping before the next frame's preamble): see
        frame_windows.

        Returns (result dict from decode_batch, positions [n_frames]).
        """
        wins, pos = self.frame_windows(x, max_frames)
        if not len(wins):
            return None, pos
        return self.decode_windows(wins), pos

    def payload_bytes(self, result, i: int) -> bytes:
        bits = np.asarray(result["bits"][i])
        return B.scramble(B.bits_to_bytes_le(bits))

    def pack(self, res):
        """Dispatch the single-block result packing on device; returns
        (packed device array, snr_cols, n_bits) for unpack().

        Dispatching the pack EAGERLY — right after the decode that
        produced ``res``, before any further batch is queued — matters
        on a serial device queue: a pack dispatched later (e.g. inside
        a fetch that runs after the NEXT batch was queued) executes
        behind that batch's whole compute, so the host transfer of
        THIS batch's results serializes with the next batch instead of
        riding under it."""
        return (_pack_results(
            res["ok"], res["flips"], res["p0"], res["sync_gate"],
            res["cfo_rad"], res["snr"], res["bits"]),
            res["snr"].shape[1], res["bits"].shape[1])

    @staticmethod
    def unpack(handle) -> dict:
        """Fetch a pack() handle to host (ONE device-to-host copy) and
        unpack the int32 block into the result dict."""
        packed, snr_cols, nb = handle
        packed = np.asarray(packed)
        off = 5 + snr_cols
        words = np.ascontiguousarray(packed[:, off:])
        bits = np.unpackbits(words.view(np.uint8), axis=1,
                             bitorder="little")[:, :nb]
        return dict(
            ok=packed[:, 0].astype(bool),
            flips=packed[:, 1].copy(),
            p0=packed[:, 2].copy(),
            sync_gate=packed[:, 3].astype(bool),
            cfo_rad=np.ascontiguousarray(packed[:, 4]).view(np.float32),
            snr=np.ascontiguousarray(
                packed[:, 5: off]).view(np.float32),
            bits=bits)

    def fetch(self, res) -> dict:
        """Fetch a decode_batch/decode_windows result dict to host
        numpy in ONE device-to-host copy instead of one per array: the
        per-frame scalars (ok, flips, p0, sync_gate, cfo_rad), the
        per-row snr AND the payload bits all pack into one int32 block
        on device (floats bitcast, bits as 32-per-word little-endian)
        and unpack on the host.  Every device read pays a fixed
        synchronisation and transfer latency whatever its size, so one
        block beats seven.  Pipelined loops
        should pack() at dispatch time and unpack() at retirement —
        see pack()."""
        return self.unpack(self.pack(res))


@jax.jit
def _pack_results(ok, flips, p0, sync_gate, cfo, snr, bits):
    b = bits.shape[0]
    nb = bits.shape[1]
    nw = -(-nb // 32)
    bitsp = jnp.pad(bits.astype(jnp.uint32),
                    ((0, 0), (0, nw * 32 - nb)))
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    words = jnp.sum(bitsp.reshape(b, nw, 32) << shifts, axis=-1,
                    dtype=jnp.uint32)
    cols = [ok.astype(jnp.int32)[:, None],
            flips.astype(jnp.int32)[:, None],
            p0.astype(jnp.int32)[:, None],
            sync_gate.astype(jnp.int32)[:, None],
            jax.lax.bitcast_convert_type(
                cfo.astype(jnp.float32), jnp.int32)[:, None],
            jax.lax.bitcast_convert_type(
                snr.astype(jnp.float32), jnp.int32),
            jax.lax.bitcast_convert_type(words, jnp.int32)]
    return jnp.concatenate(cols, axis=1)


class AdaptivePipeline:
    """CRC-gated adaptive decode: SC first, exact SCL only on failure.

    Adaptive SCL (Li/Niu/Chen 2012-style CRC-aided list escalation):
    every frame decodes with plain successive cancellation — the
    list_size=1 VM, whose lanes hold one path per frame instead of
    eight — and only frames whose CRC-32 fails re-decode through the
    exact list decoder.  At serving SNR virtually every frame passes
    SC, so the list decoder's cost shrinks to the SC cost.

    Output semantics match the reference path (decode.cc:530-555): a
    CRC-passing SC codeword is the transmitted codeword up to the same
    ~2^-32 false-accept exposure the reference's CRC path selection
    already has, and a CRC-failing frame returns the exact-SCL result
    verbatim — the sensitivity cliff is exactly BatchPipeline's
    (tests/test_adaptive.py pins both directions).  The one observable
    difference is favorable: a frame whose greedy SC path passes CRC
    but was pruned from the list-8 set decodes here and not there.

    Unlike BatchPipeline.decode_batch (device dict), decode_batch here
    returns a HOST numpy dict — the CRC gate is a host decision.  The
    async pair (decode_batch_async / resolve) lets a serving loop
    overlap the next batch's compute with this one's gate+fetch.
    """

    def __init__(self, rate: int, oper_mode: int, list_size: int = 8,
                 fallback_batch: int = 16, **kw):
        self.sc = BatchPipeline(rate, oper_mode, list_size=1, **kw)
        self.scl = BatchPipeline(rate, oper_mode,
                                 list_size=list_size, **kw)
        self.cfg = self.sc.cfg
        self.code = self.sc.code
        self.fallback_batch = fallback_batch
        self._fb = None
        self.last_fallbacks = 0     # frames escalated by the last call

    def _fallback_fn(self):
        """Jitted gather + exact-SCL back-end at the fixed fallback
        batch (compiled lazily: a clean serving stream never pays
        for it)."""
        if self._fb is None:
            scl = self.scl._make_scl(self.fallback_batch)
            def run(front, idx):
                sub = {k: jnp.take(v, idx, axis=0)
                       for k, v in front.items()}
                return self.scl._fec_select(sub, scl)
            self._fb = jax.jit(run)
        return self._fb

    def decode_batch_async(self, recordings):
        """Dispatch the SC stage; returns an opaque handle for
        resolve().  No host round trip happens here.

        The result PACK is dispatched here too (not in resolve): on
        the serial device queue a pack queued at resolve time would
        execute behind whatever batch the serving loop dispatched in
        between, serializing this batch's result transfer with the
        next batch's compute instead of overlapping it
        (BatchPipeline.pack)."""
        if np.iscomplexobj(recordings):
            recordings = cplx.from_np(recordings)
        recordings = jnp.asarray(recordings)
        front_fn, back_fn = self.sc._staged_fns(recordings.shape[0])
        front = front_fn(recordings)
        return front, self.sc.pack(back_fn(front))

    def resolve(self, handle) -> dict:
        """Fetch the SC results (one device-to-host copy), gate on CRC,
        and re-decode any failing frames with the exact list decoder;
        returns the merged host dict (BatchPipeline.fetch keys)."""
        front, res1 = handle
        host = self.sc.unpack(res1)
        fails = np.flatnonzero(~host["ok"])
        self.last_fallbacks = int(fails.size)
        if not fails.size:
            return host
        fb = self._fallback_fn()
        bf = self.fallback_batch
        for g0 in range(0, fails.size, bf):
            group = fails[g0: g0 + bf]
            idx = np.full(bf, int(group[0]), dtype=np.int32)
            idx[: group.size] = group
            h2 = self.scl.fetch(fb(front, jnp.asarray(idx)))
            for k in host:
                host[k][group] = h2[k][: group.size]
        return host

    def decode_batch(self, recordings) -> dict:
        return self.resolve(self.decode_batch_async(recordings))

    # the host dict is already fetched; identity keeps the
    # BatchPipeline serving-loop call shape working unchanged
    def fetch(self, res: dict) -> dict:
        return res

    def decode_windows(self, wins) -> dict:
        """Batch-decode pre-sliced frame windows: BatchPipeline's
        padding logic verbatim (it only touches self.decode_batch,
        which here resolves adaptively)."""
        return BatchPipeline.decode_windows(self, wins)

    def decode_recording(self, x, max_frames: int = 64):
        """Find and decode every frame in one long recording (the
        adaptive analog of BatchPipeline.decode_recording)."""
        wins, pos = self.sc.frame_windows(x, max_frames)
        if not len(wins):
            return None, pos
        return self.decode_windows(wins), pos

    def payload_bytes(self, result, i: int) -> bytes:
        return self.sc.payload_bytes(result, i)

    # window slicing lives on the SC sub-pipeline (same config)
    def windows_at(self, x, positions):
        return self.sc.windows_at(x, positions)

    def frame_windows(self, x, max_frames: int = 64):
        return self.sc.frame_windows(x, max_frames)


@functools.lru_cache(maxsize=None)
def cached_pipeline(rate: int, oper_mode: int, list_size: int = 8,
                    mls_convention: str = "galois") -> BatchPipeline:
    return BatchPipeline(rate, oper_mode, list_size,
                         mls_convention=mls_convention)


@functools.lru_cache(maxsize=None)
def cached_adaptive_pipeline(rate: int, oper_mode: int,
                             list_size: int = 8,
                             mls_convention: str = "galois"
                             ) -> AdaptivePipeline:
    return AdaptivePipeline(rate, oper_mode, list_size,
                            mls_convention=mls_convention)


def decode_recording_auto(x, rate: int, channels: int = 2,
                          max_frames: int = 64,
                          mls_convention: str = "galois",
                          adaptive: bool = False):
    """Reference-decoder semantics on the serving path: the operating
    mode and callsign auto-detect per frame from the BCH(255,71)+OSD
    header (decode.cc:398-446), frames group by mode (and, under
    mls_convention="auto", by detected LFSR convention), and each
    group batch-decodes in ONE jitted call.

    x: complex [T], [T, 2] split-complex, real mono when
    channels == 1, or an ingest.PcmRecording (wire-dtype transfer +
    on-device front-end; the fastest ingest for WAV input).  Returns a
    time-ordered list of per-frame dicts:
    {pos, mode, call_sign, ok, payload, flips, snr}.

    adaptive=True routes each mode group through AdaptivePipeline
    (SC first, exact SCL only on CRC failure — identical results on
    anything either decoder decodes) instead
    of the pure exact-SCL BatchPipeline.
    """
    from .decoder import cached_decoder
    dec = cached_decoder(rate, mls_convention=mls_convention)
    if isinstance(x, ingest.PcmRecording):
        pass                      # scan/header/window stages take PCM
    elif channels == 1 and not np.iscomplexobj(x):
        import jax.numpy as _jnp
        x = np.asarray(dec._frontend_jit(
            _jnp.asarray(np.asarray(x, dtype=np.float32))))
        x = np.asarray(x, dtype=np.float32)
    else:
        if np.iscomplexobj(x):
            x = cplx.from_np(x)
        x = np.asarray(x, dtype=np.float32)

    # Header stage: ONE jitted demod+OSD batch over every detected
    # preamble (decode.cc:398-446; not a per-frame host loop) — the payload stage below batches per mode group.
    cands = [c for c in dec.sync.scan(x, max_candidates=max_frames)
             if c.ok]
    frames = []          # (pos, mode, call, mls convention)
    rejects = []         # preambles whose header failed, with WHY
    for c, (hdr, status) in zip(cands,
                                dec.decode_headers_batch(x, cands)):
        if hdr is None:
            rejects.append(dict(
                pos=int(c.p0), mode=None, call_sign="", ok=False,
                payload=b"", flips=None, snr=None, status=status))
            continue
        oper_mode, call = hdr
        frames.append((c.p0, oper_mode, B.base37_decode(call).lstrip(),
                       dec.sync.conventions[c.conv]))

    out = []
    by_mode: dict[tuple, list[int]] = {}
    for idx, (_p, m, _c, cv) in enumerate(frames):
        by_mode.setdefault((m, cv), []).append(idx)
    results = [None] * len(frames)
    for (m, cv), idxs in by_mode.items():
        factory = (cached_adaptive_pipeline if adaptive
                   else cached_pipeline)
        pipe = factory(rate, m, mls_convention=cv)
        wins, _ = pipe.windows_at(x, [frames[i][0] for i in idxs])
        # one packed device-to-host copy per group, not one device
        # read per frame and key
        res = pipe.fetch(pipe.decode_windows(wins))
        for j, i in enumerate(idxs):
            results[i] = (pipe, res, j)
    for i, (p0, m, call, _cv) in enumerate(frames):
        pipe, res, j = results[i]
        ok = bool(np.asarray(res["ok"])[j])
        out.append(dict(
            pos=int(p0), mode=m, call_sign=call, ok=ok,
            payload=pipe.payload_bytes(res, j),
            flips=int(np.asarray(res["flips"])[j]),
            snr=np.asarray(res["snr"][j]),
            status="ok" if ok else "payload decoding error."))
    out.extend(rejects)
    out.sort(key=lambda f: f["pos"])
    return out
