"""Vectorized Schmidl-Cox synchronization over whole recordings.

Array-program re-design of the reference's per-sample streaming correlator
(SchmidlCox, decode.cc:37-153).  The reference pushes one sample at a
time through sliding-window sums (SMA), a Schmitt trigger and an argmax
tracker; here the whole recording is processed as arrays:

  * the three sliding windows (correlation P over L, power R over 2L,
    timing match over guard_len|1) become cumulative-sum differences
    computed in float64 (SURVEY.md §7 hard part 5: the reference's
    recursive SMA has no drift; a plain f32 cumsum would),
  * the Schmitt trigger + falling-edge detection become an associative
    boolean scan,
  * the per-event fine stage (fractional-CFO mixdown, L-point FFT,
    adjacent-bin differential, circular correlation against the MLS0
    kernel) is a batched jitted function over all candidate peaks.

All data is split-complex [..., 2] (no complex dtypes on device) and
all positions are in recording coordinates: ``p0`` points at the first
sample of the Schmidl-Cox symbol's payload (after its guard), matching
the reference's ``symbol_pos`` once the sliding-buffer offsets collapse
(decode.cc:84-152, SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import bits as B
from . import cplx, fft, ingest, ofdm
from .numerology import ModemConfig


_BLK = 512


def window_sum(x, w: int):
    """y[n] = sum(x[n-w+1 .. n]), same length as x.

    Two-level block decomposition with NO long carries: within-block
    inclusive prefix sums via one lower-triangular [512, 512] matmul,
    plus at most ceil(w/512)+1 shift-adds of the block totals.
    Each output is a sum of O(w/512) partials, so the rounding error is
    O(eps * w * |local values|) regardless of recording length — the
    same guarantee as the reference's drift-free recursive SMA
    (decode.cc:45-47) and as lax.reduce_window, which this replaces
    with identical numerics and a compile time that does not grow
    with the window size.

    A cumulative-sum difference would be simpler but its cancellation
    error grows with the running total over minutes-long recordings
    (JAX is f32 here — jnp.float64 silently demotes).
    """
    t = x.shape[-1]
    nb = -(-t // _BLK)
    q, r = divmod(w, _BLK)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, nb * _BLK - t)])
    blocks = xp.reshape(*x.shape[:-1], nb, _BLK)
    tri = jnp.asarray(np.tril(np.ones((_BLK, _BLK), np.float32)))
    # HIGHEST: a GPU would otherwise run this f32 matmul in TF32
    # (about three decimal digits), and the window sums must stay
    # drift-free to f32 accuracy
    pref = jnp.matmul(blocks, tri.T,
                      precision=jax.lax.Precision.HIGHEST)
    totals = pref[..., -1]                       # [.., nb]

    def shift_right(a, k, axis=-1):
        k = min(k, a.shape[axis])       # all-zero when shifted out
        if k == 0:
            return a
        pad = [(0, 0)] * a.ndim
        pad[axis] = (k, 0)
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, a.shape[axis] - k)
        return jnp.pad(a[tuple(sl)], pad)

    # sum of the q (resp. q+1) block totals preceding each block
    s_q = jnp.zeros_like(totals)
    for k in range(1, q + 1):
        s_q = s_q + shift_right(totals, k)
    s_q1 = s_q + shift_right(totals, q + 1)

    pref_flat = pref.reshape(*x.shape[:-1], nb * _BLK)
    c_shift = shift_right(pref_flat, w)          # pref_flat[n - w]
    j = np.arange(nb * _BLK) % _BLK
    use_q1 = jnp.asarray(j < r) if r else jnp.zeros(nb * _BLK, bool)
    base = jnp.where(use_q1, jnp.repeat(s_q1, _BLK, axis=-1),
                     jnp.repeat(s_q, _BLK, axis=-1))
    y = pref_flat - c_shift + base
    return y[..., :t]


def schmitt_falling(timing, lo: float, hi: float, carry=None):
    """Hysteresis trigger state + falling edges, vectorised.

    s[n] = (t[n] > hi) | (t[n] >= lo & s[n-1]) — an associative boolean
    recurrence composed with lax.associative_scan (decode.cc:49-50,
    93-94).  ``carry`` (scalar bool) seeds s[-1] so a long recording
    can be scanned in chunks with the state threaded through (the
    second scan element is the running AND of the lower-threshold
    predicate, i.e. exactly the carry's survival mask).
    Returns (collect_state, falling_edge).
    """
    a = timing > hi
    b = timing >= lo

    def compose(left, right):
        a1, b1 = left
        a2, b2 = right
        return a2 | (b2 & a1), b2 & b1

    s, ball = jax.lax.associative_scan(compose, (a, b), axis=-1)
    if carry is None:
        first = jnp.zeros_like(s[..., :1])
    else:
        s = s | (ball & carry)
        first = jnp.broadcast_to(carry, s[..., :1].shape)
    prev = jnp.concatenate([first, s[..., :-1]], axis=-1)
    return s, prev & ~s


def segmented_argmax(v, idx, payload, seg_start):
    """Running argmax that resets at segment starts, vectorised.

    At each position n the result is (max value, its index, its
    payload) over the maximal run of positions ending at n with no
    segment start strictly after the run's first element.  Ties keep
    the EARLIEST index (np.argmax semantics).  Standard segmented-scan
    operator: op((a, g1), (b, g2)) = (g2 ? b : max(a, b), g1 | g2).

    Returns (max value, index, payload, any-segment-start-in-prefix);
    the fourth output lets a chunked caller compose results across
    chunk boundaries with the same operator (_extract_batch_fn).
    """
    return jax.lax.associative_scan(
        _seg_argmax_op, (v, idx, payload, seg_start))


def _seg_argmax_op(left, right):
    v1, i1, p1, g1 = left
    v2, i2, p2, g2 = right
    take_r = g2 | (v2 > v1)        # strict > keeps the EARLIEST max
    return (jnp.where(take_r, v2, v1),
            jnp.where(take_r, i2, i1),
            jnp.where(take_r, p2, p1),
            g1 | g2)


@dataclasses.dataclass
class SyncCandidate:
    p0: int           # recording index of the S&C symbol payload start
    frac_cfo: float   # fractional CFO estimate, rad/sample
    cfo_rad: float    # full CFO estimate (integer + fractional)
    ok: bool          # passed uniqueness + timing-error gates
    peak_ratio: float
    conv: int = 0     # index into Synchronizer.conventions of the
    #                   hypothesis the scalar fields above reflect
    # Gate-passing convention hypotheses, peak-ratio-descending:
    # (conv, p0, cfo_rad, peak_ratio) tuples.  Length 1 for a single-
    # convention receiver; under "auto" the header stage walks these
    # and commits the first whose OSD+CRC16 validates (the conventions
    # emit phases of ONE m-sequence, so sync cannot separate them —
    # see _fine_stage).  accept() commits a hypothesis.
    alts: tuple = ()

    def accept(self, alt) -> None:
        """Commit a header-validated hypothesis into the scalar view."""
        self.conv, self.p0, self.cfo_rad, self.peak_ratio = alt
        self.alts = (alt,)


class Synchronizer:
    """Per-config Schmidl-Cox detector (operates at L = symbol_len/2)."""

    def __init__(self, cfg: ModemConfig):
        self.cfg = cfg
        n = cfg.symbol_len
        self.L = L = n // 2
        self.match_len = cfg.guard_len | 1
        self.match_del = (self.match_len - 1) // 2
        self.thr_lo = 0.17 * self.match_len   # decode.cc:76
        self.thr_hi = 0.19 * self.match_len

        # Matched kernel from the decoder-side MLS0 layout over L bins
        # (decode.cc:236-244, 76-83): kern = conj(FFT(seq)) / L.  The
        # receiver layout is offset-free (mls0_off = -mls0_len + 1,
        # decode.cc:183): the integer-CFO search absorbs the transmit
        # frequency offset.  With mls_convention="auto" one kernel per
        # LFSR convention is built and the fine stage picks whichever
        # correlates best — the receiver then accepts any transmit
        # convention (docs/WIRE_FORMAT.md; the wrong kernel has no
        # dominant peak, so the peak>4*next gate would otherwise
        # reject the preamble outright).
        if cfg.mls_convention == "auto":
            self.conventions = B.MLS_CONVENTIONS
        else:
            self.conventions = (cfg.mls_convention,)
        rx_off = -(cfg.mls0_len - 1)
        bins = (np.arange(cfg.mls0_len) + rx_off // 2 + L) % L
        kerns = []
        for conv in self.conventions:
            seq = np.zeros(L, dtype=np.complex64)
            seq[bins] = B.mls_nrz(cfg.mls0_poly, cfg.mls0_len,
                                  convention=conv)
            kerns.append(cplx.from_np(np.conj(np.fft.fft(seq)) / L))
        self.kerns = np.stack(kerns)                 # [K, L, 2]

        # mono front-end geometry for device-side PCM ingest
        # (decode.cc:294-301: dequantise + BlockDC + Hilbert)
        self.dc_window = 2 * cfg.extended_len
        self.taps = cfg.filter_len
        self.front_lead = ingest.front_lead(self.dc_window, self.taps)

        self._metrics_jit = jax.jit(self._metrics)

        def fine_packed(wins, fcs):
            # pack the fine stage's per-candidate outputs into one
            # int32 block [n, 4, K] (floats bitcast): one device-to-host
            # copy instead of four
            shift, pos_err, peak, nxt, _ = jax.vmap(
                self._fine_stage)(wins, fcs)        # each [n, K]
            bc = lambda v: jax.lax.bitcast_convert_type(
                v.astype(jnp.float32), jnp.int32)
            return jnp.stack(
                [shift.astype(jnp.int32), pos_err.astype(jnp.int32),
                 bc(peak), bc(nxt)], axis=1)

        self._fine_packed_jit = jax.jit(fine_packed)
        self._chunk_fns: dict[tuple, object] = {}
        self._extract_fns: dict[tuple, object] = {}
        self._pcm_win_fns: dict[tuple, object] = {}
        # optional jax.sharding.Mesh: shards the chunk axis of the
        # batched scan across devices (parallel.sharded_sync)
        self.mesh = None

    # -- stage 1: whole-recording timing metric ---------------------------
    def _metrics_parts(self, x, valid_from=None):
        """x: [T, 2] split-complex recording -> (timing, p_re, p_im)
        arrays indexed so that timing[n] corresponds to a S&C symbol
        whose payload starts at n - match_del (before the fine
        correction); phase[n] = arctan2(p_im, p_re)[n].

        ``valid_from`` (traced scalar): zero the correlation products
        and power terms at indices below it.  A chunk whose left
        context is zero-PADDING (the recording start) still produces
        nonzero products there — both factors sit L/2L PAST the pad,
        in real data — which the whole-recording pass never sums
        (its window_sum zero-fills before index 0); masking restores
        exact agreement."""
        L = self.L
        a = x[L:-L]                              # x[v + L]
        b = x[2 * L:]                            # x[v + 2L]
        a = a[: b.shape[0]]
        prod = cplx.cmul_conj(a, b)
        pb = cplx.abs2(b)
        if valid_from is not None:
            mask = jnp.arange(prod.shape[0]) >= valid_from
            prod = prod * mask[:, None]
            pb = pb * mask
        p_re = window_sum(prod[..., 0], L)
        p_im = window_sum(prod[..., 1], L)
        power = window_sum(pb, 2 * L)
        r = jnp.maximum(0.5 * power, 1e-4 * L)
        timing = window_sum((p_re**2 + p_im**2) / (r * r), self.match_len)
        return (timing.astype(jnp.float32), p_re.astype(jnp.float32),
                p_im.astype(jnp.float32))

    def _metrics(self, x, valid_from=None):
        """(timing, phase) over the whole recording — the scan/stream
        paths report phase at every event position.  The batch path
        reads phase at ONE index and uses :meth:`_metrics_parts` to
        skip the full-length arctan2."""
        timing, p_re, p_im = self._metrics_parts(x, valid_from)
        phase = jnp.arctan2(p_im, p_re)
        return timing, phase.astype(jnp.float32)

    def stride_ok(self, stride: int) -> bool:
        """Whether _metrics_parts_strided(stride) keeps the P/R window
        sums and the phase-readout position EXACT at this numerology
        (L, 2L and match_del all divisible by the stride)."""
        return (stride > 1 and self.L % stride == 0
                and self.match_del % stride == 0
                and self.match_len >= stride)

    def _metrics_parts_strided(self, x, stride: int):
        """Batch-path timing metric evaluated every ``stride`` samples.

        The serving argmax only needs the metric's peak to within the
        fine stage's correction range (|pos_err| <= guard/2,
        decode.cc:143-146), so evaluating the metric on a stride-S
        grid loses nothing the fine stage doesn't recover — while the
        window sums (57% of the batch demod front-end at full rate)
        shrink by S in both FLOPs and intermediate size.

        Exactness: the correlation (L) and power (2L) windows end on
        stride multiples, so p_re/p_im/power at the strided points are
        EXACTLY the full-rate values (the full-rate products are
        block-summed first; L % stride == 0 asserted via stride_ok).
        Only the reference's match filter (SMA over match_len=g|1
        consecutive ratios, decode.cc:90) is approximated: stride *
        sum of match_len//stride STRIDED ratios — valid because ratio
        is smooth on the stride scale (every constituent is a >=L-
        sample window sum).  Returned arrays index the strided grid:
        entry m corresponds to full-rate index m*stride + stride - 1.

        Scan/stream keep the exact full-rate _metrics_parts: their
        device-vs-host parity and event-position contracts pin every
        sample (tests/test_sync.py)."""
        L = self.L
        S = stride
        a = x[L:-L]
        b = x[2 * L:]
        a = a[: b.shape[0]]
        prod = cplx.cmul_conj(a, b)
        pb = cplx.abs2(b)
        t8 = prod.shape[0] // S
        rb = prod[: t8 * S].reshape(t8, S, 2).sum(axis=1)
        pbb = pb[: t8 * S].reshape(t8, S).sum(axis=1)
        p_re = window_sum(rb[:, 0], L // S)
        p_im = window_sum(rb[:, 1], L // S)
        power = window_sum(pbb, 2 * L // S)
        r = jnp.maximum(0.5 * power, 1e-4 * L)
        timing = S * window_sum((p_re**2 + p_im**2) / (r * r),
                                self.match_len // S)
        return (timing.astype(jnp.float32), p_re.astype(jnp.float32),
                p_im.astype(jnp.float32))

    # -- stage 2: fine timing / CFO at one candidate ----------------------
    def _fine_stage(self, window, frac_cfo):
        """window: [L, 2] samples at x[p0+L : p0+2L] (second half of the
        S&C symbol); returns per-convention arrays [K] of (shift,
        pos_err, peak, next, peak_phase) — decode.cc:110-146 run once
        per matched kernel (K = len(self.conventions); 1 unless the
        config is mls_convention="auto").

        The kernels CANNOT be told apart here by peak dominance alone:
        the LFSR conventions emit rotations of one m-sequence (or of
        its time reversal — tests/test_mls_convention.py pins the
        relations), and — the MLS0 length equalling its period — a
        rotation by d aliases into a circular bin rotation, i.e. a
        strong correlation peak at an integer-CFO estimate off by 2d
        bins; even the reversed sequence's kernel was measured passing
        the peak>4*next gate with ratio ~15 on a clean mono loopback.
        The caller therefore keeps every gate-passing convention as a
        ranked hypothesis and lets the header stage's OSD + CRC16
        decide (decoder._decode_header, docs/WIRE_FORMAT.md)."""
        L = self.L
        idx = jnp.arange(L, dtype=jnp.float32)
        mixed = cplx.cmul(window, cplx.expi(frac_cfo * idx))
        spec = fft.fwd(mixed)
        prev = jnp.roll(spec, 1, axis=-2)
        cons = ofdm.demod_or_erase(spec, prev)
        cons_f = fft.fwd(cons)
        corr = jax.vmap(lambda k: fft.bwd(cplx.cmul(cons_f, k)))(
            jnp.asarray(self.kerns))                 # [K, L, 2]
        pwr = cplx.abs2(corr)                        # [K, L]
        shift = jnp.argmax(pwr, axis=-1)             # [K]
        peak = jnp.take_along_axis(pwr, shift[:, None], -1)[:, 0]
        nxt = jnp.max(jnp.where(
            jnp.arange(L)[None, :] == shift[:, None], -jnp.inf, pwr),
            axis=-1)
        c = jnp.take_along_axis(
            corr, shift[:, None, None], axis=1)[:, 0]        # [K, 2]
        ang = jnp.arctan2(c[:, 1], c[:, 0])
        pos_err = jnp.round(ang * L / (2.0 * np.pi)).astype(jnp.int32)
        return shift, pos_err, peak, nxt, ang

    # -- chunked / whole-recording metric computation ----------------------
    # Above this many samples scan() switches to the constant-device-
    # memory chunked pass (the reference decodes arbitrarily long
    # streams in a fixed 8640-sample BipBuffer, decode.cc:188-194,
    # 294-301; this is SURVEY.md §5's long-signal analog).
    CHUNK_AUTO_THRESHOLD = 1 << 21
    CHUNK_DEFAULT = 1 << 20
    CHUNK_SMALL = 1 << 17       # ladder size for sub-2M recordings
    # retain the scan's on-device analytic recording for later window
    # slicing when it costs at most this much device memory (16
    # B/sample bound: 8 B/sample f32 split-complex x <= 2x pad-chunk
    # overestimate); 512 MB covers ~2 h of 8 kHz audio
    RETAIN_LIMIT_BYTES = 1 << 29

    def _chunk_fn(self, c: int, ctx: int):
        """Jitted one-chunk metrics + Schmitt pass, O(chunk) device mem."""
        key = (c, ctx)
        fn = self._chunk_fns.get(key)
        if fn is None:
            def run(xs, carry):
                t, p = self._metrics(xs)            # [ctx + c]
                t = t[ctx: ctx + c]
                p = p[ctx: ctx + c]
                s, f = schmitt_falling(t, self.thr_lo, self.thr_hi,
                                       carry)
                return t, p, s, f, s[-1]

            fn = jax.jit(run)
            self._chunk_fns[key] = fn
        return fn

    def metrics_host(self, x: np.ndarray, chunk_samples=None):
        """(timing, phase, state, falling) as HOST numpy arrays.

        chunk_samples (or any recording above CHUNK_AUTO_THRESHOLD)
        selects the chunked pass: overlapping windows whose starts and
        left context are multiples of window_sum's 512-sample block
        (so every window sum covers the same addends as the
        whole-recording pass), with the Schmitt state threaded across
        chunks via the carry.  Device memory is O(chunk) independent
        of recording length.  Outputs match the whole-recording pass
        to f32 reassociation tolerance (~1e-5 rel — XLA fuses the same
        arithmetic differently per input shape; verified eager
        computation is bitwise identical) and the post-fine-stage
        candidates are identical (test_sync.py::test_chunked_scan).
        """
        x = np.asarray(x, dtype=np.float32)
        t_all = x.shape[0]
        n_out = t_all - 2 * self.L
        if n_out <= 0:
            z = np.zeros(max(n_out, 0), dtype=np.float32)
            return z, z.copy(), z.astype(bool), z.astype(bool)
        if chunk_samples is None:
            if t_all <= self.CHUNK_AUTO_THRESHOLD:
                timing, phase = self._metrics_jit(jnp.asarray(x))
                state, falling = schmitt_falling(
                    timing, self.thr_lo, self.thr_hi)
                return (np.asarray(timing), np.asarray(phase),
                        np.asarray(state), np.asarray(falling))
            chunk_samples = self.CHUNK_DEFAULT
        ctx = -(-(2 * self.L + self.match_len) // _BLK) * _BLK
        # a chunk shorter than its left context would slice x with a
        # negative start for chunk 1 (empty slice, silently zero
        # metrics) — clamp up
        c = max(-(-int(chunk_samples) // _BLK) * _BLK, ctx)
        outs = ([], [], [], [])
        carry = jnp.asarray(False)
        for n0 in range(0, n_out, c):
            use_ctx = ctx if n0 else 0
            lo = n0 - use_ctx
            seg = x[lo: n0 + c + 2 * self.L]
            want = use_ctx + c + 2 * self.L
            if seg.shape[0] < want:
                seg = np.concatenate([seg, np.zeros(
                    (want - seg.shape[0], 2), np.float32)])
            t, p, s, f, carry = self._chunk_fn(c, use_ctx)(
                jnp.asarray(seg), carry)
            keep = min(c, n_out - n0)
            for acc, v in zip(outs, (t, p, s, f)):
                acc.append(np.asarray(v)[:keep])
        return tuple(np.concatenate(a) for a in outs)

    # -- device-side candidate extraction -----------------------------------
    # Chunks are processed in super-batches of up to this many per jit
    # call: the per-chunk work vmaps (parallel across the chip — or a
    # mesh, see parallel.sharded_scan), and the cross-chunk Schmitt /
    # argmax carries are recovered by composing per-chunk summaries
    # with the same associative operators (a two-level Blelloch scan).
    MAX_CHUNKS_PER_CALL = 16

    def _extract_batch_fn(self, c: int, ctx: int, k: int, m: int,
                          front=None, retain: bool = False):
        """Jitted m-chunk metrics + Schmitt + segmented-argmax pass.

        Returns only the first ``k`` falling edges of each chunk with
        their collect-region argmax index and fractional-CFO phase —
        O(m*k) host fetch instead of the O(T) timing/phase/state
        arrays (the device-side replacement for the reference's
        per-sample host tracker, decode.cc:84-152; the argmax-with-
        reset peak tracker decode.cc:95-101 is a segmented scan).

        ``front``: None for f32 split-complex chunks, or
        ("mono"|"stereo", bits) for raw PCM chunks — dequantisation
        (and for mono the DC-block + Hilbert front-end, fed by
        ``front_lead`` extra raw context samples) runs on device
        inside this same graph (ingest.py; decode.cc:294-301).

        ``retain``: additionally return each chunk's front-ended
        analytic samples [m, c + 2L, 2] (the [n0, n0 + c + 2L) span)
        so the caller can keep the whole analytic recording ON DEVICE
        for later window slicing — the payload/header/fine windows
        then cost zero extra transfer and zero front-end recompute.
        """
        key = (c, ctx, k, m, front, retain)
        fn = self._extract_fns.get(key)
        if fn is None:
            md = self.match_del
            fl = self.front_lead if front and front[0] == "mono" else 0

            def chunk_metrics(seg, n0):
                if front is not None:
                    kind, bits = front
                    if kind == "mono":
                        seg = ingest.analytic_chunk(
                            seg, n0 - ctx - fl, fl,
                            ctx + c + 2 * self.L, bits,
                            self.dc_window, self.taps)
                    else:
                        seg = ingest.dequant_dev(seg, bits)
                keep = seg[ctx:] if retain else jnp.zeros((0,))
                # chunk 0's left context is recording-start zero pad:
                # mask its product terms (see _metrics docstring)
                t, p = self._metrics(
                    seg, valid_from=jnp.where(n0 == 0, ctx, 0))
                # p[n - match_del]; at the recording start the host
                # path clamps to phase[0] == p[ctx] of chunk 0
                psh = jnp.concatenate([jnp.full((md,), p[0]), p[:-md]])
                t_c = t[ctx: ctx + c]
                psh_c = psh[ctx: ctx + c]
                j = jnp.arange(c)
                psh_c = jnp.where((n0 == 0) & (j < md), p[ctx], psh_c)
                return t_c, psh_c, keep

            def compose(lft, rgt):
                a1, b1 = lft
                a2, b2 = rgt
                return a2 | (b2 & a1), b2 & b1

            def run(segs, n0s, st_carry, mx_carry):
                t_c, psh_c, keep = jax.vmap(chunk_metrics)(segs, n0s)
                # Schmitt per chunk, then cross-chunk carry recovery
                a = t_c > self.thr_hi
                b = t_c >= self.thr_lo
                s0, ball = jax.lax.associative_scan(
                    compose, (a, b), axis=-1)
                sa, sb = jax.lax.associative_scan(
                    compose, (s0[:, -1], ball[:, -1]), axis=0)
                carry_st = jnp.concatenate(
                    [st_carry[None], sa[:-1] | (sb[:-1] & st_carry)])
                st_out = sa[-1] | (sb[-1] & st_carry)
                s = s0 | (ball & carry_st[:, None])
                prev_s = jnp.concatenate(
                    [carry_st[:, None], s[:, :-1]], axis=1)
                f = prev_s & ~s
                # segmented argmax per chunk (corrected state), then
                # cross-chunk carry recovery with the same operator
                idx = (n0s[:, None]
                       + jnp.arange(c, dtype=jnp.int32)[None, :])
                rv0, ri0, rp0, rg0 = jax.vmap(segmented_argmax)(
                    jnp.where(s, t_c, -jnp.inf), idx, psh_c, ~prev_s)
                iv, ii, ip, ig = jax.lax.associative_scan(
                    _seg_argmax_op,
                    (rv0[:, -1], ri0[:, -1], rp0[:, -1], rg0[:, -1]),
                    axis=0)
                cv, ci, cp = mx_carry
                take = ig | (iv > cv)
                pv = jnp.where(take, iv, cv)
                pi = jnp.where(take, ii, ci)
                pp = jnp.where(take, ip, cp)
                carry_v = jnp.concatenate([cv[None], pv[:-1]])
                carry_i = jnp.concatenate([ci[None], pi[:-1]])
                carry_p = jnp.concatenate([cp[None], pp[:-1]])
                take = rg0 | (rv0 > carry_v[:, None])
                ri = jnp.where(take, ri0, carry_i[:, None])
                rp = jnp.where(take, rp0, carry_p[:, None])
                # first k falling edges per chunk, in time order (at a
                # falling edge e the scan value equals the run max at
                # e-1: the edge element is -inf with no reset)
                pos = jnp.where(f, jnp.arange(c, dtype=jnp.int32), c)
                edges = jnp.sort(pos, axis=-1)[:, :k]
                valid = edges < c
                ee = jnp.minimum(edges, c - 1)
                nmax = jnp.take_along_axis(ri, ee, axis=1)
                ph = jnp.take_along_axis(rp, ee, axis=1)
                edges = jnp.where(valid, edges, -1)
                carry_out = (pv[-1], pi[-1], pp[-1])
                if retain:
                    return edges, nmax, ph, st_out, carry_out, keep
                return edges, nmax, ph, st_out, carry_out

            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                ax = self.mesh.axis_names[0]
                sh = NamedSharding(self.mesh, PartitionSpec(ax))
                rep = NamedSharding(self.mesh, PartitionSpec())
                fn = jax.jit(run, in_shardings=(sh, sh, rep,
                                                (rep, rep, rep)))
            else:
                fn = jax.jit(run)
            self._extract_fns[key] = fn
        return fn

    def _events_device(self, x: np.ndarray, chunk_samples: int,
                       max_edges: int, front=None,
                       retain: bool = False):
        """(edge, n_max, phase[n_max - match_del]) for the first
        ``max_edges`` falling edges, computed in super-batches of
        MAX_CHUNKS_PER_CALL chunks per jit call, O(chunks_per_call)
        device memory and O(max_edges) host transfer.  Same chunk and
        context block alignment as metrics_host; Schmitt state and
        running argmax composed across all chunk boundaries.  At most
        ``max_edges`` edges are taken per chunk — equivalent to the
        host path's global cap, not a divergence: the global first-k
        edges are each within their own chunk's first k (see scan()
        and test_dense_edges_per_chunk_cap_equivalence).

        ``front``: raw-PCM mode (see _extract_batch_fn) — ``x`` is
        then the quantised [T] mono / [T, 2] stereo wire array and
        chunks go to the device in wire dtype.

        Returns (events, analytic): with ``retain`` (PCM fronts only)
        ``analytic`` is the whole front-ended recording as ONE
        device-resident [T', 2] f32 array (T' >= t_all; pad chunks
        contribute dequantised-silence zeros) assembled from the scan
        chunks' own outputs, else None.
        """
        t_all = x.shape[0]
        n_out = t_all - 2 * self.L
        if n_out <= 0:
            return [], None
        ctx = -(-(2 * self.L + self.match_len) // _BLK) * _BLK
        # chunks must cover their own left context (see metrics_host)
        c = max(-(-int(chunk_samples) // _BLK) * _BLK, ctx)
        mono = front is not None and front[0] == "mono"
        fl = self.front_lead if mono else 0
        want = fl + ctx + c + 2 * self.L
        n_chunks = -(-n_out // c)
        st = jnp.asarray(False)
        mx = (jnp.float32(-np.inf), jnp.int32(0), jnp.float32(0.0))
        # Phase 1 — dispatch every super-batch without blocking: the
        # Schmitt/argmax carries chain on DEVICE (st, mx stay jax
        # arrays), so jax's async dispatch pipelines host slicing,
        # transfer and compute across calls; only the tiny per-call
        # edge triples are fetched, in phase 2.
        retain = retain and front is not None and self.mesh is None
        keeps = []
        pending = []
        g0 = 0
        while g0 < n_chunks:
            # super-batch decomposition: a remainder that fits one call
            # goes EXACTLY (10 chunks -> ONE call of 10; each remainder
            # m <= 16 lazily compiles its own graph, a set bounded by
            # MAX_CHUNKS_PER_CALL — every call costs a dispatch and a
            # result fetch, so short recordings should take one, not a
            # pow2 ladder of them); longer recordings
            # stream MAX-sized calls until the remainder fits
            rem = n_chunks - g0
            m = min(self.MAX_CHUNKS_PER_CALL, rem)
            if self.mesh is not None:   # chunk axis divides the mesh
                nd = self.mesh.devices.size
                m = max(nd, -(-m // nd) * nd)
            fn = self._extract_batch_fn(c, ctx, max_edges, m, front,
                                        retain)
            if front is None:
                segs = np.zeros((m, want, 2), np.float32)
            else:
                # quantised silence level: 0 for int16, 128 for uint8
                fill = 128 if front[1] == 8 else 0
                shape = (m, want) if mono else (m, want, 2)
                segs = np.full(shape, fill, x.dtype)
            # pad chunks carry the n_out sentinel: their edges (global
            # position >= n_out) are filtered below, and they can only
            # appear in the final super-batch, so the carries they
            # kill are never consumed
            n0s = np.full(m, n_out, np.int32)
            for j in range(min(m, rem)):
                n0 = (g0 + j) * c
                lo = n0 - ctx - fl
                seg = x[max(lo, 0): n0 + c + 2 * self.L]
                off = max(0, -lo)            # left zero-pad of chunk 0
                segs[j, off: off + seg.shape[0]] = seg
                n0s[j] = n0
            # np arrays pass straight to jit: with a mesh set, the
            # in_shardings place each chunk row on its device directly
            if retain:
                edges, nmax, ph, st, mx, keep = fn(segs, n0s, st, mx)
                keeps.append(keep)
            else:
                edges, nmax, ph, st, mx = fn(segs, n0s, st, mx)
            pending.append((edges, nmax, ph, n0s))
            g0 += m
        analytic = self._assemble_keep(keeps, c) if keeps else None
        # Phase 2 — ONE packed fetch for every call's event triples
        # (per-array fetches would be one device read EACH: 3 arrays
        # x calls; the packed [chunks, 3, k] int32 block is a single
        # copy, with the float phases bitcast through int32)
        packed = np.asarray(self._pack_events(pending))
        n0s_all = np.concatenate([p[3] for p in pending])
        events = []
        for j in range(len(n0s_all)):
            if len(events) >= max_edges:
                break
            phs = packed[j, 2].view(np.float32)
            for i, e in enumerate(packed[j, 0]):
                if e < 0 or n0s_all[j] + e >= n_out:
                    continue                 # fill slot / padded tail
                events.append((int(n0s_all[j] + e),
                               int(packed[j, 1, i]), float(phs[i])))
        return events[:max_edges], analytic

    def _pack_events(self, pending):
        """Stack every super-batch call's (edges, nmax, phase) into one
        [total_chunks, 3, k] int32 device array so phase 2 costs ONE
        host fetch (shapes differ only in m; one jit per ladder
        combination)."""
        key = ("pack", tuple(p[0].shape for p in pending))
        fn = self._chunk_fns.get(key)
        if fn is None:
            def pack(*flat):
                outs = []
                for i in range(0, len(flat), 3):
                    e, nm, ph = flat[i: i + 3]
                    outs.append(jnp.stack(
                        [e, nm,
                         jax.lax.bitcast_convert_type(ph, jnp.int32)],
                        axis=1))
                return jnp.concatenate(outs, 0)
            fn = jax.jit(pack)
            self._chunk_fns[key] = fn
        flat = []
        for e, nm, ph, _ in pending:
            flat += [e, nm, ph]
        return fn(*flat)

    def _assemble_keep(self, keeps, c: int):
        """Concatenate per-call retained chunks [m_i, c + 2L, 2] into
        one device [T', 2] analytic recording: each chunk contributes
        its canonical [n0, n0 + c) span; the final chunk also its 2L
        tail (recording samples past the last metric output)."""
        key = ("asm", c, tuple(k.shape for k in keeps))
        fn = self._chunk_fns.get(key)
        if fn is None:
            def asm(*parts):
                flat = [p[:, :c].reshape(-1, 2) for p in parts]
                return jnp.concatenate(flat + [parts[-1][-1, c:]], 0)
            fn = jax.jit(asm)
            self._chunk_fns[key] = fn
        return fn(*keeps)

    # -- public API --------------------------------------------------------
    def scan(self, x, max_candidates: int = 8,
             chunk_samples=None, host: bool = False):
        """Find S&C preambles in a recording.

        ``x``: complex np, split-complex [T, 2] f32, or an
        ingest.PcmRecording — raw PCM goes to the device in wire dtype
        and dequantises (mono: + DC-block + Hilbert, decode.cc:294-301)
        ON DEVICE inside the chunk graphs (2-4 bytes/sample instead of
        8 over the host link).

        Returns SyncCandidates in time order with the reference's gates
        applied (peak > 4*next, |pos_err| <= guard/2; decode.cc:140-145).

        Every recording scans chunk-by-chunk with device-side candidate
        extraction: constant device memory, O(candidates) host transfer,
        and — because chunk shapes come from a fixed two-size ladder
        with power-of-two super-batches — a BOUNDED set of compiled
        graphs serves any recording length (the whole-recording pass
        recompiles per length: >6 min for a 1.3M-sample graph on the
        remote compiler).  ``host=True`` forces the reference host-
        numpy edge walk over metrics_host (the spec the device path is
        tested against; for PCM input the spec front-end is
        ingest.PcmRecording.analytic_np).  The device extraction caps
        edges PER CHUNK at k = 4*max_candidates while the host walk
        caps globally — provably the SAME result: an edge among the
        global first k is, within its own chunk, also among that
        chunk's first k, so the per-chunk cap keeps a superset and
        the time-ordered global truncation matches
        (test_dense_edges_per_chunk_cap_equivalence).
        """
        cfg = self.cfg
        L = self.L
        pcm = x if isinstance(x, ingest.PcmRecording) else None
        if pcm is not None and host:   # host spec front-end (numpy)
            x = pcm.analytic_np(self.dc_window, self.taps)
            pcm = None
        if pcm is None:
            if np.iscomplexobj(x):
                x = cplx.from_np(x)
            x = np.asarray(x, dtype=np.float32)
        # examine a 4x margin of raw edges: spurious noise edges must
        # not consume candidate slots ahead of real, later frames
        max_edges = 4 * max_candidates

        if not host:
            # one fixed chunk size: any length decomposes into pow2
            # super-batches of these, so the compiled-graph set is
            # bounded AND each call stays ~2M samples — larger scan
            # graphs (16 x 2^20) OOM-killed the remote compile helper
            if chunk_samples is None:
                chunk_samples = self.CHUNK_SMALL
            if pcm is not None:
                front = ("mono" if pcm.channels == 1 else "stereo",
                         pcm.bits)
                # retain the on-device analytic recording when it fits
                # comfortably in device memory (f32 split-complex, <= ~512 MB
                # incl. pad chunks): the later fine/header/payload
                # window stages then slice it directly instead of
                # re-transferring + re-front-ending raw PCM.
                # pcm.data is treated as immutable (wire convention).
                retain = 16 * pcm.n_samples <= self.RETAIN_LIMIT_BYTES
                raw, analytic = self._events_device(
                    pcm.data, chunk_samples, max_edges, front,
                    retain=retain)
                if analytic is not None:
                    pcm._analytic_dev = analytic
            else:
                raw, _ = self._events_device(x, chunk_samples,
                                             max_edges)
        else:
            timing, phase, state, falling = self.metrics_host(x)
            raw = []
            for edge in np.nonzero(falling)[0][:max_edges]:
                # start of the collect region that ends at this edge
                prior = np.nonzero(~state[:edge])[0]
                rstart = prior[-1] + 1 if len(prior) else 0
                n_max = rstart + int(np.argmax(timing[rstart:edge]))
                raw.append((int(edge), n_max,
                            float(phase[max(n_max - self.match_del, 0)])))

        events = self.assemble_events(raw)
        if not events:
            return []

        if pcm is not None:
            wins = self._pcm_windows(pcm, [p + L for p, _ in events], L)
        else:
            wins = jnp.asarray(
                np.stack([self._window(x, p) for p, _ in events]))
        cands = self.fine_candidates(wins, events)
        out = []
        for c in cands:
            out.append(c)
            if sum(x.ok for x in out) >= max_candidates:
                break
        return out

    def assemble_events(self, raw) -> list:
        """(edge, n_max, phase) triples -> (p0, frac_cfo) events: the
        peak-to-symbol-start mapping with the collect-region cap
        (decode.cc:99-114).  Shared by scan() and the streaming
        decoder (stream.StreamDecoder) so the live and batch paths
        cannot drift."""
        L, cfg = self.L, self.cfg
        events = []
        for edge, n_max, ph in raw:
            index_max = min(edge - 1 - n_max + self.match_del,
                            L + cfg.guard_len + self.match_del)
            p0 = (edge - 1) - index_max  # == n_max - match_del uncapped
            events.append((p0, ph / L))
        return events

    def fine_candidates(self, wins, events) -> list:
        """Fine timing / integer-CFO stage + the reference's gates
        (peak > 4*next, |pos_err| <= guard/2; decode.cc:110-146) for
        pre-sliced windows wins[i] = x[p0_i + L : p0_i + 2L].  Returns
        one SyncCandidate per event, ok flag set.  Shared by scan()
        and stream.StreamDecoder."""
        L, cfg = self.L, self.cfg
        packed = np.asarray(self._fine_packed_jit(
            jnp.asarray(wins),
            jnp.asarray(np.array([fc for _, fc in events],
                                 dtype=np.float32))))   # ONE fetch
        shift = packed[:, 0]                             # [n, K]
        pos_err = packed[:, 1]
        peak = np.ascontiguousarray(packed[:, 2]).view(np.float32)
        nxt = np.ascontiguousarray(packed[:, 3]).view(np.float32)
        nconv = len(self.conventions)
        out = []
        for i, (p0, fc) in enumerate(events):
            alts = []
            for k in range(nconv):
                ok_k = bool(peak[i, k] > 4.0 * nxt[i, k]) and \
                    bool(abs(int(pos_err[i, k])) <= cfg.guard_len // 2)
                cfo = float(shift[i, k]) * 2.0 * np.pi / L - fc
                if cfo >= np.pi:
                    cfo -= 2.0 * np.pi
                ratio = float(peak[i, k] / max(nxt[i, k], 1e-30))
                alts.append((ok_k, ratio,
                             (k, int(p0) - int(pos_err[i, k]), cfo,
                              ratio)))
            alts.sort(key=lambda a: -a[1])
            passing = tuple(a[2] for a in alts if a[0])
            best = passing[0] if passing else alts[0][2]
            out.append(SyncCandidate(
                p0=best[1], frac_cfo=fc, cfo_rad=best[2],
                ok=bool(passing), peak_ratio=best[3], conv=best[0],
                alts=passing))
        return out

    def _pcm_windows(self, pcm, starts, out_len: int):
        """Slice raw PCM windows on the host and convert them to
        analytic [n, out_len, 2] ON DEVICE in one jitted call (padded
        to the next power of two so graph shapes stay bounded).
        Window ``i`` covers absolute samples [starts[i],
        starts[i] + out_len); mono windows carry ``front_lead`` raw
        context samples for the DC-block + Hilbert front-end.  Chunk
        starts here are NOT 512-aligned, so DC sums regroup at f32
        reassociation tolerance vs the whole-recording front-end —
        harmless below channel noise (the scan metrics path, which IS
        parity-tested, keeps alignment)."""
        an = getattr(pcm, "_analytic_dev", None)
        if an is not None:
            return self._cached_windows(an, starts, out_len)
        kind = "mono" if pcm.channels == 1 else "stereo"
        fl = self.front_lead if kind == "mono" else 0
        n = len(starts)
        npad = 1 << max(0, (n - 1).bit_length())
        fill = 128 if pcm.bits == 8 else 0
        want = fl + out_len
        shape = (npad, want) if kind == "mono" else (npad, want, 2)
        raws = np.full(shape, fill, pcm.data.dtype)
        abs0s = np.zeros(npad, np.int32)
        for i, s0 in enumerate(starts):
            lo = int(s0) - fl
            seg = pcm.data[max(lo, 0): max(lo + want, 0)]
            off = max(0, -lo)
            raws[i, off: off + len(seg)] = seg
            abs0s[i] = lo
        key = (kind, pcm.bits, out_len, npad)
        fn = self._pcm_win_fns.get(key)
        if fn is None:
            if kind == "mono":
                def conv(r, a):
                    return jax.vmap(
                        lambda rr, aa: ingest.analytic_chunk(
                            rr, aa, fl, out_len, pcm.bits,
                            self.dc_window, self.taps))(r, a)
            else:
                def conv(r, a):
                    return ingest.dequant_dev(r, pcm.bits)
            fn = jax.jit(conv)
            self._pcm_win_fns[key] = fn
        return fn(jnp.asarray(raws), jnp.asarray(abs0s))[:n]

    def _cached_windows(self, an, starts, out_len: int):
        """Slice [n, out_len, 2] windows from the scan's retained
        device-resident analytic recording (sync.scan retain path):
        zero extra host transfer and zero front-end recompute.  The
        analytic array index IS the absolute recording index; spans
        reaching before sample 0 / past the end read the zero pad
        (identical to the raw path's quantised-silence fill).  Values
        match the raw-window path to f32 reassociation tolerance and
        the scan/host spec front-end EXACTLY (chunk-aligned DC
        grouping; the raw path regroups at window starts)."""
        n = len(starts)
        npad = 1 << max(0, (n - 1).bit_length())
        s0s = np.zeros(npad, np.int32)
        s0s[:n] = [int(s) for s in starts]
        key = ("cached", out_len, npad, int(an.shape[0]))
        fn = self._pcm_win_fns.get(key)
        if fn is None:
            def conv(a, ss):
                a = jnp.pad(a, ((out_len, out_len), (0, 0)))
                return jax.vmap(lambda s0: jax.lax.dynamic_slice(
                    a, (s0 + out_len, 0), (out_len, 2)))(ss)
            fn = jax.jit(conv)
            self._pcm_win_fns[key] = fn
        return fn(an, jnp.asarray(s0s))[:n]

    def _window(self, x: np.ndarray, p0: int) -> np.ndarray:
        L = self.L
        lo = p0 + L
        out = np.zeros((L, 2), dtype=np.float32)
        seg = x[max(lo, 0): max(lo + L, 0)]
        off = max(0, -lo)          # keep alignment for p0 < -L
        out[off: off + len(seg)] = seg
        return out
