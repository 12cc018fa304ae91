"""Device-side SCL polar decoder: a schedule-driven vector machine.

Array-program equivalent of CODE::PolarListDecoder (decode.cc:201,530).
The reference walks the 2^16-leaf SC tree with SIMD lanes as list paths.
A literal translation is impossible under XLA (data-dependent recursion)
and a naive leaf-sequential scan is 65536 steps of tiny work.  Instead:

  * The tree is pruned host-side into Fast-SSC constituent nodes
    (RATE0 / REP / RATE1 with list forks; Sarkis et al. style) and
    linearised into a STATIC instruction schedule — possible because the
    frozen mask is a compile-time constant.  ~20k instructions replace
    131k leaf visits.
  * The device executes the schedule as one `lax.scan` whose step is a
    `lax.switch` over 6 micro-ops (f / g / combine / leaf ops), each a
    fixed-width (C=512) chunk of vector work over all L list lanes (and a
    vmapped frame batch).
  * All large-buffer writes happen UNCONDITIONALLY outside the switch
    (branches return chunk values + offsets; unused writes land in a
    scratch column block).  This keeps XLA's while-loop buffer aliasing
    intact — with writes inside the conditional the scan state (tens of
    MB) is copied every step and the decoder becomes bandwidth-bound on
    state copies.
  * List forks never copy the LLR/partial-sum buffers: per-depth (and
    per-beta-slot) lane-indirection vectors (`refs`, `brefs`) are
    permuted instead (Tal-Vardy lazy copy, collapsed to O(depth * L)
    integers because every buffer write is lane-dense).
  * Partial sums use per-depth double slots (left/right child), so each
    node's completion writes straight into its parent's input — no
    save/copy instruction.

Path metrics are the min-sum LLR formulation (penalty |llr| on sign
mismatch).  RATE1 nodes fork on the T=4 least-reliable bits per node —
the standard list-rate-1 approximation.  The decoder outputs the
re-encoded codeword per path (root partial sums), which makes the
reference's systematic() step (decode.cc:254-261) a gather.

Buffers are padded per region to the chunk width so every access is a
static-size dynamic slice; padding garbage is never read unmasked.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

CHUNK = 512      # static op width (columns)
T_RATE1 = 4      # fork rounds per RATE1 node

# Exact one-shot enumeration table: all 2^7 subsets of the 7
# least-reliable flip positions as a 0/1 matrix.  PAT7 @ vals gives
# every candidate's flip penalty in one pass; SPAR7 is each pattern's
# popcount parity (the SPC parity-adjuster term).  7 positions suffice
# for a list of 8: the k smallest subset sums of non-negative values
# use only the k-1 smallest elements (the empty set plus the k-1
# singletons already dominate any subset containing a larger element).
PAT7 = ((np.arange(128)[None, :] >> np.arange(7)[:, None]) & 1
        ).astype(np.float32)                       # [7, 128]
SPAR7 = (PAT7.sum(axis=0) % 2).astype(np.float32)  # [128]

OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_REP, OP_RATE1, OP_SPC = range(7)

# operand columns of a schedule row
(C_OP, C_D, C_SRC, C_SRC2, C_DST, C_BSRC, C_BSRC2, C_BDST, C_SIDR,
 C_SIDR2, C_SIDW, C_WIDTH, C_LAST) = range(13)


@dataclasses.dataclass
class Schedule:
    ops: np.ndarray        # [n, 13] int32
    sz_llr: int
    sz_beta: int
    n_depths: int
    code_len: int
    out_off: int           # column offset of the root codeword (slot A_0)

    @property
    def n_ops(self) -> int:
        return len(self.ops)


@functools.lru_cache(maxsize=None)
def build_schedule(frozen_key, emit_spc: bool = True) -> Schedule:
    """frozen_key: bytes of the frozen mask (hashable).

    emit_spc=False decomposes single-parity-check nodes into subtrees
    (left SPC child recursion terminates at width-2 REP leaves): with
    RATE1 forking list_size-1 rounds, the resulting schedule is an
    EXACT bit-by-bit SCL equivalent (Sarkis et al., "Fast List
    Decoders for Polar Codes": min(L-1, w) serial least-reliable forks
    reproduce rate-1 nodes exactly; REP/RATE0 are trivially exact).
    Since round 3 the SPC leaf op itself has an exact variant (the
    parity bit folded into the flip set as a toggling adjuster, L-1
    fork rounds — see op_spc), so the decomposed schedule survives
    only as a cross-validation oracle for that op.
    """
    frozen = np.frombuffer(frozen_key, dtype=np.uint8)
    n = len(frozen)
    depths = n.bit_length()

    # llr region per depth
    lofs = []
    pos = 0
    for d in range(depths):
        lofs.append(pos)
        pos += max(n >> d, CHUNK)
    sz_llr = pos
    # beta slots: per depth, A (left child result) and B (right child).
    # Depth 0 is the root — it has no sibling, so B_0 is never written
    # and aliases A_0 (saves a full code length of buffer).
    bslot = np.zeros((depths, 2), dtype=np.int64)
    pos = 0
    for d in range(depths):
        alloc = max(n >> d, CHUNK)
        bslot[d, 0] = pos
        bslot[d, 1] = pos + (alloc if d > 0 else 0)
        pos += (2 * alloc) if d > 0 else alloc
    sz_beta = pos

    ops: list[tuple] = []

    def sid(d, side):
        return 2 * d + side

    def emit(op, d, w, side, **kw):
        """Emit chunked instructions for an op covering w columns."""
        nchunks = max(1, -(-w // CHUNK))
        for j in range(nchunks):
            off = j * CHUNK
            width = min(CHUNK, w - off)
            row = [0] * 13
            row[C_OP] = op
            row[C_D] = d
            row[C_WIDTH] = width
            row[C_LAST] = int(j == nchunks - 1)
            for key, val in kw.items():
                idx = {"src": C_SRC, "src2": C_SRC2, "dst": C_DST,
                       "bsrc": C_BSRC, "bsrc2": C_BSRC2, "bdst": C_BDST,
                       "sidr": C_SIDR, "sidr2": C_SIDR2,
                       "sidw": C_SIDW}[key]
                # offsets advance with the chunk; slot ids do not
                row[idx] = val + (off if key not in ("sidr", "sidr2",
                                                     "sidw") else 0)
            ops.append(tuple(row))

    def walk(lo, hi, d, side):
        w = hi - lo
        fz = frozen[lo:hi]
        s = int(fz.sum())
        own = bslot[d, side]
        if w <= CHUNK:
            if s == w:
                emit(OP_RATE0, d, w, side, src=lofs[d], bdst=own,
                     sidw=sid(d, side))
                return
            if s == 0:
                emit(OP_RATE1, d, w, side, src=lofs[d], bdst=own,
                     sidw=sid(d, side))
                return
            if s == w - 1 and fz[-1] == 0:
                emit(OP_REP, d, w, side, src=lofs[d], bdst=own,
                     sidw=sid(d, side))
                return
            if s == 1 and fz[0] == 1 and emit_spc:
                # single parity check: list decode with exclusive
                # pair-flip alternatives (Fast-SSC-List SPC node)
                emit(OP_SPC, d, w, side, src=lofs[d], bdst=own,
                     sidw=sid(d, side))
                return
        h = w // 2
        emit(OP_F, d, h, side, src=lofs[d], src2=lofs[d] + h,
             dst=lofs[d + 1])
        walk(lo, lo + h, d + 1, 0)
        emit(OP_G, d, h, side, src=lofs[d], src2=lofs[d] + h,
             dst=lofs[d + 1], bsrc=bslot[d + 1, 0], sidr=sid(d + 1, 0))
        walk(lo + h, hi, d + 1, 1)
        # combine: own slot <- [bl * br | br] from children slots
        emit(OP_COMBINE, d, h, side, bsrc=bslot[d + 1, 0],
             bsrc2=bslot[d + 1, 1], bdst=own, dst=own + h,
             sidr=sid(d + 1, 0), sidr2=sid(d + 1, 1),
             sidw=sid(d, side))

    walk(0, n, 0, 0)
    return Schedule(ops=np.array(ops, dtype=np.int32), sz_llr=sz_llr,
                    sz_beta=sz_beta, n_depths=depths, code_len=n,
                    out_off=int(bslot[0, 0]))


# ---------------------------------------------------------------------------
# Device VM
# ---------------------------------------------------------------------------

def _gather(buf, lanes, off):
    """[L, SZ] buffer -> [L, CHUNK] chunk at `off`, lanes re-indexed."""
    sl = jax.lax.dynamic_slice(buf, (0, off), (buf.shape[0], CHUNK))
    return jnp.take(sl, lanes, axis=0)


def _reset_row(refs, idx, last):
    ident = jnp.arange(refs.shape[1], dtype=refs.dtype)
    row = jnp.where(last > 0, ident, refs[idx])
    return jax.lax.dynamic_update_slice(refs, row[None, :], (idx, 0))


def _select_paths(pm_cand, L):
    """2L candidate metrics -> (perm [L], flip flag [L], new pm [L])."""
    neg, order = jax.lax.top_k(-pm_cand, L)
    return order % L, order >= L, -neg


def permute_lanes(mat, lanes):
    """mat [..., W] -> mat[..., lanes]: move whole list lanes (the
    batched VM's fork / lazy-copy permutation) as one gather.

    A gather, not a one-hot [W, W] f32 matmul: both are exact, but on
    an H100 the matmul's W^2 cost made the whole list-8 decode at
    W = 4,096 lanes ten times slower, and it lost at W = 128 and 512
    too."""
    return jnp.take(mat, lanes, axis=-1)


def scl_params(list_size: int, exact: bool, decompose_spc: bool):
    """Shared knob derivation for the SCL decoders.

    Returns (emit_spc, t_r1, t_spc, spc_exact):
      * exact=True (the serving default): RATE1/SPC leaves decode with
        the ONE-SHOT enumeration (global top-L over the [L, 128]
        candidate matrix of per-lane flip subsets; parity-forced i0
        for SPC) — bit-by-bit SCL equivalent on the fast schedule.
      * exact=False: Fast-SSC-List approximation — T_RATE1 serial fork
        rounds per RATE1 node, exclusive pair flips per SPC node
        (measured gap: 1 frame in 500 across the sensitivity edge).
      * exact=True, decompose_spc=True: SPC nodes decomposed into
        subtrees (the round-2 exact path, ~2x the ops) — retained as a
        cross-validation oracle for the one-shot SPC op.
    t_r1/t_spc parameterize only the serial (fast / RATE1-subtree)
    rounds; the one-shot path enumerates all 2^7 subsets statically.
    """
    emit_spc = not (exact and decompose_spc)
    t_r1 = (list_size - 1) if exact else T_RATE1
    t_spc = list_size if exact else T_RATE1
    return emit_spc, t_r1, t_spc, bool(exact)


def make_batch_decoder(frozen: np.ndarray, batch: int,
                       list_size: int = 8, exact: bool = True,
                       decompose_spc: bool = False):
    """Batched SCL decoder: one schedule pass for the whole batch.

    State lives as [SZ, batch*list] so every chunk access is a
    major-axis dynamic slice of contiguous rows and the minor (lane)
    dimension holds every path of every frame (batch*list = 128 with
    batch=16, L=8) — the vmapped single-frame decoder instead puts the
    multi-hundred-KB buffer axis minor.  Fork bookkeeping uses flat
    lane indices (b*L + l); lane permutations are gathers
    (permute_lanes).

    Returns fn: llrs [batch, code_len] -> (codewords [batch, L,
    code_len] 0/1, path metrics [batch, L]).
    """
    emit_spc, t_r1, t_spc, spc_exact = scl_params(list_size, exact,
                                                  decompose_spc)
    sched = build_schedule(np.asarray(frozen, dtype=np.uint8).tobytes(),
                           emit_spc=emit_spc)
    L = list_size
    B = batch
    W = B * L
    n = sched.code_len
    big = jnp.float32(3.0e38)
    llr_scratch = np.int32(sched.sz_llr)
    beta_scratch = np.int32(sched.sz_beta)
    lane_b = np.repeat(np.arange(B, dtype=np.int32), L) * L  # flat base

    def select(pm, extra):
        """pm, extra: [W] keep/flip metrics -> (perm_flat, flip, pm')."""
        cand = jnp.concatenate(
            [pm.reshape(B, L), (pm + extra).reshape(B, L)], axis=1)
        neg, order = jax.lax.top_k(-cand, L)       # [B, L]
        perm_flat = (order % L + jnp.asarray(lane_b).reshape(B, L)
                     ).reshape(W)
        flip = (order >= L).reshape(W)
        return perm_flat, flip, -neg.reshape(W)

    def step(state, row):
        llr, beta, refs, brefs, pm = state
        d = row[C_D]

        def rd_llr(off):
            sl = jax.lax.dynamic_slice(llr, (off, 0), (CHUNK, W))
            return permute_lanes(sl, refs[d])

        def rd_beta(sid, off):
            sl = jax.lax.dynamic_slice(beta, (off, 0), (CHUNK, W))
            return permute_lanes(sl, brefs[sid])

        zero_chunk = jnp.zeros((CHUNK, W), jnp.float32)

        def op_f(_):
            a, b = rd_llr(row[C_SRC]), rd_llr(row[C_SRC2])
            out = jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a),
                                                          jnp.abs(b))
            return (out, row[C_DST], zero_chunk, beta_scratch,
                    zero_chunk, beta_scratch,
                    _reset_row(refs, d + 1, row[C_LAST]), brefs, pm)

        def op_g(_):
            a, b = rd_llr(row[C_SRC]), rd_llr(row[C_SRC2])
            bl = rd_beta(row[C_SIDR], row[C_BSRC])
            return (b + bl * a, row[C_DST], zero_chunk, beta_scratch,
                    zero_chunk, beta_scratch,
                    _reset_row(refs, d + 1, row[C_LAST]), brefs, pm)

        def op_combine(_):
            bl = rd_beta(row[C_SIDR], row[C_BSRC])
            br = rd_beta(row[C_SIDR2], row[C_BSRC2])
            return (zero_chunk, llr_scratch, bl * br, row[C_BDST],
                    br, row[C_DST], refs,
                    _reset_row(brefs, row[C_SIDW], row[C_LAST]), pm)

        def op_rate0(_):
            a = rd_llr(row[C_SRC])
            m = (jnp.arange(CHUNK) < row[C_WIDTH]).astype(
                jnp.float32)[:, None]
            pm2 = pm + jnp.sum(jnp.maximum(-a, 0.0) * m, axis=0)
            return (zero_chunk, llr_scratch,
                    jnp.ones((CHUNK, W), jnp.float32), row[C_BDST],
                    zero_chunk, beta_scratch, refs,
                    _reset_row(brefs, row[C_SIDW], row[C_LAST]), pm2)

        def op_rep(_):
            a = rd_llr(row[C_SRC])
            m = (jnp.arange(CHUNK) < row[C_WIDTH]).astype(
                jnp.float32)[:, None]
            m0 = jnp.sum(jnp.maximum(-a, 0.0) * m, axis=0)
            m1 = jnp.sum(jnp.maximum(a, 0.0) * m, axis=0)
            perm, flip, pm2 = select(pm + m0, m1 - m0)
            sign = jnp.where(flip, -1.0, 1.0).astype(jnp.float32)
            bval = jnp.broadcast_to(sign[None, :], (CHUNK, W))
            return (zero_chunk, llr_scratch, bval, row[C_BDST],
                    zero_chunk, beta_scratch, permute_lanes(refs, perm),
                    _reset_row(permute_lanes(brefs, perm), row[C_SIDW],
                               row[C_LAST]), pm2)

        def _extract(mag, t):
            """t smallest |llr| per lane by iterative min-extraction
            (a full top_k sort lowers poorly here): [W, t] vals+idxs."""
            iota_c = jnp.arange(CHUNK)[:, None]
            vals_l, idxs_l = [], []
            mag_t = mag
            for _ in range(t):
                v = jnp.min(mag_t, axis=0)
                at = jnp.min(jnp.where(mag_t == v[None, :], iota_c,
                                       CHUNK), axis=0)
                vals_l.append(v)
                idxs_l.append(at)
                mag_t = jnp.where(iota_c == at[None, :], big, mag_t)
            return jnp.stack(vals_l, axis=1), jnp.stack(idxs_l, axis=1)

        def _oneshot(b, mag, pm_in, odd, row):
            """One-shot exact list decode of a RATE1 (odd=None) or SPC
            node — see make_decoder._oneshot; batch layout [CHUNK, W]
            with per-frame top-L over the [L, 128] candidate block."""
            t = 7 if odd is None else 8
            fl0 = 0 if odd is None else 1
            iota_c = jnp.arange(CHUNK)[:, None]
            vals, idxs = _extract(mag, t)              # [W, t]
            subs = jnp.zeros((W, 128), jnp.float32)
            for j in range(7):
                subs = subs + vals[:, fl0 + j, None] * PAT7[j][None, :]
            if odd is None:
                cand = pm_in[:, None] + subs
            else:
                i0_in = odd[:, None] ^ (SPAR7 > 0.5)[None, :]
                cand = pm_in[:, None] + subs + jnp.where(
                    i0_in, vals[:, 0, None], 0.0)
            neg, order = jax.lax.top_k(-cand.reshape(B, L * 128), L)
            pm2 = -neg.reshape(W)
            pat = (order % 128).reshape(W)
            perm_flat = (order // 128
                         + jnp.asarray(lane_b).reshape(B, L)).reshape(W)
            b2 = permute_lanes(b, perm_flat)
            idxs_s = permute_lanes(idxs.T, perm_flat).T    # [W, t]
            patbits = jnp.take(jnp.asarray(PAT7), pat, axis=1).T
            flip = jnp.zeros((CHUNK, W), jnp.float32)
            for j in range(7):
                flip = flip + patbits[:, j][None, :] * (
                    iota_c == idxs_s[:, fl0 + j][None, :])
            if odd is not None:
                odd_s = permute_lanes(odd, perm_flat).astype(jnp.float32)
                sp = jnp.take(jnp.asarray(SPAR7), pat)
                i0bit = odd_s + sp - 2.0 * odd_s * sp   # XOR on {0,1}
                flip = flip + i0bit[None, :] * (
                    iota_c == idxs_s[:, 0][None, :])
            b2 = jnp.where(flip > 0.5, -b2, b2)
            return (zero_chunk, llr_scratch, b2, row[C_BDST],
                    zero_chunk, beta_scratch,
                    permute_lanes(refs, perm_flat),
                    _reset_row(permute_lanes(brefs, perm_flat),
                               row[C_SIDW], row[C_LAST]), pm2)

        def op_rate1(_):
            a = rd_llr(row[C_SRC])
            valid = (jnp.arange(CHUNK) < row[C_WIDTH])[:, None]
            mag = jnp.where(valid, jnp.abs(a), big)
            b_local = jnp.where(a < 0, -1.0, 1.0) * valid
            if spc_exact:
                return _oneshot(b_local, mag, pm, None, row)
            iota_c = jnp.arange(CHUNK)[:, None]
            vals_l, idxs_l = [], []
            mag_t = mag
            for _ in range(t_r1):
                v = jnp.min(mag_t, axis=0)
                at = jnp.min(jnp.where(mag_t == v[None, :], iota_c,
                                       CHUNK), axis=0)
                vals_l.append(v)
                idxs_l.append(at)
                mag_t = jnp.where(iota_c == at[None, :], big, mag_t)
            vals = jnp.stack(vals_l, axis=1)              # [W, T]
            idxs = jnp.stack(idxs_l, axis=1)
            gperm = jnp.arange(W)
            pm2 = pm
            for r in range(t_r1):
                perm, flip, pm2 = select(pm2, vals[:, r])
                b_local = permute_lanes(b_local, perm)
                vals = permute_lanes(vals.T, perm).T
                idxs = permute_lanes(idxs.T, perm).T
                gperm = jnp.take(gperm, perm)
                onehot = ((jnp.arange(CHUNK)[:, None] ==
                           idxs[:, r][None, :]) & flip[None, :])
                b_local = jnp.where(onehot, -b_local, b_local)
            return (zero_chunk, llr_scratch, b_local, row[C_BDST],
                    zero_chunk, beta_scratch, permute_lanes(refs, gperm),
                    _reset_row(permute_lanes(brefs, gperm), row[C_SIDW],
                               row[C_LAST]), pm2)

        def op_spc(_):
            """Single-parity-check node.  Fast mode: parity-fix the
            hard decisions, then fork on exclusive pair flips {i0, ij}
            (Fast-SSC-List; a path takes at most ONE pair flip via the
            `switched` blocker).  Exact mode: one-shot enumeration with
            the parity bit i0 forced per candidate subset (_oneshot) —
            bit-by-bit SCL exact (tests/test_scl_vm.py)."""
            a = rd_llr(row[C_SRC])
            valid = (jnp.arange(CHUNK) < row[C_WIDTH])[:, None]
            mag = jnp.where(valid, jnp.abs(a), big)
            b = jnp.where(a < 0, -1.0, 1.0) * valid
            odd = (jnp.sum(b < 0, axis=0) % 2) == 1           # [W]
            if spc_exact:
                return _oneshot(b, mag, pm, odd, row)
            iota_c = jnp.arange(CHUNK)[:, None]
            vals, idxs = _extract(mag, t_spc)                 # [W, T]
            pm2 = pm + jnp.where(odd, vals[:, 0], 0.0)
            b = jnp.where((iota_c == idxs[:, 0][None, :]) &
                          odd[None, :], -b, b)
            switched = jnp.zeros((W,), jnp.bool_)
            gperm = jnp.arange(W)
            for r in range(1, t_spc):
                delta = jnp.where(odd, vals[:, r] - vals[:, 0],
                                  vals[:, r] + vals[:, 0])
                delta = jnp.where(switched, big, delta)
                perm, flip, pm2 = select(pm2, delta)
                b = permute_lanes(b, perm)
                vals = permute_lanes(vals.T, perm).T
                idxs = permute_lanes(idxs.T, perm).T
                odd = permute_lanes(odd, perm)
                switched = permute_lanes(switched, perm)
                gperm = jnp.take(gperm, perm)
                pair = ((iota_c == idxs[:, 0][None, :]) |
                        (iota_c == idxs[:, r][None, :]))
                b = jnp.where(pair & flip[None, :], -b, b)
                switched = switched | flip
            return (zero_chunk, llr_scratch, b, row[C_BDST],
                    zero_chunk, beta_scratch, permute_lanes(refs, gperm),
                    _reset_row(permute_lanes(brefs, gperm), row[C_SIDW],
                               row[C_LAST]), pm2)

        (lval, loff, bval1, boff1, bval2, boff2, refs2, brefs2,
         pm2) = jax.lax.switch(
            row[C_OP], [op_f, op_g, op_combine, op_rate0, op_rep,
                        op_rate1, op_spc], None)
        llr = jax.lax.dynamic_update_slice(llr, lval, (loff, 0))
        beta = jax.lax.dynamic_update_slice(beta, bval1, (boff1, 0))
        beta = jax.lax.dynamic_update_slice(beta, bval2, (boff2, 0))
        return (llr, beta, refs2, brefs2, pm2), None

    ops_arr = jnp.asarray(sched.ops)

    def decode(llrs):
        llr0 = jnp.zeros((sched.sz_llr + CHUNK, W), jnp.float32)
        # region 0 = channel LLRs: [N, B] broadcast over the L lanes
        chan = jnp.repeat(llrs.T, L, axis=1)       # [N, W]
        llr0 = llr0.at[:n, :].set(chan)
        vzero = llrs[0, 0] * 0.0
        beta0 = jnp.zeros((sched.sz_beta + CHUNK, W), jnp.float32) + vzero
        ident = jnp.arange(W, dtype=jnp.int32) + vzero.astype(jnp.int32)
        refs0 = jnp.broadcast_to(ident, (sched.n_depths, W))
        brefs0 = jnp.broadcast_to(ident, (2 * sched.n_depths, W))
        # lane l=0 of each frame starts live, clones die immediately
        pm0 = jnp.where(jnp.arange(W) % L == 0, 0.0, big / 2) + vzero
        state = (llr0, beta0, refs0, brefs0, pm0)
        (llr, beta, refs, brefs, pm), _ = jax.lax.scan(step, state,
                                                       ops_arr)
        out = jax.lax.dynamic_slice(beta, (sched.out_off, 0), (n, W))
        codeword = (out < 0).astype(jnp.uint8)      # [N, W]
        codeword = codeword.T.reshape(B, L, n)
        return codeword, pm.reshape(B, L)

    return decode


def make_decoder(frozen: np.ndarray, list_size: int = 8,
                 exact: bool = True, decompose_spc: bool = False):
    """Compile an SCL decoder for one frozen mask.

    Returns a function llrs [code_len] -> (codewords [L, code_len] 0/1,
    path metrics [L]); jit/vmap as needed.  exact=True is provably
    bit-by-bit-SCL-equivalent (exact SPC rule + L-1 RATE1 fork rounds)
    at the fast schedule's op count; decompose_spc=True additionally
    decomposes SPC nodes into subtrees (the round-2 exact path, ~2x the
    ops — kept as a cross-check oracle for the exact SPC op).
    """
    emit_spc, t_r1, t_spc, spc_exact = scl_params(list_size, exact,
                                                  decompose_spc)
    sched = build_schedule(np.asarray(frozen, dtype=np.uint8).tobytes(),
                           emit_spc=emit_spc)
    L = list_size
    n = sched.code_len
    big = jnp.float32(3.0e38)
    # scratch blocks absorb the unused unconditional writes
    llr_scratch = np.int32(sched.sz_llr)
    beta_scratch = np.int32(sched.sz_beta)

    def step(state, row):
        llr, beta, refs, brefs, pm = state
        d = row[C_D]

        def rd_llr(off):
            return _gather(llr, refs[d], off)

        def rd_beta(sid, off):
            return _gather(beta, brefs[sid], off)

        zero_chunk = jnp.zeros((L, CHUNK), jnp.float32)

        # Each branch returns:
        #   (llr_val, llr_off, bval1, boff1, bval2, boff2, refs, brefs, pm)
        def op_f(_):
            a, b = rd_llr(row[C_SRC]), rd_llr(row[C_SRC2])
            out = jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a),
                                                          jnp.abs(b))
            return (out, row[C_DST], zero_chunk, beta_scratch,
                    zero_chunk, beta_scratch,
                    _reset_row(refs, d + 1, row[C_LAST]), brefs, pm)

        def op_g(_):
            a, b = rd_llr(row[C_SRC]), rd_llr(row[C_SRC2])
            bl = rd_beta(row[C_SIDR], row[C_BSRC])
            return (b + bl * a, row[C_DST], zero_chunk, beta_scratch,
                    zero_chunk, beta_scratch,
                    _reset_row(refs, d + 1, row[C_LAST]), brefs, pm)

        def op_combine(_):
            bl = rd_beta(row[C_SIDR], row[C_BSRC])
            br = rd_beta(row[C_SIDR2], row[C_BSRC2])
            return (zero_chunk, llr_scratch, bl * br, row[C_BDST],
                    br, row[C_DST], refs,
                    _reset_row(brefs, row[C_SIDW], row[C_LAST]), pm)

        def op_rate0(_):
            a = rd_llr(row[C_SRC])
            m = (jnp.arange(CHUNK) < row[C_WIDTH]).astype(jnp.float32)
            pm2 = pm + jnp.sum(jnp.maximum(-a, 0.0) * m, axis=-1)
            return (zero_chunk, llr_scratch,
                    jnp.ones((L, CHUNK), jnp.float32), row[C_BDST],
                    zero_chunk, beta_scratch, refs,
                    _reset_row(brefs, row[C_SIDW], row[C_LAST]), pm2)

        def op_rep(_):
            a = rd_llr(row[C_SRC])
            m = (jnp.arange(CHUNK) < row[C_WIDTH]).astype(jnp.float32)
            m0 = jnp.sum(jnp.maximum(-a, 0.0) * m, axis=-1)
            m1 = jnp.sum(jnp.maximum(a, 0.0) * m, axis=-1)
            perm, flip, pm2 = _select_paths(
                jnp.concatenate([pm + m0, pm + m1]), L)
            sign = jnp.where(flip, -1.0, 1.0).astype(jnp.float32)
            bval = jnp.broadcast_to(sign[:, None], (L, CHUNK))
            return (zero_chunk, llr_scratch, bval, row[C_BDST],
                    zero_chunk, beta_scratch, refs[:, perm],
                    _reset_row(brefs[:, perm], row[C_SIDW],
                               row[C_LAST]), pm2)

        def op_rate1(_):
            a = rd_llr(row[C_SRC])
            valid = jnp.arange(CHUNK) < row[C_WIDTH]
            mag = jnp.where(valid[None, :], jnp.abs(a), big)
            b_local = jnp.where(a < 0, -1.0, 1.0) * valid[None, :]
            if spc_exact:
                return _oneshot(b_local, mag, pm, None, row)
            vals, idxs = jax.lax.top_k(-mag, t_r1)
            vals = -vals
            gperm = jnp.arange(L)
            pm2 = pm
            for r in range(t_r1):
                perm, flip, pm2 = _select_paths(
                    jnp.concatenate([pm2, pm2 + vals[:, r]]), L)
                b_local = jnp.take(b_local, perm, axis=0)
                vals = jnp.take(vals, perm, axis=0)
                idxs = jnp.take(idxs, perm, axis=0)
                gperm = jnp.take(gperm, perm)
                onehot = (jnp.arange(CHUNK)[None, :] ==
                          idxs[:, r][:, None]) & flip[:, None]
                b_local = jnp.where(onehot, -b_local, b_local)
            return (zero_chunk, llr_scratch, b_local, row[C_BDST],
                    zero_chunk, beta_scratch, refs[:, gperm],
                    _reset_row(brefs[:, gperm], row[C_SIDW],
                               row[C_LAST]), pm2)

        def _oneshot(b, mag, pm_in, odd, row):
            """One-shot exact list decode of a RATE1 (odd=None) or SPC
            node: enumerate every candidate flip set as (source lane,
            subset of the 7 least-reliable positions [plus the
            parity-forced i0 for SPC]) and take the global top-L in a
            single selection.  Equal to bit-by-bit SCL by the greedy-
            dominance argument (a path pruned at bit i cannot beat any
            survivor's zero-cost extension), with all serial fork
            rounds replaced by one candidate matrix [L, 128]."""
            t = 7 if odd is None else 8
            iota_c = jnp.arange(CHUNK)[None, :]
            nvals, idxs = jax.lax.top_k(-mag, t)
            vals = -nvals                              # [L, t] ascending
            fl0 = 0 if odd is None else 1
            subs = jnp.zeros((L, 128), jnp.float32)
            for j in range(7):
                subs = subs + vals[:, fl0 + j, None] * PAT7[j][None, :]
            if odd is None:
                cand = pm_in[:, None] + subs
            else:
                i0_in = odd[:, None] ^ (SPAR7 > 0.5)[None, :]
                cand = pm_in[:, None] + subs + jnp.where(
                    i0_in, vals[:, 0, None], 0.0)
            neg, order = jax.lax.top_k(-cand.reshape(L * 128), L)
            pm2 = -neg
            src = order // 128
            pat = order % 128
            patbits = jnp.take(jnp.asarray(PAT7), pat, axis=1).T  # [L,7]
            idxs_s = jnp.take(idxs, src, axis=0)
            b2 = jnp.take(b, src, axis=0)
            flip = jnp.zeros((L, CHUNK), jnp.float32)
            for j in range(7):
                flip = flip + patbits[:, j, None] * (
                    iota_c == idxs_s[:, fl0 + j, None])
            if odd is not None:
                i0bit = (jnp.take(odd, src).astype(jnp.float32)
                         + jnp.take(jnp.asarray(SPAR7), pat))
                i0bit = i0bit - 2.0 * jnp.take(
                    odd, src).astype(jnp.float32) * jnp.take(
                    jnp.asarray(SPAR7), pat)           # XOR on {0,1}
                flip = flip + i0bit[:, None] * (
                    iota_c == idxs_s[:, 0, None])
            b2 = jnp.where(flip > 0.5, -b2, b2)
            return (zero_chunk, llr_scratch, b2, row[C_BDST],
                    zero_chunk, beta_scratch, refs[:, src],
                    _reset_row(brefs[:, src], row[C_SIDW],
                               row[C_LAST]), pm2)

        def op_spc(_):
            """Single-parity-check node.  Fast mode: parity-fix the
            hard decisions, then fork on exclusive pair flips {i0, ij}
            (Fast-SSC-List).  Exact mode: one-shot enumeration with the
            parity bit i0 forced per candidate subset (see _oneshot)."""
            a = rd_llr(row[C_SRC])
            valid = (jnp.arange(CHUNK) < row[C_WIDTH])[None, :]
            mag = jnp.where(valid, jnp.abs(a), big)
            b = jnp.where(a < 0, -1.0, 1.0) * valid
            odd = (jnp.sum(b < 0, axis=-1) % 2) == 1          # [L]
            if spc_exact:
                return _oneshot(b, mag, pm, odd, row)
            iota_c = jnp.arange(CHUNK)[None, :]
            vals_l, idxs_l = [], []
            mag_t = mag
            for _k in range(t_spc):
                v = jnp.min(mag_t, axis=-1)
                at = jnp.min(jnp.where(mag_t == v[:, None], iota_c,
                                       CHUNK), axis=-1)
                vals_l.append(v)
                idxs_l.append(at)
                mag_t = jnp.where(iota_c == at[:, None], big, mag_t)
            vals = jnp.stack(vals_l, axis=1)                  # [L, T]
            idxs = jnp.stack(idxs_l, axis=1)
            v0, i0 = vals[:, 0], idxs[:, 0]
            pm2 = pm + jnp.where(odd, v0, 0.0)
            b = jnp.where((iota_c == i0[:, None]) & odd[:, None],
                          -b, b)
            switched = jnp.zeros((L,), jnp.bool_)
            gperm = jnp.arange(L)
            for r in range(1, t_spc):
                delta = jnp.where(odd, vals[:, r] - v0,
                                  vals[:, r] + v0)
                delta = jnp.where(switched, big, delta)
                perm, flip, pm2 = _select_paths(
                    jnp.concatenate([pm2, pm2 + delta]), L)
                b = jnp.take(b, perm, axis=0)
                vals = jnp.take(vals, perm, axis=0)
                idxs = jnp.take(idxs, perm, axis=0)
                v0 = jnp.take(v0, perm)
                i0 = jnp.take(i0, perm)
                odd = jnp.take(odd, perm)
                switched = jnp.take(switched, perm)
                gperm = jnp.take(gperm, perm)
                pair = ((iota_c == i0[:, None]) |
                        (iota_c == idxs[:, r][:, None]))
                b = jnp.where(pair & flip[:, None], -b, b)
                switched = switched | flip
            return (zero_chunk, llr_scratch, b, row[C_BDST],
                    zero_chunk, beta_scratch, refs[:, gperm],
                    _reset_row(brefs[:, gperm], row[C_SIDW],
                               row[C_LAST]), pm2)

        (lval, loff, bval1, boff1, bval2, boff2, refs2, brefs2,
         pm2) = jax.lax.switch(
            row[C_OP], [op_f, op_g, op_combine, op_rate0, op_rep,
                        op_rate1, op_spc], None)

        # Unconditional big-buffer writes (aliasing-friendly).
        llr = jax.lax.dynamic_update_slice(llr, lval, (0, loff))
        beta = jax.lax.dynamic_update_slice(beta, bval1, (0, boff1))
        beta = jax.lax.dynamic_update_slice(beta, bval2, (0, boff2))
        return (llr, beta, refs2, brefs2, pm2), None

    ops_arr = jnp.asarray(sched.ops)

    def decode(llrs):
        llr0 = jnp.zeros((L, sched.sz_llr + CHUNK), jnp.float32)
        llr0 = llr0.at[:, :n].set(jnp.broadcast_to(llrs, (L, n)))
        # Derive every state leaf from the input so all lax.switch
        # branches agree on device-variance under shard_map.
        vzero = llrs[0] * 0.0
        beta0 = jnp.zeros((L, sched.sz_beta + CHUNK), jnp.float32) + vzero
        ident = jnp.arange(L, dtype=jnp.int32) + vzero.astype(jnp.int32)
        refs0 = jnp.broadcast_to(ident, (sched.n_depths, L))
        brefs0 = jnp.broadcast_to(ident, (2 * sched.n_depths, L))
        pm0 = jnp.full((L,), 0.0).at[1:].set(big / 2) + vzero
        state = (llr0, beta0, refs0, brefs0, pm0)
        (llr, beta, refs, brefs, pm), _ = jax.lax.scan(step, state,
                                                       ops_arr)
        out = jax.lax.dynamic_slice(beta, (0, sched.out_off), (L, n))
        codeword = (out < 0).astype(jnp.uint8)
        return codeword, pm

    return decode


@functools.lru_cache(maxsize=None)
def cached_jit_decoder(frozen_key: bytes, list_size: int = 8,
                       exact: bool = True,
                       decompose_spc: bool = False):
    """Process-wide JITTED single-frame decoder cache.

    make_decoder returns a fresh closure per call, so jax's jit cache
    never hits across Decoder instances — on XLA-CPU each wire-size VM
    compile costs minutes, and a test suite constructing ~10 Decoders
    paid it ~10 times.  Key = the frozen mask bytes + the semantic
    flags (exactly build_schedule's cache key plus the leaf rules).
    """
    import jax
    frozen = np.frombuffer(frozen_key, dtype=np.uint8)
    return jax.jit(make_decoder(frozen, list_size, exact,
                                decompose_spc))
