"""Schedule-composition analysis for the ML-leaf redesign (round 5).

Question: how much of the wire SCL schedule can generalized
maximum-likelihood (ML) constituent leaves remove?  An ML leaf decodes
a whole subtree in ONE op by enumerating all 2^k codewords of the
constituent code and taking the per-frame global top-L — exact
bit-by-bit-SCL equivalence holds when the node's info bits form a
SUFFIX of its u-order (frozen prefix): every mid-node prune point is
then followed only by free bits, so any pruned path is dominated by
each survivor's zero-cost extension (the §7b argument, generalized).
The min-sum path-metric identity pen(x) = sum_j |a_j|·[x_j != hard_j]
makes the candidate matrix ONE [P, w] x [w, 2^k] matmul.

This script walks the wire tree under (a) the current leaf rules and
(b) current + ML(w<=WMAX, info-suffix, 1<=k<=KMAX), and reports node
histograms and op counts per class after the leaf-fusion passes a
fused decoder would apply.  It counts operations only; what each op
class costs is a measurement on the card.
"""

import collections
import sys

import numpy as np

sys.path.insert(0, ".")
from modem.fec.polar import PolarCode  # noqa: E402
from modem.numerology import MODES  # noqa: E402

CHUNK = 512
CHUNK2 = 128
KMAX = 7


def classify(fz):
    w = len(fz)
    s = int(fz.sum())
    if s == w:
        return "RATE0"
    if s == 0:
        return "RATE1"
    if s == w - 1 and fz[-1] == 0:
        return "REP"
    if s == 1 and fz[0] == 1:
        return "SPC"
    return None


def is_suffix_info(fz):
    """Info positions form a suffix (frozen prefix)."""
    k = int((1 - fz).sum())
    return k > 0 and fz[: len(fz) - k].all()


def walk(frozen, ml=False, wmax=128, kmax=KMAX):
    """Count schedule ops per class, mimicking build_schedule's
    emission + leaf-fusion passes (REPSPC twins, leaf FL/GR
    absorption)."""
    n = len(frozen)
    counts = collections.Counter()
    ml_nodes = []

    def leaf_kind(lo, hi):
        fz = frozen[lo:hi]
        w = hi - lo
        kind = classify(fz) if w <= CHUNK else None
        if kind in ("RATE0", "RATE1", "REP", "SPC"):
            return kind
        if ml and w <= wmax and w <= CHUNK2:
            k = int((1 - fz).sum())
            if 1 <= k <= kmax and is_suffix_info(fz):
                ml_nodes.append((w, k, lo))
                return "ML"
        return None

    def rec(lo, hi, d, side):
        """Returns ('leaf', kind) if this node is a single leaf op
        (eligible for FL/GR absorption at the parent), else
        ('tree', None).  Appends this node's own op counts."""
        w = hi - lo
        kind = leaf_kind(lo, hi)
        tier2 = w <= CHUNK2
        if kind is not None:
            counts[(kind, w, "t2" if tier2 else "t1")] += max(
                1, -(-w // CHUNK))
            return ("leaf", kind) if tier2 else ("tree", None)
        h = w // 2
        ht2 = h <= CHUNK2
        # F
        fchunks = max(1, -(-h // CHUNK))
        lstat, lkind = rec(lo, lo + h, d + 1, 0)
        gchunks = fchunks
        rstat, rkind = rec(lo + h, hi, d + 1, 1)
        cchunks = fchunks
        if ht2 and lstat == "leaf" and rstat == "leaf" \
                and lkind == "REP" and rkind == "SPC":
            # REPSPC twin: F,REP,G,SPC,C -> 1
            counts[("REPSPC", w, "t2")] += 1
            counts[(lkind, h, "t2")] -= 1
            counts[(rkind, h, "t2")] -= 1
            return ("leaf", "REPSPC")
        if ht2 and lstat == "leaf":
            # F absorbed into left leaf: X -> X_FL
            counts[(lkind + "_FL", h, "t2")] += 1
            counts[(lkind, h, "t2")] -= 1
        else:
            counts[("F", h, "t2" if ht2 else "t1")] += fchunks
        if ht2 and rstat == "leaf":
            # G + C absorbed into right leaf: X -> X_GR
            counts[(rkind + "_GR", h, "t2")] += 1
            counts[(rkind, h, "t2")] -= 1
        else:
            counts[("G", h, "t2" if ht2 else "t1")] += gchunks
            counts[("C", h, "t2" if ht2 else "t1")] += cchunks
        return ("tree", None)

    rec(0, n, 0, 0)
    return counts, ml_nodes


def summarize(tag, counts):
    total = sum(v for v in counts.values() if v > 0)
    by_class = collections.Counter()
    for (kind, w, tier), c in counts.items():
        if c > 0:
            by_class[f"{kind}_{tier}"] += c
    print(f"-- {tag}: {total} ops")
    for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"   {k:14s} {v}")
    return total


def main():
    mode = MODES[6]
    code = PolarCode(n=mode.cons_bits, k=mode.crc_bits,
                     order=mode.code_order)
    frozen = np.asarray(code.frozen, dtype=np.uint8)
    print(f"wire code n={code.n} order={code.order} "
          f"frozen={int(frozen.sum())}")

    cur, _ = walk(frozen, ml=False)
    t0 = summarize("current rules", cur)

    for kmax in (5, 7):
        mlc, nodes = walk(frozen, ml=True, kmax=kmax)
        t1 = summarize(f"+ML leaves (k<={kmax})", mlc)
        hist = collections.Counter((w, k) for (w, k, _) in nodes)
        print(f"   ML nodes: {len(nodes)}; (w,k) histogram: "
              f"{dict(sorted(hist.items()))}")
        print(f"   delta: ops {t0}->{t1} ({100 * (t1 - t0) / t0:+.1f}%)")

    # how many current one-shot leaves are width-8 SPC (ML-table
    # eligible: k=7 -> exactly 128 codewords, no extraction needed)?
    spc_w = collections.Counter(
        w for (kind, w, tier), c in cur.items()
        if c > 0 and kind.startswith("SPC") for _ in range(c))
    print(f"SPC leaf width histogram: {dict(sorted(spc_w.items()))}")
    r1_w = collections.Counter(
        w for (kind, w, tier), c in cur.items()
        if c > 0 and kind.startswith("RATE1") for _ in range(c))
    print(f"RATE1 leaf width histogram: {dict(sorted(r1_w.items()))}")
    rep_w = collections.Counter(
        w for (kind, w, tier), c in cur.items()
        if c > 0 and kind.startswith("REP") and "SPC" not in kind
        for _ in range(c))
    print(f"REP leaf width histogram: {dict(sorted(rep_w.items()))}")
    repspc_w = collections.Counter(
        w for (kind, w, tier), c in cur.items()
        if c > 0 and kind.startswith("REPSPC") for _ in range(c))
    print(f"REPSPC width histogram: {dict(sorted(repspc_w.items()))}")


if __name__ == "__main__":
    main()
