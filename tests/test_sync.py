"""Sync primitives: window sums, Schmitt trigger, metric shape.

window_sum is load-bearing: it replaced lax.reduce_window (whose
compile time grew with the window size) with a two-level block-matmul
scheme that must stay numerically drift-free.
"""

import numpy as np
import pytest

from modem.numerology import make_config
from modem.sync import Synchronizer, schmitt_falling, window_sum


@pytest.mark.parametrize("t", [500, 512, 1000, 4096, 88320])
@pytest.mark.parametrize("w", [21, 161, 512, 640, 1280, 2560])
def test_window_sum_matches_convolve(t, w):
    rng = np.random.default_rng(t * 7 + w)
    x = rng.normal(0, 1, t).astype(np.float32)
    got = np.asarray(window_sum(x, w))
    ref = np.convolve(x, np.ones(w), "full")[:t]
    assert np.abs(got - ref).max() < 2e-3


def test_window_sum_drift_free_on_long_positive_signal():
    """Error must stay bounded by the window, not the running total
    (the failure mode of a plain cumsum difference in f32)."""
    t, w = 400_000, 640
    x = (0.5 + 0.1 * np.sin(np.arange(t) * 0.01)).astype(np.float32)
    got = np.asarray(window_sum(x, w))
    ref = np.convolve(x.astype(np.float64), np.ones(w), "full")[:t]
    rel = np.abs(got[w:] - ref[w:]) / ref[w:]
    assert rel.max() < 1e-5


def test_schmitt_falling_edges():
    lo, hi = 2.0, 3.0
    timing = np.array([0, 1, 4, 2.5, 2.5, 1, 0, 5, 1, 4, 4, 0],
                      dtype=np.float32)
    state, falling = (np.asarray(v) for v in
                      schmitt_falling(timing, lo, hi))
    # state holds through the hysteresis band, drops below lo
    assert state.tolist() == [0, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1, 0]
    assert falling.tolist() == [0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1]


def test_metrics_shapes_and_peak_position():
    cfg = make_config(8000, 6, 2000)
    sync = Synchronizer(cfg)
    rng = np.random.default_rng(3)
    n = cfg.symbol_len
    # a half-symbol-repeated block embedded in noise peaks the metric
    t = 6 * n
    x = 0.01 * rng.normal(0, 1, (t, 2)).astype(np.float32)
    rep = rng.normal(0, 1, (n // 2, 2)).astype(np.float32)
    pos = 2 * n
    x[pos: pos + n // 2] += rep
    x[pos + n // 2: pos + n] += rep
    timing, phase = (np.asarray(v) for v in sync._metrics(x))
    assert timing.shape[0] == t - 2 * sync.L
    n_max = int(np.argmax(timing))
    # metrics index v corresponds to a symbol starting at v (payload
    # half at v + L); the repeated block starts at pos
    assert abs(n_max - pos) < cfg.guard_len


def test_chunked_scan():
    """The constant-device-memory chunked pass must reproduce the
    whole-recording metrics to f32-reassociation tolerance (XLA fuses
    the same arithmetic differently per input shape; the chunk/context
    alignment keeps the addend SETS identical) and the fine-stage
    candidates exactly.  SURVEY §5 long-signal analog."""
    from modem.parallel import toy_config, toy_recordings

    recs, _ = toy_recordings(1, seed=9)
    x = np.concatenate([np.asarray(recs[0])] * 6, axis=0)
    sync = Synchronizer(toy_config())
    tw, pw, sw, fw = sync.metrics_host(x)
    tc, pc, sc, fc = sync.metrics_host(x, chunk_samples=2048)
    # timing spans 0..match_len (threshold ~5.6); reassociation noise
    # is ~5e-6 absolute, irrelevant to the trigger
    assert np.allclose(tw, tc, rtol=1e-3, atol=1e-4)
    assert np.allclose(pw, pc, rtol=1e-3, atol=1e-4)
    assert (sw == sc).all() and (fw == fc).all()
    cw = sync.scan(x, max_candidates=8, host=True)
    cc = sync.scan(x, max_candidates=8, chunk_samples=2048)
    assert len(cw) == len(cc)
    for a, b in zip(cw, cc):
        assert (a.p0, a.ok) == (b.p0, b.ok)
        assert abs(a.cfo_rad - b.cfo_rad) < 1e-6
    assert sum(c.ok for c in cw) >= 5


def test_device_extraction_matches_host_scan():
    """The device-side segmented-argmax candidate extraction (O(k)
    host fetch) must reproduce the host-numpy edge walk exactly —
    including Schmitt-state and running-argmax carries across chunk
    boundaries that land mid-plateau, noise-induced spurious edges,
    and first-max tie semantics."""
    from modem.parallel import toy_config, toy_recordings

    recs, _ = toy_recordings(1, seed=3)
    one = np.asarray(recs[0])
    rng = np.random.default_rng(42)
    x = np.concatenate([one] * 5, axis=0)
    x = x + rng.normal(0, 0.02, x.shape).astype(np.float32)
    sync = Synchronizer(toy_config())
    host = sync.scan(x, max_candidates=8, host=True)
    assert sum(c.ok for c in host) >= 4
    # chunk sizes chosen so boundaries sweep across the S&C plateaus;
    # None = the default ladder (single CHUNK_SMALL chunk here); 64 is
    # below the context size and must clamp up, not corrupt (the
    # unclamped path sliced x with a negative start for chunk 1)
    for chunk in (64, 1024, 1536, 2048, 4096, None):
        dev = sync.scan(x, max_candidates=8, chunk_samples=chunk)
        assert len(dev) == len(host), chunk
        for a, b in zip(host, dev):
            assert (a.p0, a.ok) == (b.p0, b.ok), chunk
            assert abs(a.cfo_rad - b.cfo_rad) < 1e-6, chunk
            assert abs(a.frac_cfo - b.frac_cfo) < 1e-6, chunk


def test_scan_reaches_late_frames():
    """Regression: the candidate cap applies to GATED candidates, with
    a 4x margin of raw edges — later frames must stay reachable (the
    reference's acquisition loop re-arms indefinitely,
    decode.cc:390-448)."""
    from modem.parallel import toy_config, toy_recordings
    from modem.sync import Synchronizer

    recs, _ = toy_recordings(1, seed=6)
    one = np.asarray(recs[0])
    ten = np.concatenate([one] * 10, axis=0)
    sync = Synchronizer(toy_config())
    cands = [c for c in sync.scan(ten, max_candidates=10) if c.ok]
    assert len(cands) == 10
    few = [c for c in sync.scan(ten, max_candidates=3) if c.ok]
    assert len(few) == 3


def test_dense_edges_per_chunk_cap_equivalence():
    """The device extraction's PER-CHUNK edge cap (k = 4*max_candidates
    per chunk) cannot diverge from the host path's GLOBAL first-k walk:
    any edge among the global first k is, within its own chunk, also
    among that chunk's first k, so the per-chunk cap keeps a superset
    and the time-ordered global truncation yields the identical edge
    set.  Pinned with ~24 real+spurious edges packed into one chunk
    against a cap of 8 (resolves the round-2 advisor's divergence
    concern affirmatively)."""
    from modem.parallel import toy_config, toy_recordings
    from modem.sync import Synchronizer

    recs, _ = toy_recordings(1, seed=3)
    one = np.asarray(recs[0])
    x = np.concatenate([one] * 12, axis=0)     # ~24 edges, 75k samples
    sync = Synchronizer(toy_config())
    host = sync.scan(x, max_candidates=2, host=True)
    assert len(host) >= 2
    # two chunk sizes pin the invariant (it is size-independent by
    # the superset argument above): the smallest exercises many-chunk
    # truncation, 2^17 is the production default
    for chunk in (2048, 1 << 17):
        dev = sync.scan(x, max_candidates=2, chunk_samples=chunk)
        assert [(c.p0, c.ok) for c in dev] == \
            [(c.p0, c.ok) for c in host], chunk
