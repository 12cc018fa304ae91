"""Channel impairments: multipath, CFO, SFO, AWGN.

Native replacement for the external aicodix/disorders simulation chain
(reference README.md:42-49: `multipath .. 10 | cfo - - 234.567 |
sfo - - 147 | awgn - - -30`), used by the robustness tests (SURVEY.md §4
check 3, BASELINE config 4).  Host-side numpy: impairments are test
fixtures, not a serving path.

Semantics:
  * multipath: FIR with complex taps at integer sample delays, from a
    "delay gain_re gain_im" profile (disorders' file-driven taps).
  * cfo(hz): multiply by e^{j 2 pi f t}.
  * sfo(ppm): resample by factor (1 + ppm*1e-6) via Kaiser-windowed
    sinc interpolation (a sound-card clock offset).
  * awgn(db): complex white Gaussian noise at `db` relative to
    full-scale 1.0 (the disorders tool's convention: -30 means noise
    power 10^(-3) per real dimension pair).
"""

from __future__ import annotations

import numpy as np

# A 4-tap profile standing in for the reference demo's file-driven
# taps (the actual aicodix/disorders example file is not mounted, so
# this is an ASSUMED shape).  The
# README.md:49 demo runs `multipath - - <file> 10` — a x10 DELAY
# SPREAD — so base delays are chosen such that x10 exercises 75% of
# the 160-sample guard at 8 kHz ({0, 20, 50, 120}).  Taps beyond the
# guard are structural ISI for this wire format (the reference's
# windowed-OFDM demod has the same geometry); the measured
# degradation envelope past the guard is bench/multipath_sweep.py's.
DEFAULT_MULTIPATH = (
    (0, 1.0 + 0.0j),
    (2, 0.5 + 0.2j),
    (5, -0.3 + 0.1j),
    (12, 0.2 - 0.15j),
)


def multipath(x: np.ndarray, taps=DEFAULT_MULTIPATH,
              spread: int = 1) -> np.ndarray:
    """Apply complex FIR taps at (delay * spread) sample offsets."""
    x = np.asarray(x, dtype=np.complex128)
    max_d = max(d for d, _ in taps) * spread
    out = np.zeros(len(x) + max_d, dtype=np.complex128)
    for delay, gain in taps:
        out[delay * spread: delay * spread + len(x)] += gain * x
    return out


def cfo(x: np.ndarray, hz: float, rate: int) -> np.ndarray:
    n = np.arange(len(x))
    return np.asarray(x) * np.exp(2j * np.pi * hz * n / rate)


def analytic_np(x: np.ndarray) -> np.ndarray:
    """Exact FFT analytic signal of a real vector (one-sided
    spectrum).  Host test fixture — the receiver's own causal FIR
    front-end lives in dsp.py/ingest.py; this is for impairing real
    recordings physically (a passband frequency shift acts on the
    analytic signal, cli.py cmd_cfo)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    spec = np.fft.fft(x)
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1: n // 2] = 2.0
    else:
        h[1: (n + 1) // 2] = 2.0
    return np.fft.ifft(spec * h)


def sfo(x: np.ndarray, ppm: float, taps: int = 32) -> np.ndarray:
    """Resample by 1 + ppm*1e-6 (receiver clock running fast/slow).

    Kaiser-windowed-sinc fractional-delay interpolation: the modem band
    reaches ~0.42 fs at 8 kHz, where linear interpolation alone injects
    ~10 dB of distortion (measured — it capped the whole decode chain at
    ~9 dB effective Es/N0, failing frames the real sound-card chain
    recovers).  A 32-tap sinc keeps interpolation error ~60 dB down.
    """
    factor = 1.0 + ppm * 1e-6
    x = np.asarray(x, dtype=np.complex128)
    t = np.arange(int(len(x) / factor)) * factor
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    half = taps // 2
    xp = np.pad(x, (half, half))
    beta = 8.6
    out = np.zeros(len(t), dtype=np.complex128)
    win_arg = lambda u: np.clip(1.0 - (u / half) ** 2, 0.0, None)
    for k in range(-half + 1, half + 1):
        u = frac - k
        w = np.sinc(u) * np.i0(beta * np.sqrt(win_arg(u))) / np.i0(beta)
        out += w * xp[i0 + k + half]
    return out


def awgn(x: np.ndarray, db: float, rng=None) -> np.ndarray:
    """Add complex Gaussian noise at `db` dB relative to full scale.

    Convention note (an ASSUMPTION about the unmounted disorders tool,
    not a verified spec): `db` is total complex noise power relative
    to full scale 1.0, split equally between I and Q (the /sqrt(2)).
    All sweeps in bench/ state their levels in this convention;
    absolute dB alignment with the reference demo's `awgn - - -30`
    cannot be cross-checked without the disorders tool."""
    rng = rng or np.random.default_rng(0)
    sigma = 10.0 ** (db / 20.0)
    noise = sigma * (rng.standard_normal(len(x)) +
                     1j * rng.standard_normal(len(x))) / np.sqrt(2)
    return np.asarray(x) + noise


def reference_chain(x: np.ndarray, rate: int, rng=None,
                    cfo_hz: float = 234.567, sfo_ppm: float = 147.0,
                    awgn_db: float = -30.0,
                    spread: int = 10) -> np.ndarray:
    """The README.md:49 impairment chain with its published parameters:
    `multipath - - <taps> 10 | cfo - - 234.567 | sfo - - 147 |
    awgn - - -30`.  spread=10 stretches DEFAULT_MULTIPATH's assumed
    4-tap shape to a 120-sample delay spread at 8 kHz = 75% of the
    160-sample guard (bench/multipath_sweep.py sweeps the envelope
    past the guard)."""
    y = multipath(x, spread=spread)
    y = cfo(y, cfo_hz, rate)
    y = sfo(y, sfo_ppm)
    return awgn(y, awgn_db, rng)
