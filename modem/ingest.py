"""Device-side PCM ingest: quantised WAV samples -> analytic signal.

The reference reads PCM WAV (int16/uint8 on the wire, wav.hh) and
converts per sample on the host (decode.cc:294-301: dequantise, then
BlockDC + Hilbert for mono input).  Here recordings go to the device
in their WIRE dtype — 2 bytes/sample mono int16 instead of 8
bytes/sample f32 split-complex, 4-8x fewer bytes over the host link —
and the
dequantise + DC-block + Hilbert front-end runs ON DEVICE inside the
same chunked graphs as the Schmidl-Cox scan (sync._extract_batch_fn),
so no whole-recording analytic array is ever materialised on the host
or transferred.

Chunk-exactness: a chunk carries ``front_lead`` extra raw samples of
left context (>= dc_window + taps, rounded to window_sum's 512-sample
block) so every DC mean and Hilbert dot covers exactly the same
addends as a whole-recording pass; chunk starts stay multiples of 512
so window_sum's block grouping is preserved.  The host-numpy spec
twin is :func:`analytic_np` (used by sync.scan(host=True), the path
the device extraction is parity-tested against).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from . import dsp

_BLK = 512          # window_sum block size (sync._BLK)


@dataclasses.dataclass
class PcmRecording:
    """Raw PCM samples in wire dtype (decode.cc:294-301 ingest).

    data: [T] mono or [T, 2] stereo; int16 (bits=16) or uint8 (bits=8).
    """
    data: np.ndarray
    bits: int
    rate: int

    def __post_init__(self):
        want = np.int16 if self.bits == 16 else np.uint8
        if self.bits not in (8, 16):
            raise ValueError(f"unsupported bit depth {self.bits}")
        if self.data.dtype != want:
            raise ValueError(
                f"bits={self.bits} requires dtype {want}, "
                f"got {self.data.dtype}")

    @property
    def channels(self) -> int:
        return 1 if self.data.ndim == 1 else self.data.shape[1]

    @property
    def n_samples(self) -> int:
        return self.data.shape[0]

    def dequant_np(self) -> np.ndarray:
        """Host dequantisation (wav._dequantize semantics)."""
        if self.bits == 8:
            return (self.data.astype(np.float32) - 128.0) / 127.0
        return self.data.astype(np.float32) / 32767.0

    def analytic_np(self, dc_window: int, taps: int) -> np.ndarray:
        """Host-numpy spec front-end -> [T, 2] f32 split-complex.

        Mono: dequantise -> DC block (sliding mean, f64 accumulation)
        -> FIR Hilbert with (taps-1)//2 real-path delay — the numpy
        twin of dsp.frontend.  Stereo: dequantise passthrough.
        """
        x = self.dequant_np()
        if self.channels == 2:
            return np.ascontiguousarray(x)
        x = x.reshape(-1)
        c = np.cumsum(np.concatenate([[0.0], x]).astype(np.float64))
        n = x.shape[0]
        idx = np.arange(n)
        lo = np.maximum(idx - dc_window + 1, 0)
        cnt = np.minimum(idx + 1, dc_window)
        y = (x - (c[idx + 1] - c[lo]) / cnt).astype(np.float32)
        h = dsp.hilbert_taps(taps)
        d = (taps - 1) // 2
        yp = np.concatenate([np.zeros(taps - 1, np.float32), y])
        im = np.convolve(yp, h, mode="valid")[:n].astype(np.float32)
        re = np.concatenate([np.zeros(d, np.float32), y])[:n]
        return np.stack([re, im], axis=-1)


def front_lead(dc_window: int, taps: int) -> int:
    """Raw left-context samples a mono chunk needs ahead of its first
    analytic output, rounded up to the window_sum block so chunk
    starts keep absolute 512-block alignment."""
    return -(-(dc_window + taps) // _BLK) * _BLK


def dequant_dev(raw, bits: int):
    """Device dequantisation matching wav._dequantize bit-for-bit."""
    if bits == 8:
        return (raw.astype(jnp.float32) - 128.0) / 127.0
    return raw.astype(jnp.float32) / 32767.0


def analytic_chunk(raw, abs0, lead: int, out_len: int, bits: int,
                   dc_window: int, taps: int):
    """Mono PCM chunk -> analytic [out_len, 2] on device.

    raw: [lead + out_len (+ tail)] quantised samples whose first
    element sits at absolute recording index ``abs0`` (a multiple of
    512, possibly negative with the caller zero-padding the
    pre-recording span).  Output j corresponds to absolute index
    abs0 + lead + j.  ``abs0`` may be a traced scalar; ``lead`` must
    be >= max(dc window reach, taps - 1) and is static.

    DC-block counts clamp against the true recording start (the
    sliding mean over min(n+1, dc_window) samples, decode.cc:386
    semantics), so chunk outputs equal the whole-recording front-end
    to f32 reassociation tolerance.
    """
    from .sync import window_sum
    x = dequant_dev(raw, bits)
    s = window_sum(x, dc_window)
    absi = abs0 + jnp.arange(x.shape[0])
    cnt = jnp.clip(absi + 1, 1, dc_window).astype(jnp.float32)
    y = x - s / cnt
    h = jnp.asarray(dsp.hilbert_taps(taps))
    d = (taps - 1) // 2
    # im[n] = sum_k h[k] y[n-k]; convolve(y, h, valid)[j] covers
    # y[j .. j+taps-1], so output raw-index n maps to j = n-(taps-1)
    im = jnp.convolve(y, h, mode="valid")[lead - (taps - 1):
                                          lead - (taps - 1) + out_len]
    re = y[lead - d: lead - d + out_len]
    return jnp.stack([re, im], axis=-1)
