"""WAV sample I/O (host side).

Equivalent of DSP::ReadWAV/WriteWAV (wav.hh; call sites encode.cc:422-441,
decode.cc:576-581): RIFF PCM, 8-bit unsigned or 16-bit signed
little-endian, 1 (real) or 2 (analytic I/Q) channels, silence padding.
Values are floats in [-1, 1]; complex samples write as (real, imag) pairs
when channels == 2 and keep only the real part for mono output
(encode.cc:127-128 stride-2 write).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


@dataclasses.dataclass
class WavData:
    rate: int
    channels: int
    bits: int
    samples: np.ndarray  # [frames, channels] float32 in [-1, 1]

    @property
    def analytic(self) -> np.ndarray:
        """Complex view: mono -> real signal, stereo -> I + jQ."""
        if self.channels == 1:
            return self.samples[:, 0].astype(np.complex64)
        return (self.samples[:, 0] + 1j * self.samples[:, 1]).astype(
            np.complex64)


def _quantize(samples: np.ndarray, bits: int) -> bytes:
    if bits == 8:
        q = np.clip(np.rint(samples * 127.0), -128, 127) + 128
        return q.astype(np.uint8).tobytes()
    if bits == 16:
        q = np.clip(np.rint(samples * 32767.0), -32768, 32767)
        return q.astype("<i2").tobytes()
    raise ValueError(f"unsupported bit depth {bits}")


def _dequantize(raw: bytes, bits: int) -> np.ndarray:
    if bits == 8:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 127.0
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    raise ValueError(f"unsupported bit depth {bits}")


def write_wav(path: str, samples: np.ndarray, rate: int, bits: int = 16,
              channels: int = 1) -> None:
    """samples: [frames] float/complex or [frames, channels] float.

    Uses the native C++ codec (native/modem_host.cc) when built — file
    IO, RIFF framing and quantisation all run without Python in the
    loop — with this numpy implementation as the fallback.
    """
    samples = np.asarray(samples)
    if np.iscomplexobj(samples):
        pair = np.stack([samples.real, samples.imag], axis=-1)
        samples = pair[:, :channels] if channels <= 2 else pair
    if samples.ndim == 1:
        samples = samples[:, None]
    if samples.shape[1] < channels:
        samples = np.repeat(samples, channels, axis=1)
    samples = samples[:, :channels].astype(np.float64)
    import os

    from . import native
    # native path only for regular files: pipes (-/stdout) stream
    # through the python writer
    if (not os.path.exists(path) or os.path.isfile(path)) and \
            native.wav_write(path, samples.astype(np.float32), rate,
                             channels, bits):
        return
    payload = _quantize(samples.reshape(-1), bits)
    block = channels * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload), b"WAVE",
        b"fmt ", 16, 1, channels, rate, rate * block, block, bits,
        b"data", len(payload))
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(payload)


def read_wav_raw(path: str):
    """Read a PCM WAV keeping samples in WIRE dtype (int16/uint8).

    Returns an ingest.PcmRecording so the decode path can transfer
    the raw samples to device and dequantise there (2-4x fewer bytes
    over the host link than f32; ingest.py).  Falls back to None for formats the
    raw path does not cover (callers then use read_wav)."""
    import os

    if not os.path.isfile(path):
        return None
    from .ingest import PcmRecording
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack("<I", blob[pos + 4:pos + 8])[0]
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt != 1:
        raise ValueError("only PCM WAV supported")
    if bits not in (8, 16) or channels not in (1, 2):
        return None
    dt = np.dtype("<i2") if bits == 16 else np.uint8
    flat = np.frombuffer(data, dtype=dt)
    frames = len(flat) // channels
    samples = flat[: frames * channels]
    if channels == 2:
        samples = samples.reshape(frames, 2)
    return PcmRecording(data=np.ascontiguousarray(samples), bits=bits,
                        rate=rate)


def read_wav(path: str) -> WavData:
    import os

    from . import native
    # the native reader seeks; stdin/pipes fall through to the
    # buffered python parser (probing would consume the stream)
    got = native.wav_read(path) if os.path.isfile(path) else None
    if got is not None:
        rate, channels, bits, flat = got
        frames = len(flat) // channels
        return WavData(rate=rate, channels=channels, bits=bits,
                       samples=flat[: frames * channels].reshape(
                           frames, channels))
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack("<I", blob[pos + 4:pos + 8])[0]
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt != 1:
        raise ValueError("only PCM WAV supported")
    flat = _dequantize(data, bits)
    frames = len(flat) // channels
    return WavData(rate=rate, channels=channels, bits=bits,
                   samples=flat[: frames * channels].reshape(frames,
                                                             channels))
