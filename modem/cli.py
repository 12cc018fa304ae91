"""Reference-compatible command line interface.

Mirrors the reference binaries' argv exactly (encode.cc:340,
decode.cc:562):

  python -m modem.cli encode OUTPUT RATE BITS CHANNELS OFFSET MODE \
      CALLSIGN INPUT..
  python -m modem.cli decode OUTPUT INPUT [SKIP]

'-' means stdin/stdout for the data files, as in the reference
(encode.cc:345-346,408-409; decode.cc:570-574).  Validation rules and
diagnostics match the reference's stderr output where observable.

Beyond the reference binaries, `decode-all` batch-decodes every frame
of a recording, `freezer` regenerates the polar tables
(freezer.cc:34-39), and `multipath|cfo|sfo|awgn` reproduce the
external aicodix/disorders simulation-chain tools the reference README
pipes through (README.md:42-49) so the full documented workflow runs
inside this framework.
"""

from __future__ import annotations

import sys

import numpy as np

from . import bits as B
from . import wav
from .numerology import DATA_BYTES, MAX_CALL_SIGN, make_config


def _read_input(name: str, single: bool) -> bytes:
    # '-' means stdin ONLY for a single input file (encode.cc:408-409:
    # `argc == 9 && input_name[0] == '-'`); with multiple inputs it is
    # a literal file name.
    if name == "-" and single:
        data = sys.stdin.buffer.read(DATA_BYTES)
    else:
        try:
            f = open(name, "rb")
        except OSError:
            # Reference parity quirk (encode.cc:410-413): the error
            # branch tests ifstream::bad(), which a FAILED OPEN does
            # not set (that sets failbit) — so the reference prints
            # nothing and silently encodes an 0xFF-filled payload
            # (every get() returns EOF).  Match that, quirk and all.
            return b"\xff" * DATA_BYTES
        with f:
            data = f.read(DATA_BYTES)
    return data.ljust(DATA_BYTES, b"\xff")  # ifstream.get() past EOF


def cmd_encode(argv: list[str]) -> int:
    if len(argv) < 8:
        print("usage: encode OUTPUT RATE BITS CHANNELS OFFSET MODE "
              "CALLSIGN INPUT..", file=sys.stderr)
        return 1
    output_name, rate, out_bits, channels = (
        argv[0], int(argv[1]), int(argv[2]), int(argv[3]))
    freq_off, oper_mode, call_str = int(argv[4]), int(argv[5]), argv[6]
    inputs = argv[7:]

    if out_bits not in (8, 16):
        print("Unsupported bits per sample.", file=sys.stderr)
        return 1
    if channels not in (1, 2):
        print("Only real or analytic signal (one or two channels) "
              "supported.", file=sys.stderr)
        return 1
    if oper_mode < 6 or oper_mode > 13:
        print("Unsupported operation mode.", file=sys.stderr)
        return 1
    call_sign = B.base37_encode(call_str)
    if call_sign <= 0 or call_sign >= MAX_CALL_SIGN:
        print("Unsupported call sign.", file=sys.stderr)
        return 1
    try:
        cfg = make_config(rate, oper_mode, freq_off, channels)
    except ValueError as e:
        print(f"{e}.".replace("..", "."), file=sys.stderr)
        return 1

    from .encoder import cached_encoder
    payloads = [_read_input(name, len(inputs) == 1) for name in inputs]
    enc = cached_encoder(cfg)
    wave_c, papr = enc.encode(payloads, call_sign)

    def db(x):
        return 10.0 * np.log10(x)

    valid = papr[:, 0] > 0
    print(f"real PAPR: {db(papr[valid, 0].min()):.4g} .. "
          f"{db(papr[valid, 0].max()):.4g} dB", file=sys.stderr)
    if channels == 2:
        validq = papr[:, 1] > 0
        print(f"imag PAPR: {db(papr[validq, 1].min()):.4g} .. "
              f"{db(papr[validq, 1].max()):.4g} dB", file=sys.stderr)

    silence = np.zeros(rate, dtype=np.complex64)
    full = np.concatenate([silence, wave_c, silence])
    if output_name == "-":
        output_name = "/dev/stdout"
    wav.write_wav(output_name, full, rate, out_bits, channels)
    return 0


def cmd_decode(argv: list[str]) -> int:
    if len(argv) < 2 or len(argv) > 3:
        print("usage: decode OUTPUT INPUT [SKIP]", file=sys.stderr)
        return 1
    output_name, input_name = argv[0], argv[1]
    skip = int(argv[2]) if len(argv) > 2 else 0
    if input_name == "-":
        input_name = "/dev/stdin"

    data = wav.read_wav(input_name)
    if data.channels < 1 or data.channels > 2:
        print("Only real or analytic signal (one or two channels) "
              "supported.", file=sys.stderr)
        return 1
    from .decoder import cached_decoder
    try:
        dec = cached_decoder(data.rate)
    except ValueError:
        print("Unsupported sample rate.", file=sys.stderr)
        return 1

    samples = (data.samples[:, 0] if data.channels == 1
               else data.samples[:, :2])
    # the decoder emits the reference's stderr transcript itself
    # (per-attempt sync prints, header statuses, demod dots, sfo/cfo,
    # Es/N0, bit flips — decode.cc:400-555)
    res = dec.decode(samples, channels=data.channels, skip=skip,
                     log=sys.stderr)
    if not res.ok:
        # the decoder transcript already emitted most statuses in its
        # candidate loop; print only what it did not (the flag travels
        # WITH the status, so new decoder statuses stay covered)
        if not res.status_emitted:
            print(res.status, file=sys.stderr)
        return 1
    if output_name == "-":
        output_name = "/dev/stdout"
    try:
        f = open(output_name, "wb")
    except OSError:
        print(f'Couldn\'t open file "{output_name}" for writing.',
              file=sys.stderr)               # decode.cc:609-611
        return 1
    with f:
        f.write(res.payload)
    return 0


def cmd_decode_all(argv: list[str]) -> int:
    """Batched serving: decode EVERY frame in a recording, with
    per-frame mode/callsign auto-detection (beyond the reference's
    one-frame-per-run CLI; the library analog of running `decode` with
    every SKIP value, in one batched call per mode)."""
    adaptive = False
    if argv and argv[0] == "--adaptive":
        # serving fast path: SC decode per frame, exact SCL only on
        # CRC failure (pipeline.AdaptivePipeline); identical results on anything either decoder decodes
        adaptive = True
        argv = argv[1:]
    if len(argv) != 2:
        print("usage: decode-all [--adaptive] OUTPUT_PREFIX INPUT",
              file=sys.stderr)
        return 1
    prefix, input_name = argv
    if input_name == "-":
        input_name = "/dev/stdin"
    from .pipeline import decode_recording_auto
    # fast ingest: int16/uint8 WAV stays in wire dtype through the
    # host link with the front-end on device (ingest.py); pipes and
    # other formats fall back to the host float reader
    pcm = wav.read_wav_raw(input_name)
    if pcm is not None:
        frames = decode_recording_auto(pcm, pcm.rate,
                                       channels=pcm.channels,
                                       adaptive=adaptive)
    else:
        data = wav.read_wav(input_name)
        if data.channels < 1 or data.channels > 2:
            print("Only real or analytic signal (one or two channels) "
                  "supported.", file=sys.stderr)
            return 1
        samples = (data.samples[:, 0] if data.channels == 1
                   else data.samples[:, :2])
        frames = decode_recording_auto(samples, data.rate,
                                       channels=data.channels,
                                       adaptive=adaptive)
    if not frames:
        print("no frames found", file=sys.stderr)
        return 1
    bad = 0
    for i, f in enumerate(frames):
        bad += _emit_frame(prefix, i, f)
    return 1 if bad else 0


def _emit_frame(prefix: str, i: int, f: dict) -> int:
    """Report one auto-decoded frame on stderr (reference rejection
    texts, decode.cc:417-446) and write its payload file; returns 1
    if the frame failed."""
    if f["mode"] is None:
        # preamble whose header was rejected — report WHY
        print(f"frame {i}: pos {f['pos']} header rejected: "
              f"{f['status']}", file=sys.stderr)
        return 1
    print(f"frame {i}: pos {f['pos']} mode {f['mode']} "
          f"call sign {f['call_sign']} "
          f"{'ok' if f['ok'] else 'FAILED'} flips {f['flips']}",
          file=sys.stderr)
    if not f["ok"]:
        return 1
    with open(f"{prefix}.{i:03d}", "wb") as out:
        out.write(f["payload"])
    return 0


def cmd_decode_stream(argv: list[str]) -> int:
    """decode-stream OUTPUT_PREFIX [INPUT] — live decoding from a pipe.

    Reads a WAV stream incrementally (stdin by default: the reference's
    `arecord -f S16_LE | decode` workflow, decode.cc:294-301 reads one
    sample at a time) and emits each frame's payload file the moment
    its last payload sample arrives — no waiting for EOF.  Frames print
    to stderr as in decode-all."""
    if len(argv) < 1 or len(argv) > 2:
        print("usage: decode-stream OUTPUT_PREFIX [INPUT]",
              file=sys.stderr)
        return 1
    prefix = argv[0]
    input_name = argv[1] if len(argv) > 1 else "-"
    f = sys.stdin.buffer if input_name == "-" else open(input_name, "rb")

    def read_exact(n):
        buf = b""
        while len(buf) < n:
            got = f.read(n - len(buf))
            if not got:
                break
            buf += got
        return buf

    # incremental RIFF parse (wav.hh: PCM 8/16-bit LE, 1-2 channels)
    head = read_exact(12)
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        print("not a WAV stream", file=sys.stderr)
        return 1
    channels = rate = bits = audio_fmt = None
    while True:
        hdr = read_exact(8)
        if len(hdr) < 8:
            print("no data chunk in WAV stream", file=sys.stderr)
            return 1
        cid = hdr[:4]
        size = int.from_bytes(hdr[4:8], "little")
        if cid == b"fmt ":
            fmt = read_exact(size)
            audio_fmt = int.from_bytes(fmt[0:2], "little")
            channels = int.from_bytes(fmt[2:4], "little")
            rate = int.from_bytes(fmt[4:8], "little")
            bits = int.from_bytes(fmt[14:16], "little")
        elif cid == b"data":
            data_left = size
            break
        else:
            read_exact(size)
        if size % 2:            # RIFF chunks pad to even offsets
            read_exact(1)
    if audio_fmt != 1 or bits not in (8, 16):
        print("Only 8/16-bit integer PCM supported.", file=sys.stderr)
        return 1
    if channels not in (1, 2):
        print("Only real or analytic signal (one or two channels) "
              "supported.", file=sys.stderr)
        return 1
    from .stream import StreamDecoder
    try:
        sd = StreamDecoder(rate, channels=channels, bits=bits)
    except ValueError:
        print("Unsupported sample rate.", file=sys.stderr)
        return 1

    dt = np.dtype("<i2") if bits == 16 else np.uint8
    block = channels * dt.itemsize
    n_done = 0
    bad = 0
    rem = b""

    def emit(frames):
        nonlocal n_done, bad
        for fr in frames:
            bad += _emit_frame(prefix, n_done, fr)
            n_done += 1

    # honor the declared data size so trailing RIFF chunks (LIST/INFO
    # metadata) are not parsed as PCM; 0 / 0xFFFFFFFF are streaming
    # sentinels (size unknown at header-write time: read to EOF)
    if data_left in (0, 0xFFFFFFFF):
        data_left = None
    # live pipes read ~1 s per feed (pacing comes from the source);
    # seekable files replay in ~16 s blocks so the stream's scan runs
    # its vmapped multi-chunk super-batches (StreamDecoder
    # MAX_CHUNKS_PER_FEED) instead of one dispatch per chunk
    try:
        seekable = f.seekable()
    except Exception:
        seekable = False
    feed_seconds = 16 if seekable else 1
    while data_left is None or data_left > 0:
        want = rate * block * feed_seconds
        if data_left is not None:
            want = min(want, data_left)
        got = f.read(want)
        if data_left is not None:
            data_left -= len(got)
        raw = rem + got
        if not raw:
            break
        keep = len(raw) - len(raw) % block
        rem = raw[keep:]
        if not keep:
            break
        flat = np.frombuffer(raw[:keep], dtype=dt)
        samples = (flat if channels == 1
                   else flat.reshape(-1, 2))
        emit(sd.feed(samples))
    emit(sd.finish())
    if input_name != "-":
        f.close()
    if n_done == 0:
        print("no frames found", file=sys.stderr)
        return 1
    return 1 if bad else 0


def _impair_read(input_name: str):
    """Read a WAV for the impairment tools: complex view + metadata."""
    if input_name == "-":
        input_name = "/dev/stdin"
    data = wav.read_wav(input_name)
    if data.channels == 2:
        x = (data.samples[:, 0] + 1j * data.samples[:, 1]).astype(
            np.complex128)
    else:
        x = data.samples[:, 0].astype(np.complex128)
    return data, x


def _impair_write(output_name: str, data, y: np.ndarray) -> int:
    if output_name == "-":
        output_name = "/dev/stdout"
    wav.write_wav(output_name, y.astype(np.complex64), data.rate,
                  data.bits, data.channels)
    return 0


def _parse_taps(path: str):
    """Tap profile file: one `delay gain_re [gain_im]` per line
    (the disorders multipath tool's file-driven taps; README.md:49).
    '-' or missing selects the built-in assumed demo profile."""
    from . import channel
    if path in (None, "-"):
        return channel.DEFAULT_MULTIPATH
    taps = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            d = int(parts[0])
            re = float(parts[1])
            im = float(parts[2]) if len(parts) > 2 else 0.0
            taps.append((d, re + 1j * im))
    if not taps:
        raise SystemExit("empty tap profile")
    return tuple(taps)


def cmd_multipath(argv: list[str]) -> int:
    """multipath OUTPUT INPUT [TAPS [FACTOR]] — complex FIR at
    (delay x FACTOR)-sample offsets (the reference simulation chain's
    `multipath - - <taps> 10`, README.md:42-49)."""
    if len(argv) < 2 or len(argv) > 4:
        print("usage: multipath OUTPUT INPUT [TAPS [FACTOR]]",
              file=sys.stderr)
        return 1
    from . import channel
    taps = _parse_taps(argv[2] if len(argv) > 2 else None)
    factor = int(argv[3]) if len(argv) > 3 else 1
    data, x = _impair_read(argv[1])
    return _impair_write(argv[0], data,
                         channel.multipath(x, taps, spread=factor))


def cmd_cfo(argv: list[str]) -> int:
    """cfo OUTPUT INPUT FREQ — carrier frequency offset in Hz
    (`cfo - - 234.567`, README.md:49)."""
    if len(argv) != 3:
        print("usage: cfo OUTPUT INPUT FREQ", file=sys.stderr)
        return 1
    from . import channel
    data, x = _impair_read(argv[1])
    if data.channels == 1:
        # a frequency shift of a real passband signal acts on its
        # ANALYTIC signal (shifting the real samples directly would be
        # ring modulation: x*cos(wn) = half signal + a mirror image)
        x = channel.analytic_np(x.real)
    y = channel.cfo(x, float(argv[2]), data.rate)
    if data.channels == 1:
        y = y.real.astype(np.complex128)
    return _impair_write(argv[0], data, y)


def cmd_sfo(argv: list[str]) -> int:
    """sfo OUTPUT INPUT PPM — sample-clock offset via windowed-sinc
    resampling (`sfo - - 147`, README.md:49)."""
    if len(argv) != 3:
        print("usage: sfo OUTPUT INPUT PPM", file=sys.stderr)
        return 1
    from . import channel
    data, x = _impair_read(argv[1])
    return _impair_write(argv[0], data, channel.sfo(x, float(argv[2])))


def cmd_awgn(argv: list[str]) -> int:
    """awgn OUTPUT INPUT DB [SEED] — additive white Gaussian noise at
    DB relative to full scale (`awgn - - -30`, README.md:49; the dB
    convention is channel.awgn's documented assumption)."""
    if len(argv) < 3 or len(argv) > 4:
        print("usage: awgn OUTPUT INPUT DB [SEED]", file=sys.stderr)
        return 1
    from . import channel
    rng = np.random.default_rng(int(argv[3]) if len(argv) > 3 else 0)
    data, x = _impair_read(argv[1])
    if data.channels == 1:
        # real channel: real noise at the stated power (projecting
        # complex noise would land 3 dB low vs channel.awgn's
        # documented total-power convention)
        sigma = 10.0 ** (float(argv[2]) / 20.0)
        y = x.real + sigma * rng.standard_normal(len(x))
        y = y.astype(np.complex128)
    else:
        y = channel.awgn(x, float(argv[2]), rng)
    return _impair_write(argv[0], data, y)


def cmd_freezer(argv: list[str]) -> int:
    """Regenerate the polar frozen-bit tables (freezer.cc:34-39)."""
    import math

    from .fec.freezer import frozen_mask, mask_to_words
    for n, k in ((64512, 43072), (64800, 43072)):
        erasure = (n - k) / n
        design = 10 * math.log10(-math.log(erasure))
        print(f"design SNR: {design}", file=sys.stderr)
        print(f"better SNR: {design + 1.59175}", file=sys.stderr)
        words = mask_to_words(frozen_mask(n, k, 16))
        body = ", ".join(f"0x{w:x}" for w in words)
        print(f"static const uint32_t frozen_{n}_{k}[{len(words)}] = "
              f"{{ {body}, }};")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: modem.cli {encode|decode|decode-all|"
              "decode-stream|freezer|multipath|cfo|sfo|awgn} ...",
              file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "encode":
        return cmd_encode(rest)
    if cmd == "decode":
        return cmd_decode(rest)
    if cmd == "decode-all":
        return cmd_decode_all(rest)
    if cmd == "decode-stream":
        return cmd_decode_stream(rest)
    if cmd == "freezer":
        return cmd_freezer(rest)
    if cmd == "multipath":
        return cmd_multipath(rest)
    if cmd == "cfo":
        return cmd_cfo(rest)
    if cmd == "sfo":
        return cmd_sfo(rest)
    if cmd == "awgn":
        return cmd_awgn(rest)
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
