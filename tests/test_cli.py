"""CLI argv surface: validation errors, freezer output, full loopback.

The CLI mirrors the reference binaries exactly (encode.cc:340,
decode.cc:562); validation messages and exit codes are part of that
parity.
"""

import numpy as np
import pytest

from modem.cli import main


def test_encode_validation_errors(tmp_path, capsys):
    inp = tmp_path / "in.dat"
    inp.write_bytes(bytes(5380))
    out = str(tmp_path / "o.wav")
    # unsupported mode (encode.cc:353-356)
    assert main(["encode", out, "8000", "16", "1", "2000", "5",
                 "N0CALL", str(inp)]) == 1
    assert "operation mode" in capsys.readouterr().err
    # bad callsign characters (encode.cc:357-361)
    assert main(["encode", out, "8000", "16", "1", "2000", "6",
                 "a!b", str(inp)]) == 1
    assert "call sign" in capsys.readouterr().err
    # unsupported rate (encode.cc:424-440)
    assert main(["encode", out, "11025", "16", "1", "2000", "6",
                 "N0CALL", str(inp)]) == 1
    assert capsys.readouterr().err == "Unsupported sample rate.\n"
    # frequency offset not in band (encode.cc:389-397); exact text +
    # check order parity: the band/mono condition fires FIRST, then %50
    assert main(["encode", out, "8000", "16", "1", "100", "6",
                 "N0CALL", str(inp)]) == 1
    assert capsys.readouterr().err == "Unsupported frequency offset.\n"
    # 2675 is both past the band edge (>2650 for mode 6 @ 8 kHz) and
    # not divisible by 50: the reference prints the band error
    assert main(["encode", out, "8000", "16", "2", "2675", "6",
                 "N0CALL", str(inp)]) == 1
    assert capsys.readouterr().err == "Unsupported frequency offset.\n"
    # in band but not divisible by 50 (encode.cc:394-397)
    assert main(["encode", out, "8000", "16", "2", "2025", "6",
                 "N0CALL", str(inp)]) == 1
    assert capsys.readouterr().err == \
        "Frequency offset must be divisible by 50.\n"


def test_decode_rejects_bad_wav(tmp_path):
    bad = tmp_path / "x.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00JUNK")
    with pytest.raises(ValueError):
        main(["decode", str(tmp_path / "o.dat"), str(bad)])


def test_freezer_regenerates_tables(capsys):
    assert main(["freezer"]) == 0
    out = capsys.readouterr().out
    assert "frozen_64512_43072[2048]" in out
    assert "frozen_64800_43072[2048]" in out
    # spot-check against the shipped table
    from modem.fec.freezer import frozen_mask, mask_to_words
    words = mask_to_words(frozen_mask(64800, 43072, 16))
    assert f"0x{words[0]:x}," in out


def test_cli_loopback(tmp_path):
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    inp = tmp_path / "in.dat"
    inp.write_bytes(payload)
    wav = str(tmp_path / "t.wav")
    dec = tmp_path / "out.dat"
    assert main(["encode", wav, "8000", "16", "2", "2300", "10",
                 "AB1CDE", str(inp)]) == 0
    assert main(["decode", str(dec), wav]) == 0
    assert dec.read_bytes() == payload


def test_cli_decode_all_two_frames(tmp_path):
    rng = np.random.default_rng(21)
    p1 = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    p2 = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    f1, f2 = tmp_path / "a.dat", tmp_path / "b.dat"
    f1.write_bytes(p1)
    f2.write_bytes(p2)
    wavf = str(tmp_path / "two.wav")
    assert main(["encode", wavf, "8000", "16", "2", "2300", "10",
                 "AB1CDE", str(f1), str(f2)]) == 0
    prefix = str(tmp_path / "out")
    assert main(["decode-all", prefix, wavf]) == 0
    assert (tmp_path / "out.000").read_bytes() == p1
    assert (tmp_path / "out.001").read_bytes() == p2

def test_cli_impair_tools_match_library(tmp_path):
    """Each simulation-chain subcommand (multipath/cfo/sfo/awgn —
    README.md:42-49's disorders pipeline) must apply exactly the
    channel.py impairment to the WAV samples, up to requantization."""
    from modem import channel, wav

    rng = np.random.default_rng(3)
    x = (0.4 * rng.standard_normal(4000)
         + 0.4j * rng.standard_normal(4000)).astype(np.complex64)
    src = str(tmp_path / "src.wav")
    wav.write_wav(src, x, 8000, 16, 2)
    got = wav.read_wav(src)
    xq = got.samples[:, 0] + 1j * got.samples[:, 1]
    q = 2.0 / 65535  # one 16-bit LSB

    def run(args, expect):
        out = str(tmp_path / "out.wav")
        assert main([args[0], out, src] + args[1:]) == 0
        back = wav.read_wav(out)
        y = back.samples[:, 0] + 1j * back.samples[:, 1]
        n = min(len(y), len(expect))
        clipped = np.clip(expect[:n].real, -1, 1) + 1j * np.clip(
            expect[:n].imag, -1, 1)
        assert np.abs(y[:n] - clipped).max() < 2 * q

    run(["cfo", "234.567"], channel.cfo(xq, 234.567, 8000))
    run(["sfo", "147"], channel.sfo(xq, 147.0))
    run(["awgn", "-30", "7"],
        channel.awgn(xq, -30.0, np.random.default_rng(7)))
    run(["multipath", "-", "10"],
        channel.multipath(xq, spread=10))

    # file-driven taps (the disorders tool's profile format)
    taps = tmp_path / "taps.txt"
    taps.write_text("0 1.0 0.0\n3 -0.4 0.25\n")
    run(["multipath", str(taps), "2"],
        channel.multipath(xq, ((0, 1.0), (3, -0.4 + 0.25j)), spread=2))


def test_cli_simulation_chain_loopback(tmp_path):
    """The reference README's full documented workflow (README.md:42-49)
    run entirely through this framework's CLI: encode | multipath x10 |
    cfo 234.567 | sfo 147 | awgn -30 | decode, byte-exact."""
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    inp = tmp_path / "in.dat"
    inp.write_bytes(payload)
    w = [str(tmp_path / f"s{i}.wav") for i in range(5)]
    dec = tmp_path / "out.dat"
    assert main(["encode", w[0], "8000", "16", "2", "2000", "6",
                 "N0CALL", str(inp)]) == 0
    assert main(["multipath", w[1], w[0], "-", "10"]) == 0
    assert main(["cfo", w[2], w[1], "234.567"]) == 0
    assert main(["sfo", w[3], w[2], "147"]) == 0
    assert main(["awgn", w[4], w[3], "-30"]) == 0
    assert main(["decode", str(dec), w[4]]) == 0
    assert dec.read_bytes() == payload

def test_cli_impair_mono_semantics(tmp_path):
    """Mono WAVs: cfo shifts the ANALYTIC signal (not ring
    modulation), awgn adds real noise at the stated total power."""
    from modem import channel, wav

    rng = np.random.default_rng(4)
    x = (0.3 * rng.standard_normal(4000)).astype(np.float32)
    src = str(tmp_path / "m.wav")
    wav.write_wav(src, x.astype(np.complex64), 8000, 16, 1)
    xq = wav.read_wav(src).samples[:, 0].astype(np.float64)
    out = str(tmp_path / "o.wav")
    q = 2.0 / 65535

    from modem.cli import main
    assert main(["cfo", out, src, "500"]) == 0
    y = wav.read_wav(out).samples[:, 0].astype(np.float64)
    want = channel.cfo(channel.analytic_np(xq), 500.0, 8000).real
    n = len(y)
    assert np.abs(y - np.clip(want[:n], -1, 1)).max() < 2 * q

    assert main(["awgn", out, src, "-20", "3"]) == 0
    y = wav.read_wav(out).samples[:, 0].astype(np.float64)
    noise = y - np.clip(xq, -1, 1)
    power_db = 10 * np.log10(np.mean(noise**2))
    assert abs(power_db - (-20.0)) < 0.5     # full stated power


def test_encode_missing_input_silently_encodes_ff(tmp_path):
    """Reference parity quirk (encode.cc:410-413): the open-failure
    branch tests ifstream::bad(), which a failed open does NOT set —
    the reference prints nothing and encodes an 0xFF-filled payload."""
    from modem.cli import _read_input
    from modem.numerology import DATA_BYTES
    import io, contextlib

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        data = _read_input(str(tmp_path / "no_such_file.dat"),
                           single=True)
    assert data == b"\xff" * DATA_BYTES
    assert err.getvalue() == ""
