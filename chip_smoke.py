#!/usr/bin/env python
"""Drive the modem's main paths once on a GPU and check every result.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: sharded decode vs one card

Mode 6 at 8 kHz, the wire format at full size: 5,380-byte payloads, a
64,800-bit shortened polar code of order 16, 50 QPSK rows on
1,280-point symbols, batch 512.  Payloads are random from a fixed
seed.  Phases, in order (one card):

  1. device check: a GPU or nothing (exit non-zero before any phase);
  2. encode: Encoder.encode_batch on 512 distinct payloads, plus the
     frozen waveform fingerprint (tests/test_waveform_pin.py);
  3. serving decode: AdaptivePipeline(8000, 6) decode_batch_async +
     resolve on 4 distinct batches of 512 (the first compiles), every
     payload byte-exact, zero escalations;
  4. escalation: the exact list-8 fallback at batch 16, byte-exact;
  5. list decoder vs the plain reference: the card's L=8 batched VM
     against the single-frame VM on the CPU, on seeded noisy frames;
  6. CLI in-process: encode -> decode byte-identical, and decode-all
     of a 4-frame recording with mixed modes;
  7. timings: compile (set-up) times, steady-state frames/s, the VM's
     SC and SCL stage times, memory analysis and peak device memory.

Every phase raises on a wrong result; the last line of standard output
is one JSON object naming the device, printed only when every phase
passed.  One process drives the card; the CPU reference runs in the
same process on the CPU backend.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RATE, MODE, FREQ_OFF = 8000, 6, 2000
BATCH = 512
N_SETS = 4                  # set 0 compiles, sets 1-3 are timed
FALLBACK_BATCH = 16
CALL = "N0CALL"
SEED = 2024
SIL = RATE // 4             # silence either side of each recording
PARITY_FRAMES = 8
PARITY_SIGMA = 0.70    # the list-decoding sensitivity edge (bench/ab_scl.py)
PARITY_SEED = 1234
PM_RTOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(devices) -> None:
    """Stop unless JAX's first device is a GPU: no phase ever runs on
    the CPU in place of the card."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"{os.path.basename(sys.argv[0])}: needs a GPU, but JAX's "
            f"first device is on platform {d.platform!r} "
            f"({d.device_kind}); nothing was run")


def card_name_and_limit() -> str:
    """nvidia-smi's name and power limit of each card (a child process
    that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def _parity_codeword(code):
    rng = np.random.default_rng(PARITY_SEED)
    m = rng.integers(0, 2, code.mesg_bits, dtype=np.uint8)
    m[code.k:] = 0
    return code.encode_systematic_np(m), rng


def parity_llrs(code):
    """Seeded noisy wire-size LLR batch [PARITY_FRAMES, code_len]."""
    cw, rng = _parity_codeword(code)
    tx = 1.0 - 2.0 * code.shorten_np(cw).astype(np.float64)
    llrs = np.stack([
        code.lengthen_np(
            2.0 * (tx + PARITY_SIGMA * rng.standard_normal(code.n))
            / PARITY_SIGMA**2)
        for _ in range(PARITY_FRAMES)]).astype(np.float32)
    return llrs


def reference_lists(code, llrs):
    """The plain reference: the single-frame VM (fec/scl_vm.make_decoder,
    list 8, vmapped) on the CPU backend of this process."""
    import jax

    from modem.fec.scl_vm import make_decoder

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = jax.jit(jax.vmap(make_decoder(code.frozen, 8)))
        return tuple(np.asarray(v)
                     for v in ref(jax.device_put(llrs, cpu)))


def scl_parity(code, card, ref):
    """(ok, detail) for two list decodes (codewords [B, L, n], path
    metrics [B, L]) of parity_llrs: the same per-frame recovery of the
    true codeword, at least one frame recovered, and sorted path
    metrics within PM_RTOL.  Bitwise list equality is not required:
    the two backends sum the per-leaf penalties in different orders,
    and a last-bit metric difference at a near-tie fork can keep a
    different, equally good tail path."""
    cw, _ = _parity_codeword(code)
    cws_c, pm_c = card
    cws_r, pm_r = ref
    hits_c = (cws_c == cw).all(axis=2).any(axis=1)
    hits_r = (cws_r == cw).all(axis=2).any(axis=1)
    pm_ok = bool(np.allclose(np.sort(pm_r, axis=1), np.sort(pm_c, axis=1),
                             rtol=PM_RTOL))
    ok = bool((hits_c == hits_r).all()) and bool(hits_c.any()) and pm_ok
    rel = np.max(np.abs(np.sort(pm_c, axis=1) - np.sort(pm_r, axis=1))
                 / np.maximum(np.abs(np.sort(pm_r, axis=1)), 1e-30))
    detail = (f"{'ok' if ok else 'MISMATCH'}: recovered {hits_c.sum()}/"
              f"{len(hits_c)} on the card vs {hits_r.sum()}/{len(hits_r)} "
              f"reference; sorted path metrics max rel diff {rel:.2e} "
              f"(tolerance {PM_RTOL:g})")
    return ok, detail


def _sync(out):
    import jax
    return jax.block_until_ready(out)


def _payload_sets(n_sets: int, batch: int, nbytes: int):
    rng = np.random.default_rng(SEED)
    return [[rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
             for _ in range(batch)] for _ in range(n_sets)]


def _recordings(waves):
    """[B, T] complex waveforms -> device [B, SIL+T+SIL, 2] f32."""
    import jax.numpy as jnp
    from modem import cplx
    sil = np.zeros((waves.shape[0], SIL), np.complex64)
    return jnp.asarray(cplx.from_np(np.concatenate([sil, waves, sil],
                                                   axis=1)))


def phase_encode(batch: int, n_sets: int = N_SETS):
    """Batched encode of n_sets distinct payload sets; set 0 holds the
    waveform-pin payload at index 0 and is checked against the frozen
    fingerprint.  Returns (payload sets, waveforms, timings)."""
    from modem import bits as B
    from modem.encoder import Encoder
    from modem.numerology import make_config

    cfg = make_config(RATE, MODE, FREQ_OFF)
    enc = Encoder(cfg)
    sets = _payload_sets(n_sets, batch, cfg.mode.data_bytes)
    pin_payload = np.load(os.path.join(
        ROOT, "tests", "data", "waveform_pin_payload_seed.npy")).tobytes()
    sets[0][0] = pin_payload
    call = B.base37_encode(CALL)
    t0 = time.perf_counter()
    waves = [enc.encode_batch(sets[0], call)[0]]
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    waves += [enc.encode_batch(s, call)[0] for s in sets[1:]]
    steady_s = time.perf_counter() - t0
    max_lsb, frac = fingerprint_drift(waves[0][0])
    if max_lsb > 1 or frac >= 0.005:
        raise AssertionError(f"waveform fingerprint moved: max "
                             f"{max_lsb} LSB on {frac:.4%} of samples")
    log(f"encode: batch {batch} ok; fingerprint max {max_lsb} LSB on "
        f"{frac:.4%} of samples (limit 1 LSB on < 0.5%)")
    fps = batch * (n_sets - 1) / steady_s if n_sets > 1 else float("nan")
    return sets, waves, dict(encode_compile_s=compile_s, encode_fps=fps)


def fingerprint_drift(wave) -> tuple[int, float]:
    """(max LSB, fraction of samples that differ) of a complex mode-6
    waveform's decimated int16 fingerprint against the frozen one
    (tests/test_waveform_pin.py)."""
    pin = np.load(os.path.join(ROOT, "tests", "data",
                               "waveform_pin_mode6_galois.npy"))
    fp = np.stack([
        np.clip(np.rint(part * 32767.0), -32768, 32767).astype(
            np.int16)[::97] for part in (wave.real, wave.imag)])
    if fp.shape != pin.shape:
        raise AssertionError(f"fingerprint shape {fp.shape} != "
                             f"pin {pin.shape}")
    diff = np.abs(fp.astype(np.int32) - pin.astype(np.int32))
    return int(diff.max()), float((diff > 0).mean())


def _check_payloads(pipe, res, want, what: str) -> None:
    ok = np.asarray(res["ok"])
    bad = [i for i, p in enumerate(want)
           if not ok[i] or pipe.payload_bytes(res, i) != p]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} "
                             f"payloads wrong (first {bad[:8]})")


def phase_serving(sets, waves):
    """AdaptivePipeline on every set: set 0 compiles, the rest run as a
    pipelined serving loop.  Returns (pipe, device recordings,
    timings)."""
    from modem.pipeline import AdaptivePipeline

    batch = len(sets[0])
    pipe = AdaptivePipeline(RATE, MODE, fallback_batch=FALLBACK_BATCH)
    recs = [_recordings(w) for w in waves]
    _sync(recs)
    t0 = time.perf_counter()
    out = pipe.resolve(pipe.decode_batch_async(recs[0]))
    compile_s = time.perf_counter() - t0
    _check_payloads(pipe, out, sets[0], "serving decode, set 0")
    if pipe.last_fallbacks:
        raise AssertionError(f"{pipe.last_fallbacks} escalations on "
                             "clean set 0")
    t0 = time.perf_counter()
    outs, pending = [], None
    for r in recs[1:]:
        h = pipe.decode_batch_async(r)
        if pending is not None:
            outs.append((pipe.resolve(pending), pipe.last_fallbacks))
        pending = h
    outs.append((pipe.resolve(pending), pipe.last_fallbacks))
    steady_s = time.perf_counter() - t0
    for i, (res, fb) in enumerate(outs, start=1):
        _check_payloads(pipe, res, sets[i], f"serving decode, set {i}")
        if fb:
            raise AssertionError(f"{fb} escalations on clean set {i}")
    log(f"serving decode: {len(sets)} batches of {batch} byte-exact, "
        "0 escalations")
    fps = batch * len(outs) / steady_s
    return pipe, recs, dict(decode_compile_s=compile_s, decode_fps=fps)


def phase_escalation(pipe, recs, want):
    """The exact list-8 fallback on one batch's front-end at its real
    batch size, on two distinct groups of frames."""
    import jax.numpy as jnp

    batch = recs.shape[0]
    front_fn, _ = pipe.sc._staged_fns(batch)
    front = front_fn(recs)
    fb = pipe._fallback_fn()
    times = []
    for g in range(2):
        idx = (np.arange(FALLBACK_BATCH) + g * FALLBACK_BATCH) % batch
        t0 = time.perf_counter()
        res = pipe.scl.fetch(fb(front, jnp.asarray(idx, jnp.int32)))
        times.append(time.perf_counter() - t0)
        _check_payloads(pipe.scl, res, [want[i] for i in idx],
                        f"list-8 fallback, group {g}")
    log(f"escalation: list-8 fallback at batch {FALLBACK_BATCH} "
        "byte-exact on 2 groups")
    return dict(fallback_compile_s=times[0], fallback_call_s=times[1])


def phase_parity(pipe):
    """The card's L=8 batched VM against the single-frame VM on the
    CPU backend, on a seeded noisy wire-size batch (parity_llrs)."""
    import jax

    code = pipe.scl.code
    llrs = parity_llrs(code)
    card = jax.jit(pipe.scl._make_scl(PARITY_FRAMES))
    card_lists = tuple(np.asarray(v) for v in card(llrs))
    t0 = time.perf_counter()
    ref_lists = reference_lists(code, llrs)
    cpu_s = time.perf_counter() - t0
    ok, detail = scl_parity(code, card_lists, ref_lists)
    log(f"list-8 parity vs CPU single-frame VM ({PARITY_FRAMES} frames, "
        f"sigma {PARITY_SIGMA}, f32 VM, exact gather lane moves): {detail} "
        f"[CPU reference {cpu_s:.1f} s]")
    if not ok:
        raise AssertionError("list-8 parity failed: " + detail)


def phase_cli(tmp: str):
    """cli.main in-process: encode -> decode byte-identical, and
    decode-all of a 4-frame recording with modes 6 and 10."""
    from modem import bits as B
    from modem import cli, wav
    from modem.encoder import Encoder
    from modem.numerology import make_config

    rng = np.random.default_rng(SEED + 1)
    data = rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
    src = os.path.join(tmp, "in.dat")
    with open(src, "wb") as f:
        f.write(data)
    enc_wav, out = os.path.join(tmp, "enc.wav"), os.path.join(tmp, "out.dat")
    rc = cli.main(["encode", enc_wav, str(RATE), "16", "1",
                   str(FREQ_OFF), str(MODE), CALL, src])
    if rc != 0:
        raise AssertionError(f"cli encode exited {rc}")
    rc = cli.main(["decode", out, enc_wav])
    with open(out, "rb") as f:
        got = f.read() if rc == 0 else b""
    if got != data:
        raise AssertionError(f"cli decode exited {rc}, output "
                             f"{'differs' if rc == 0 else 'missing'}")

    call = B.base37_encode(CALL)
    parts, want = [np.zeros(RATE, np.complex64)], []
    for mode in (6, 10, 6, 10):
        cfg = make_config(RATE, mode, FREQ_OFF)
        p = rng.integers(0, 256, cfg.mode.data_bytes,
                         dtype=np.uint8).tobytes()
        wave, _ = Encoder(cfg).encode(p, call)
        parts += [wave, np.zeros(RATE // 2, np.complex64)]
        want.append(p)
    rec = os.path.join(tmp, "mixed.wav")
    wav.write_wav(rec, np.concatenate(parts), RATE, 16, 2)
    prefix = os.path.join(tmp, "frame")
    rc = cli.main(["decode-all", prefix, rec])
    if rc != 0:
        raise AssertionError(f"cli decode-all exited {rc}")
    for i, p in enumerate(want):
        with open(f"{prefix}.{i:03d}", "rb") as f:
            if f.read() != p:
                raise AssertionError(f"decode-all frame {i} differs")
    log("cli: encode -> decode byte-identical; decode-all decoded "
        "4 of 4 frames (modes 6, 10, 6, 10)")


def time_scl(pipe, list_size: int, batch: int, reps: int = 3):
    """(compile+first s, best steady s) of the batched VM alone at one
    (list size, batch): distinct inputs each rep, synced on the
    device."""
    import jax
    import jax.numpy as jnp

    p = pipe.sc if list_size == 1 else pipe.scl
    base = parity_llrs(p.code)[:1]
    sets = [jnp.asarray(np.repeat(base, batch, 0) * k)
            for k in (1.0, 1.01, 0.99, 1.02)]
    fn = jax.jit(p._make_scl(batch))
    t0 = time.perf_counter()
    _sync(fn(sets[0]))
    first = time.perf_counter() - t0
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        _sync(fn(sets[1 + i % 3]))
        best = min(best, time.perf_counter() - t0)
    return first, best


def memory_report(pipe, recs) -> str:
    """compiled.memory_analysis() of the serving step's two jits."""
    front_fn, back_fn = pipe.sc._staged_fns(recs.shape[0])
    lines = []
    for name, fn, arg in (("front-end", front_fn, recs),
                          ("SC + CRC select", back_fn, None)):
        if arg is None:
            arg = front_fn(recs)
        m = fn.lower(arg).compile().memory_analysis()
        lines.append(
            f"{name}: args {m.argument_size_in_bytes} B, outputs "
            f"{m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
            f"code {m.generated_code_size_in_bytes} B")
    return "; ".join(lines)


def run_one_card(card: str) -> None:
    import jax

    from modem import native

    log(f"native host library loaded: {native.available()}")
    t = {}
    sets, waves, tt = phase_encode(BATCH)
    t.update(tt)
    pipe, recs, tt = phase_serving(sets, waves)
    t.update(tt)
    t.update(phase_escalation(pipe, recs[0], sets[0]))
    phase_parity(pipe)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(tmp)

    log(f"# timings on {card}:")
    log(f"set-up: encode compile+first {t['encode_compile_s']:.2f} s, "
        f"serving decode compile+first {t['decode_compile_s']:.2f} s, "
        f"list-8 fallback compile+first {t['fallback_compile_s']:.2f} s")
    log(f"steady: encode {t['encode_fps']:.1f} frames/s, serving decode "
        f"{t['decode_fps']:.1f} frames/s (batch {BATCH}, "
        f"{N_SETS - 1} distinct batches), list-8 fallback call "
        f"{t['fallback_call_s'] * 1e3:.1f} ms / {FALLBACK_BATCH} frames")
    for L, b in ((1, BATCH), (8, FALLBACK_BATCH), (8, BATCH)):
        first, best = time_scl(pipe, L, b)
        log(f"VM stage L={L} batch {b} (W={L * b}): {best * 1e3:.1f} ms "
            f"per call = {best / b * 1e3:.3f} ms/frame "
            f"(compile+first {first:.1f} s)")
    log("memory analysis: " + memory_report(pipe, recs[0]))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def run_four_cards(card: str, per_card: int = 64) -> None:
    """parallel.sharded_decode_batched on a 4-card 'dp' mesh, per_card
    frames per card, against the same frames on one card."""
    import jax

    from modem.parallel import make_mesh, sharded_decode_batched
    from modem.pipeline import BatchPipeline

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX found "
                         f"{len(jax.devices())}")
    n = 4 * per_card
    # encode at the one-card phase's batch shape (its compile is cached)
    sets, waves, _ = phase_encode(max(BATCH, n), n_sets=1)
    want = sets[0][:n]
    recs = _recordings(waves[0][:n])
    rescaled = _sync(recs * 1.0001)
    pipe = BatchPipeline(RATE, MODE)
    mesh = make_mesh(4)
    sharded = sharded_decode_batched(pipe, mesh, per_chip=per_card)
    res = {}
    for name, fn in (("4 cards", sharded), ("1 card", pipe._batched_fn(n))):
        t0 = time.perf_counter()
        out = {k: np.asarray(v) for k, v in fn(recs).items()}
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out2 = {k: np.asarray(v) for k, v in fn(rescaled).items()}
        steady = time.perf_counter() - t0
        _check_payloads(pipe, out, want, name)
        _check_payloads(pipe, out2, want, name + " (rescaled input)")
        res[name] = out
        log(f"{name}: {n} frames byte-exact; compile+first "
            f"{first:.1f} s, steady {steady * 1e3:.1f} ms = "
            f"{n / steady:.1f} frames/s on {card}")
    if not np.array_equal(res["4 cards"]["bits"], res["1 card"]["bits"]):
        raise AssertionError("sharded and one-card payload bits differ")
    log(f"4-card sharded decode == 1-card decode on all {n} frames")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded decode and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    import jax

    import modem  # noqa: F401  (sets the compile cache before compiling)

    devices = jax.devices()
    require_gpu(devices)
    d = devices[0]
    card = card_name_and_limit()
    log(f"device: {d.platform} {d.device_kind} x{len(devices)}")
    log(f"card (name, power limit): {card}")
    cache = jax.config.jax_compilation_cache_dir
    log(f"compile cache: {cache}")

    if args.four:
        run_four_cards(card)
    else:
        run_one_card(card)

    if cache and os.path.isdir(cache):
        log(f"compile cache: {cache} holds {len(os.listdir(cache))} "
            "entries after the run")
    log(f"card (name, power limit): {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
