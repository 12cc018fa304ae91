"""Live streaming decode benchmark: real-time factor and latency.

Feeds a multi-frame mono int16 recording through stream.StreamDecoder
in ~1 s chunks (the arecord cadence) and reports:

* stream_x_realtime — audio seconds decoded per wall second across the
  whole stream (the live path must stay >> 1x to keep up with a live
  source; the batch paths are the throughput surfaces),
* per-frame emission latency — wall time from feeding the sample that
  completes a frame's payload window to its emission.

Usage: python bench/stream_bench.py [n_frames] [feed_seconds]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    feed_s = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0

    from modem import bits as B
    from modem.encoder import Encoder
    from modem.numerology import make_config
    from modem.stream import StreamDecoder

    rate = 8000
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, 5380, dtype=np.uint8).tobytes()
                for _ in range(n_frames)]
    cfg = make_config(rate, 6, 2000, 1)
    wave, _ = Encoder(cfg).encode(payloads, B.base37_encode("N0CALL"))
    rec = np.concatenate([np.zeros(rate, np.complex64), wave,
                          np.zeros(rate, np.complex64)])
    mono = np.clip(np.rint(rec.real * 32767), -32768,
                   32767).astype(np.int16)
    audio_s = len(mono) / rate
    print(f"{n_frames} frames, {audio_s:.0f} s of audio, "
          f"{feed_s:.1f} s feeds")

    def run():
        sd = StreamDecoder(rate, channels=1, bits=16)
        step = int(rate * feed_s)
        got, lat = [], []
        t0 = time.time()
        for i in range(0, len(mono), step):
            tf = time.time()
            out = sd.feed(mono[i: i + step])
            if out:
                lat.append(time.time() - tf)
            got += out
        out = sd.finish()
        got += out
        wall = time.time() - t0
        return got, wall, lat

    got, wall, lat = run()          # warm-up (compiles)
    got, wall, lat = run()
    ok = sum(f["ok"] and f["payload"] == payloads[i]
             for i, f in enumerate(sorted(got, key=lambda f: f["pos"])))
    print(f"decoded {ok}/{n_frames} byte-exact")
    print(f"wall {wall:.2f} s -> {audio_s / wall:.0f}x real time")
    if lat:
        print(f"emission latency after completing feed: "
              f"median {np.median(lat)*1e3:.0f} ms, "
              f"max {max(lat)*1e3:.0f} ms")
    assert ok == n_frames

    # file-replay mode: the whole stream in ONE feed — every chunk is
    # ready at once, so the scan runs its vmapped multi-chunk
    # super-batches (StreamDecoder.MAX_CHUNKS_PER_FEED; the CLI uses
    # ~16 s feeds for seekable files)
    def replay():
        sd = StreamDecoder(rate, channels=1, bits=16)
        t0 = time.time()
        got = sd.feed(mono)
        got += sd.finish()
        return got, time.time() - t0

    got_r, wall_r = replay()        # warm-up (m>1 graphs compile)
    got_r, wall_r = replay()
    ok_r = sum(f["ok"] and f["payload"] == payloads[i]
               for i, f in enumerate(sorted(got_r,
                                            key=lambda f: f["pos"])))
    print(f"file replay (single feed): {ok_r}/{n_frames} byte-exact, "
          f"wall {wall_r:.2f} s -> {audio_s / wall_r:.0f}x real time")
    assert ok_r == n_frames


if __name__ == "__main__":
    main()
