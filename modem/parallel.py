"""Multi-chip scaling: frame-batch data parallelism over a device mesh.

The reference is single-threaded (SURVEY.md §2.5); the scaling story
here is pure DP — frames are independent, so the batch axis shards
across devices with `shard_map` over a 1-D mesh and a single
all-gather of decoded payload bits crosses the device interconnect (no
intra-frame state ever crosses devices).  This module also provides the toy end-to-end
configuration used by the multichip dry-run (tiny symbol/code sizes,
same pipeline code paths).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .numerology import ModeSpec, ModemConfig, toy_mode
from .pipeline import BatchPipeline


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("dp",))


def sharded_decode(pipe: BatchPipeline, mesh: Mesh):
    """Batched decode sharded over the 'dp' mesh axis.

    Returns a jitted fn: recordings [B, T, 2] (B divisible by mesh size)
    -> dict with 'bits' [B, data_bits] all-gathered onto every chip and
    per-frame flags sharded back out.
    """

    def local(recs):
        out = jax.vmap(pipe._decode_one)(recs)
        # all-gather payload bits across chips (the one collective)
        bits = jax.lax.all_gather(out["bits"], "dp", tiled=True)
        return {"bits": bits, "ok": out["ok"], "flips": out["flips"]}

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P("dp"),
        out_specs={"bits": P(), "ok": P("dp"), "flips": P("dp")},
        # the all-gathered bits are replicated by construction; the vma
        # checker cannot infer that through the scan/switch pipeline
        check_vma=False)
    return jax.jit(fn)


def sharded_decode_batched(pipe: BatchPipeline, mesh: Mesh,
                           per_chip: int):
    """Throughput fast path sharded over the 'dp' mesh axis.

    Each device runs the whole-batch decoder (batched SCL VM) on its
    `per_chip` recordings; decoded payload bits are all-gathered over
    the device interconnect.  Returns a jitted fn: recordings
    [mesh_size * per_chip, T, 2] -> result dict."""
    run = pipe.batched_run_fn(per_chip)

    def local(recs):
        out = run(recs)
        bits = jax.lax.all_gather(out["bits"], "dp", tiled=True)
        return {"bits": bits, "ok": out["ok"], "flips": out["flips"]}

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=P("dp"),
        out_specs={"bits": P(), "ok": P("dp"), "flips": P("dp")},
        check_vma=False)
    return jax.jit(fn)


def sharded_sync(cfg: ModemConfig, mesh: Mesh):
    """A Synchronizer whose chunked scan shards the CHUNK axis over
    the mesh — the context-parallelism analog (SURVEY.md §5: a long
    recording splits into overlapping windows scanned in parallel;
    the reference walks the same stream sample-by-sample through one
    BipBuffer, decode.cc:188-194).

    Each device computes metrics + Schmitt + segmented argmax for its
    chunks; the only cross-device traffic is the per-chunk summary
    scan (a handful of scalars per chunk, composed with the same
    associative operators that thread carries between super-batches)
    and the final O(candidates) edge gather.  Candidates are exactly
    those of the single-device scan (test_parallel.py)."""
    from .sync import Synchronizer

    sync = Synchronizer(cfg)
    sync.mesh = mesh
    return sync




def sharded_decode_recording(pipe: BatchPipeline, mesh: Mesh, x,
                             max_frames: int = 64):
    """Full multi-chip serving path for ONE long recording: the sync
    scan's chunk axis shards over the mesh (context parallelism), then
    every found frame decodes with frame-batch DP over the same mesh
    (`sharded_decode_batched`), frames padded up to a multiple of the
    mesh size.

    Returns (result dict {bits, ok, flips} trimmed to the real
    frames, positions) — `payload_bytes` works on it; the extra
    per-frame diagnostics of `decode_recording` (snr, sync_gate, ...)
    stay on the single-device path.  Candidate positions and payload
    bytes are exactly those of the single-device
    `BatchPipeline.decode_recording` (test_pipeline.py).  The jitted
    shard_map and the mesh-attached Synchronizer cache ON the pipeline
    object keyed by the MESH VALUE (Mesh hashes by devices+axis
    names), so repeated recordings re-trace nothing, the cache dies
    with the pipeline, and a recycled object address can never pick
    up a stale entry (id()-keyed module caches could)."""
    cache = pipe.__dict__.setdefault("_sharded_cache", {})
    sync = cache.get(("sync", mesh))
    if sync is None:
        sync = sharded_sync(pipe.sync.cfg, mesh)
        cache[("sync", mesh)] = sync
    cands = [c for c in sync.scan(x, max_candidates=max_frames)
             if c.ok]
    wins, pos = pipe.windows_at(x, [c.p0 for c in cands])
    if not len(wins):
        return None, pos
    nd = mesh.devices.size
    n = len(wins)
    pad = (-n) % nd
    if pad:
        wins = np.concatenate(
            [wins, np.zeros((pad,) + wins.shape[1:], np.float32)])
    per_chip = len(wins) // nd
    fn = cache.get(("fn", mesh, per_chip))
    if fn is None:
        fn = sharded_decode_batched(pipe, mesh, per_chip)
        cache[("fn", mesh, per_chip)] = fn
    res = fn(wins)
    res = {k: np.asarray(v)[:n] for k, v in res.items()}
    return res, pos


# ---------------------------------------------------------------------------
# Toy end-to-end configuration (tiny shapes, real pipeline code paths)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def toy_config() -> ModemConfig:
    """256-bin symbols, order-10 polar code, QPSK, 15 payload rows.

    Small enough for CPU dry-runs; structurally identical to the wire
    format (the real MLS preambles still fit in 256 bins).
    """
    mode = toy_mode(code_order=10, cons_cols=32, mod_bits=2,
                    shorten=64, data_bits=448)
    return ModemConfig(rate=8000, mode=mode, freq_off=0,
                       symbol_len_override=256)


def toy_pipeline(list_size: int = 4) -> BatchPipeline:
    cfg = toy_config()
    return BatchPipeline(rate=cfg.rate, oper_mode=0, list_size=list_size,
                         mode_spec=cfg.mode,
                         symbol_len_override=cfg.symbol_len)


def toy_recordings(batch: int, seed: int = 0):
    """Encode `batch` toy frames -> (recordings [B, T, 2], payloads)."""
    from . import bits as B
    from . import cplx
    from .encoder import Encoder

    cfg = toy_config()
    enc = Encoder(cfg)
    rng = np.random.default_rng(seed)
    sil = np.zeros(cfg.symbol_len, dtype=np.complex64)
    recs, payloads = [], []
    for _ in range(batch):
        payload = rng.integers(0, 256, cfg.mode.data_bytes,
                               dtype=np.uint8).tobytes()
        wave, _ = enc.encode(payload, B.base37_encode("TOY"))
        recs.append(np.concatenate([sil, wave, sil]))
        payloads.append(payload)
    return cplx.from_np(np.stack(recs)), payloads
