"""OFDM acoustic modem framework in JAX (aicodix/modem wire format)."""

import os as _os

# The SCL schedule VM compiles slowly (20k-instruction scan); persist
# compiled executables across processes.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; otherwise the cache lives at a
# fixed path beside the package (the path is part of the cache key).
try:
    import jax as _jax

    if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
        _cache = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                               "..", ".jax_cache")
        _os.makedirs(_cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir",
                           _os.path.normpath(_cache))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
except (ImportError, OSError):  # pragma: no cover - cache is best-effort
    pass
