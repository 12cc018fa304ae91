"""Numeric-validation aids (SURVEY.md §5 sanitizer analogs).

The reference builds with -Ofast and no sanitizers; the equivalents
here are NaN trapping on every jitted op and a float64 shadow mode for
comparing pipeline numerics on CPU (the shadow mode is meant for
XLA-CPU runs).
"""

from __future__ import annotations

import contextlib

import jax


def enable_nan_checks(on: bool = True) -> None:
    """Trap NaNs produced by any jitted computation (jax_debug_nans).

    Note: demod_or_erase deliberately *tolerates* NaNs (they become
    erasures, decode.cc:62-70); with checks enabled those paths raise
    instead, so use this on clean-signal reproductions only.
    """
    jax.config.update("jax_debug_nans", on)


@contextlib.contextmanager
def shadow_f64():
    """Run the enclosed block with float64 enabled (CPU numerics shadow).

    Within the block, freshly-traced functions promote f64 inputs
    honestly instead of silently demoting to f32.  Pass f64 arrays in
    and compare against the f32 pipeline to bound rounding effects.
    """
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)
