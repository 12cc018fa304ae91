"""Test harness: run everything on XLA-CPU with an 8-device virtual mesh.

Mirrors SURVEY.md §4's "fake backend" plan: sharding/vmap tests need no
accelerator; chip_smoke.py runs the main paths on a GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already be imported (a plugin, a sitecustomize) before this
# file runs; pin the platform through the config API as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
