"""Test configuration: JAX on the CPU with a virtual 8-device mesh.

Integer codec math is platform-independent, so CPU tests validate the same
computations that run on the card; multi-device sharding tests use the 8
virtual host devices (SURVEY.md §4.8).  Tests marked `gpu` need a card:
run them where one is, with the platform list naming it, e.g.
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`; here they skip.
"""

import os

# CPU unless the caller names the platforms; set the config too, in case
# jax was imported before this file.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)
