"""Test config: force an 8-device CPU platform before JAX initializes.

Multi-chip sharding logic is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), per the project build mandate.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
