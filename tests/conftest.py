"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The reference verifies everything in double precision against Eigen/SciPy
oracles (SURVEY.md section 4); we do the same on the CPU backend. Multi-chip
sharding tests use the 8 virtual CPU devices. The tests run on the CPU
backend even on a machine with a GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
