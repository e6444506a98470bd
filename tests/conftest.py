"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-device logic is exercised on host-platform virtual devices
(xla_force_host_platform_device_count), so the tests need no accelerator.
CPU is forced unconditionally: the suite runs under several xdist workers,
and on a machine with a GPU each worker would otherwise open the card.
float64 gives clean oracles for the numerical property tests.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
