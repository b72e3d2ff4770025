"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere.
"""

import os

# The suite runs on the CPU, whatever the shell exports.  Only the
# gpu-marked tests (tests/test_gpu.py) may reach a card, and only when
# MERFIN_GPU_TESTS=1 asks for it (chip_smoke.py's gpu phase); then
# JAX_PLATFORMS, default "cuda,cpu", picks the platforms.
if os.environ.get("MERFIN_GPU_TESTS") == "1":
    os.environ["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS") or "cuda,cpu"
else:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
