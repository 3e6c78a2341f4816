"""Test configuration: run JAX on the CPU backend with 8 virtual devices.

Tests run anywhere, card or not: timings come from bench.py and
chip_smoke.py on the GPU.  The 8 virtual devices exercise the multi-device
sharding paths.  Both settings are made before any JAX import.  The
persistent compile cache follows the package's rule (pgrtk/ops/__init__.py):
JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache` in the checkout.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

TEST_DATA = "/root/reference/pgr-db/test/test_data"


@pytest.fixture(scope="session")
def test_data_dir():
    return TEST_DATA
