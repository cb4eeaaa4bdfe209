"""Test configuration: force a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharded code paths are
exercised on fake CPU devices per SURVEY.md §4 ("multi-node testing").
Must run before jax initialises, hence module import side effects here.
"""

import os

# Unit tests run on a virtual 8-device CPU mesh in float64 (exact vs the
# host oracle).  ``python chip_smoke.py`` covers the GPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
