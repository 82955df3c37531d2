"""Test harness config: run all tests on a simulated 8-device CPU mesh.

Per SURVEY.md §4: multi-host/sharding logic must be exercisable without a cluster via
XLA's host-platform device-count override. The default platform is pinned to the CPU
through jax.config as well as the environment. The CPU client initializes lazily, so
setting XLA_FLAGS here (before first CPU-backend use) still yields 8 virtual devices.
Tests that need a GPU carry the `gpu` marker and pick the card in a fixture
(see `gpu_device`); they skip where there is none.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# The persistent compilation cache is for the accelerator's compiles; for
# the CPU backend this jaxlib's AOT loader is unreliable — it embeds pseudo
# machine features (+prefer-no-scatter) at compile time, warns on every load,
# and intermittently SIGSEGV/SIGABRTs in get_executable_and_time (killed two
# full-suite runs at ~90%). Tests run pure-CPU: disable it BEFORE the package
# import configures it.
os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_between_modules():
    """XLA:CPU intermittently SIGSEGV/SIGABRTs once a long-lived process has
    accumulated hundreds of live compiled executables (three full-suite runs
    died in the final 10%, each at a DIFFERENT site inside compile or
    cache-load). Dropping the jit caches between test modules keeps the live
    executable count bounded; modules pay their own (fast, CPU) compiles."""
    yield
    import gc

    from slam_framework_tpu.utils import progcache

    progcache.clear()
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips without one (run: python -m pytest tests -m gpu)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU, made JAX's default device for the test (this module pins
    the CPU as the default platform); skips where JAX finds no GPU."""
    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
    with jax.default_device(dev):
        yield dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def cpu_mesh_devices():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "expected 8 virtual CPU devices (XLA_FLAGS)"
    return devs
