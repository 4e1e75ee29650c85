"""Test configuration.

By default the tests run on CPU JAX with 8 virtual devices, so all the
sharding logic is exercised without accelerators. ``pytest -m gpu --gpu``
runs only the ``gpu``-marked tests instead, on the GPU that JAX finds
there; each of them checks for the card in its ``gpu`` fixture and skips
without one. Without ``--gpu`` those tests skip.

jax may already be *imported* by pytest plugins before ``pytest_configure``
runs, but the backend is not yet initialised, so jax.config.update still
works; the env vars cover subprocess tests.
"""

import os

import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true",
                     help="run only the gpu-marked tests, on the GPU")


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    # the CLI points JAX at a persistent compile cache in the checkout;
    # the CPU tests (and their subprocesses) keep none
    os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_compilation_cache", False)


def pytest_collection_modifyitems(config, items):
    if not config.getoption("--gpu"):
        return
    keep = [it for it in items if "gpu" in it.keywords]
    config.hook.pytest_deselected(
        items=[it for it in items if "gpu" not in it.keywords])
    items[:] = keep


@pytest.fixture
def gpu(request):
    """The GPU device; skips unless run with --gpu on a machine with one."""
    if not request.config.getoption("--gpu"):
        pytest.skip("needs an NVIDIA GPU: run `pytest -m gpu --gpu` there")
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"no GPU present (JAX platform {dev.platform!r})")
    return dev
