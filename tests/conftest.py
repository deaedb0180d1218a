import jax
import pytest

# NOTE: do NOT set --xla_force_host_platform_device_count here; smoke tests
# and benches must see the real (1-device) host.  The multi-pod dry-run sets
# it itself as the very first lines of repro.launch.dryrun.

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
