"""Session guards: smoke tests and benches must see exactly ONE device —
the 512-device XLA flag belongs to the dry-run (and to subprocess tests)
only. A leak here would silently shard every smoke test 512 ways.

Dtype guard: with x64 disabled, an explicit 64-bit dtype request anywhere in
a JAX path silently truncates to 32 bits and emits a UserWarning — promote it
to an error so the intended dtypes stay explicit."""
import jax


def pytest_configure(config):
    config.addinivalue_line(
        "filterwarnings", "error:Explicitly requested dtype")
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def pytest_sessionstart(session):
    assert jax.device_count() == 1, (
        "test session must run on 1 device; XLA_FLAGS leaked: "
        f"{jax.devices()[:4]}...")
