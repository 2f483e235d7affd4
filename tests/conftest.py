"""Shared fixtures for the tier-1 suite."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path, monkeypatch):
    """Point the block-size autotune cache at a per-test tmpdir.

    The suite must never read a developer's (or CI runner's)
    ``~/.cache/soniq/autotune.json`` — a stale tuned entry would silently
    change the block shapes every Pallas-backed test runs with — and must
    never write there either.
    """
    from repro.backend import autotune

    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    autotune.invalidate()
    yield
    autotune.invalidate()
