"""Shared fixtures of the benchmark's CPU tests."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with its reason on a host without one")


@pytest.fixture
def cpu_plane(monkeypatch):
    """The port's process-wide sharding plane over the CPU: the `cuda`
    backend then runs the port's plain torch path, as its own tests do."""
    import torch

    from juicefs_tpu_torch.gpu import sharding

    monkeypatch.setattr(sharding, "_plane", sharding.ShardPlane([torch.device("cpu")]))
    return sharding._plane
