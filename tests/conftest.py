"""Shared fixtures. NOTE: no XLA device-count flags here by design — smoke
tests must see exactly 1 CPU device (the dry-run alone forces 512). Tests that
need a mesh spawn a subprocess via tests/mesh_worker.py."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 560) -> str:
    """Run a python snippet in a child process with N host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=env,
        timeout=timeout,
    )
    if out.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
        )
    return out.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips without one")


@pytest.fixture
def mesh_runner():
    return run_with_devices
