import os
import subprocess
import sys
from pathlib import Path

# Tests run on a virtual 8-device CPU mesh; set before jax import.  The
# config update below also pins the platform if jax was imported already.
# Tests that need a real GPU carry the ``gpu`` marker and run their device
# work in a child process with a clean environment (test_device_gpu.py).
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REF_BUILD = REPO / "build" / "ref"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips without one "
        "(run them on the card with: python -m pytest -m gpu tests/)")


@pytest.fixture(scope="session")
def ref_bgt():
    """Path to the reference bgt binary (built from /root/reference sources)."""
    exe = REF_BUILD / "bgt"
    if not exe.exists():
        subprocess.run(["sh", str(REPO / "tools" / "build_reference.sh")], check=True)
    return str(exe)


@pytest.fixture(scope="session")
def ref_pbfview():
    exe = REF_BUILD / "pbfview"
    if not exe.exists():
        subprocess.run(["sh", str(REPO / "tools" / "build_reference.sh")], check=True)
    return str(exe)


@pytest.fixture(scope="session")
def ref_kexpr():
    exe = REF_BUILD / "kexpr"
    if not exe.exists():
        subprocess.run(["sh", str(REPO / "tools" / "build_reference.sh")], check=True)
    return str(exe)
