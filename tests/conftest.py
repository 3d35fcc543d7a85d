import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# -- optional-hypothesis shim (see requirements-dev.txt) ---------------------
# Property-based tests import `given/settings/st` from here instead of from
# hypothesis directly, so the tier-1 suite still *collects* on a clean
# machine: with hypothesis installed the real decorators are re-exported;
# without it, @given tests skip and every other test in the module runs.
try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    HAVE_HYPOTHESIS = True

    # Bounded, deterministic profiles: CI runs `--hypothesis-profile=ci`
    # (pair it with a fixed --hypothesis-seed); "dev" keeps local runs quick.
    settings.register_profile(
        "ci", max_examples=25, deadline=None, print_blob=True,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large,
                               HealthCheck.filter_too_much])
    settings.register_profile("dev", max_examples=10, deadline=None)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ImportError:  # pragma: no cover - exercised on clean machines
    HAVE_HYPOTHESIS = False

    def given(*_a, **_k):
        return pytest.mark.skip(reason="hypothesis not installed")

    def settings(*_a, **_k):
        return lambda fn: fn

    class _StrategiesStub:
        """Any strategy call returns None; @st.composite yields a dummy
        factory — enough for module-level decorators to evaluate."""

        @staticmethod
        def composite(_fn):
            return lambda *a, **k: None

        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _StrategiesStub()


def run_multidevice(snippet: str, n_devices: int = 8, timeout: int = 300) -> str:
    """Run a python snippet in a subprocess with N placeholder CPU devices.

    Multi-device collectives need XLA_FLAGS set before jax init; tests in the
    main process must keep seeing 1 device (assignment requirement), so the
    flag lives only in the child environment.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", snippet], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{out.stdout}\n{out.stderr}")
    return out.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
        "kernels); skips without one")
