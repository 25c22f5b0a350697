"""The port stands alone: it imports neither jax nor the reference
package, and it never carries on on the CPU when CUDA was asked for."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.dragonfly import DragonflySimulator, SimParams, small_topology
from repro_torch.runtime import resolve_device

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_port_imports_no_jax_and_no_reference():
    probe = textwrap.dedent("""
        import pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            __import__(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad, " ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, rest = out.stdout.split(" ", 1)
    bad, names = rest.split("] ", 1)
    names = set(names.split())
    assert int(n_modules) >= 66          # every module was imported
    assert bad.strip() == "["
    # the policy engine and the figure benchmarks are among them
    for pkg in ("policy", "benchmarks"):
        assert f"repro_torch.{pkg}" in names
    assert {f"repro_torch.policy.{m}" for m in (
        "types", "telemetry", "policies", "notification", "app_aware",
        "engine")} <= names
    assert {f"repro_torch.benchmarks.{m}" for m in (
        "common", "fig7_routing_pingpong", "fig8_microbench",
        "fig10_applications")} <= names
    assert {f"repro_torch.core.{m}" for m in (
        "noise", "calibration", "app_aware")} <= names


def test_simulator_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = small_topology("aries")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DragonflySimulator(topo, SimParams())
    with pytest.raises(RuntimeError):
        DragonflySimulator(topo, SimParams(), device="cuda")
    assert DragonflySimulator(topo, SimParams(),
                              device="cpu").device.type == "cpu"


def test_resolve_device_rejects_other_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_runtime_is_a_package_that_keeps_its_names():
    """``repro_torch.runtime`` takes the reference's package path
    (``repro/runtime/``) and still exports what the port imports."""
    import repro_torch.runtime as runtime
    assert hasattr(runtime, "__path__")            # a package, not a module
    assert runtime.__file__.endswith("__init__.py")
    assert runtime.HOPPER == (9, 0)
    assert runtime.resolve_device is resolve_device
    assert callable(runtime.on_hopper)


@pytest.mark.parametrize("first", ["repro_torch.policy",
                                   "repro_torch.core.app_aware",
                                   "repro_torch.dragonfly.traffic",
                                   "repro_torch.benchmarks.fig8_microbench"])
def test_policy_imports_are_not_circular(first):
    """Any of these as the first port import works, and the deprecated
    shim resolves lazily from ``repro_torch.core``."""
    probe = (f"import {first}\nimport repro_torch.core as c\n"
             "import warnings\nwarnings.simplefilter('ignore')\n"
             "print(c.AppAwareRouter.__module__)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "repro_torch.core.app_aware"
