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
        print(len(names), bad)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 15          # every module was imported
    assert bad.strip() == "[]"


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
