"""The port's copies of the NumPy-only ``repro.core`` modules: routing
modes, the Eq. (1)/(2) model, NIC counters, the noise statistics, the
scaling-factor calibration and the deprecated ``AppAwareRouter`` shim."""

from repro_torch.core.calibration import (ScalingFactors,
                                          calibrate_scaling_factors)
from repro_torch.core.counters import CounterBackend, CounterWindow, NICCounters
from repro_torch.core.noise import NoiseReport, estimate_noise, iqr, qcd
from repro_torch.core.perf_model import (AriesNICModel, MessageShape,
                                         flits_and_packets,
                                         predict_transmission_cycles)
from repro_torch.core.strategies import ADAPTIVE_MODES, ARIES_MODES, RoutingMode


def __getattr__(name):
    # Lazy: the deprecated app_aware shim pulls repro_torch.policy, which
    # pulls repro_torch.core.perf_model — an eager import here would make
    # `import repro_torch.policy` (as the first port import) circular.
    if name in ("AppAwareRouter", "RouterConfig"):
        from repro_torch.core import app_aware
        return getattr(app_aware, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "RoutingMode", "ARIES_MODES", "ADAPTIVE_MODES",
    "AriesNICModel", "MessageShape", "predict_transmission_cycles",
    "flits_and_packets",
    "NICCounters", "CounterWindow", "CounterBackend",
    "qcd", "iqr", "NoiseReport", "estimate_noise",
    "AppAwareRouter", "RouterConfig",
    "ScalingFactors", "calibrate_scaling_factors",
]
