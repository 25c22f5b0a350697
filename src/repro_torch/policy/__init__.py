"""repro_torch.policy — unified, pluggable, vectorized mode-selection API.

The single entry point for routing/schedule selection across the
Dragonfly simulator, the TPU collective layer and the launchers:

    from repro_torch.policy import (AppAwareConfig, AppAwarePolicy,
                              DecisionBatch, PolicyEngine, make_engine)

    engine = make_engine("app_aware")
    modes = engine.decide(DecisionBatch.of(bytes_array, site="bucket0"))
    engine.bus.publish_flow_arrays(latency_us, stalls)   # feedback

See docs/policy_api.md for the architecture diagram and migration notes
from the deprecated `repro_torch.core.app_aware.AppAwareRouter` shim.
"""

from repro_torch.policy.app_aware import (AppAwareConfig, AppAwarePolicy,
                                    SiteState, scoped_site_filter)
from repro_torch.policy.engine import PolicyEngine, POLICY_NAMES, make_engine
from repro_torch.policy.notification import NotificationConfig, NotificationPolicy
from repro_torch.policy.policies import EpsilonGreedyPolicy, StaticPolicy
from repro_torch.policy.telemetry import (COUNTER_KINDS, TelemetryBus,
                                    normalize_kind)
from repro_torch.policy.types import (DecisionBatch, Feedback, KIND_ALLREDUCE,
                                KIND_ALLTOALL, KIND_BROADCAST, KIND_PT2PT,
                                Policy, TrafficLedger)

__all__ = [
    "AppAwareConfig", "AppAwarePolicy", "SiteState", "scoped_site_filter",
    "PolicyEngine", "POLICY_NAMES", "make_engine",
    "EpsilonGreedyPolicy", "StaticPolicy",
    "NotificationConfig", "NotificationPolicy",
    "TelemetryBus", "COUNTER_KINDS", "normalize_kind",
    "DecisionBatch", "Feedback", "Policy", "TrafficLedger",
    "KIND_PT2PT", "KIND_ALLTOALL", "KIND_ALLREDUCE", "KIND_BROADCAST",
]
