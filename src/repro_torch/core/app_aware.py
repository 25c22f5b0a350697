"""DEPRECATED shim — Algorithm 1 now lives in `repro_torch.policy.app_aware`.

`AppAwareRouter` keeps the seed's scalar select/observe API working by
delegating to a single-call-site `AppAwarePolicy` in "message"
granularity, which is decision-for-decision identical to the original
implementation (tests/test_policy.py proves it on recorded traces).

New code should use:

    from repro_torch.policy import AppAwareConfig, AppAwarePolicy, PolicyEngine

`RouterConfig` is an alias of `repro_torch.policy.AppAwareConfig` (same fields,
same defaults).
"""

from __future__ import annotations

import warnings
from typing import Hashable, Optional

# NOTE: repro_torch.policy imports are deferred — policy.app_aware pulls
# repro_torch.core.perf_model, which runs repro_torch.core.__init__, which imports
# this module; an eager import here would make `import repro_torch.policy`
# (before any repro_torch.core import) fail with a circular-import error.


def __getattr__(name):
    # legacy alias — the config moved to repro_torch.policy (fields unchanged)
    if name in ("RouterConfig", "AppAwareConfig"):
        from repro_torch.policy.app_aware import AppAwareConfig
        return AppAwareConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class AppAwareRouter:
    """Deprecated scalar front-end over `repro_torch.policy.AppAwarePolicy`.

    Every attribute of the seed class (`current`, `samples`,
    `cumulative_bytes`, `sent_bytes_by_mode`, `decisions`,
    `_pending_mode`) is proxied to the underlying per-site Algorithm-1
    automaton, so existing callers and tests observe identical state.
    """

    def __init__(self, config=None, current: Hashable = None, *,
                 policy=None):
        from repro_torch.policy.app_aware import AppAwareConfig, AppAwarePolicy

        warnings.warn(
            "AppAwareRouter is deprecated; use repro_torch.policy.AppAwarePolicy "
            "or repro_torch.policy.PolicyEngine (see docs/policy_api.md)",
            DeprecationWarning, stacklevel=2)
        self.config = config or AppAwareConfig()
        self.policy = policy or AppAwarePolicy(self.config,
                                               granularity="message")
        if current is not None:
            self._site.current = current

    # -------------------------------------------------------- state proxies
    @property
    def _site(self):
        return self.policy.site("default")

    @property
    def current(self) -> Hashable:
        return self._site.current

    @current.setter
    def current(self, value: Hashable) -> None:
        self._site.current = value

    @property
    def samples(self) -> dict:
        return self._site.samples

    @samples.setter
    def samples(self, value: dict) -> None:
        self._site.samples = value

    @property
    def cumulative_bytes(self) -> int:
        return self._site.cumulative_bytes

    @cumulative_bytes.setter
    def cumulative_bytes(self, value: int) -> None:
        self._site.cumulative_bytes = value

    @property
    def decisions(self) -> int:
        return self._site.decisions

    @property
    def sent_bytes_by_mode(self) -> dict:
        return self._site.ledger.sent

    @property
    def gated_bytes_by_mode(self) -> dict:
        """Bytes the 4 KiB gate forced to mode_b without a decision
        (tracked separately — Fig. 8/9 semantics)."""
        return self._site.ledger.gated

    @property
    def decided_bytes_by_mode(self) -> dict:
        """Bytes routed by actual Algorithm-1 decisions."""
        return self._site.ledger.decided

    @property
    def _pending_mode(self) -> Optional[Hashable]:
        return self._site._pending_mode

    # ------------------------------------------------------------ legacy API
    def select(self, msg_size_bytes: int, *, alltoall: bool = False
               ) -> Hashable:
        """selectRouting(msgSize) — Algorithm 1 (delegated)."""
        return self._site.select(msg_size_bytes, alltoall=alltoall)

    def observe(self, latency_cycles: float, stalls_per_flit: float) -> None:
        self._site.observe(latency_cycles, stalls_per_flit)

    def traffic_fraction(self, mode: Hashable, *,
                         include_gated: bool = True) -> float:
        """Fraction of bytes sent with `mode` (the x-axis % in Fig. 8/9).
        include_gated=False excludes gate-forced bytes, counting only
        decision-routed traffic."""
        return self._site.traffic_fraction(mode,
                                           include_gated=include_gated)

    def gated_fraction(self) -> float:
        return self._site.ledger.gated_fraction()
