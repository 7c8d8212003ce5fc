"""Speculation policies of the port (``repro.core.policies``).
Importing this package registers the reference's six:

* ``dsde``            — paper §3.1-3.3 KLD-variance SL adaptation;
* ``static``          — fixed SL baseline;
* ``adaedl``          — entropy early-stop baseline;
* ``autoregressive``  — no speculation (K = 0);
* ``goodput``         — acceptance-EMA goodput controller;
* ``slo``             — DSDE + deadline-aware bucket arbitration from the
  analytic latency model (DESIGN.md §15).
"""
from repro_torch.core.policies.base import (HostRoundContext, PolicyObservation,
                                            SpecPolicy, as_host_round_context,
                                            available_policies, build_policy,
                                            register)
from repro_torch.core.policies.adaedl import AdaEDLPolicy
from repro_torch.core.policies.autoregressive import AutoregressivePolicy
from repro_torch.core.policies.dsde import DSDEPolicy
from repro_torch.core.policies.goodput import GoodputPolicy, GoodputState
from repro_torch.core.policies.slo import SLOPolicy
from repro_torch.core.policies.static import KLDTrackingPolicy, StaticPolicy

__all__ = [
    "AdaEDLPolicy", "AutoregressivePolicy", "DSDEPolicy", "GoodputPolicy",
    "GoodputState", "HostRoundContext", "KLDTrackingPolicy",
    "PolicyObservation", "SLOPolicy", "SpecPolicy", "StaticPolicy",
    "as_host_round_context", "available_policies", "build_policy", "register",
]
