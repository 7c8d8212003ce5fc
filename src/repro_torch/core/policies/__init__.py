"""Speculation policies of the port.  Importing this package registers
``dsde``, ``static`` and ``autoregressive``."""
from repro_torch.core.policies.autoregressive import AutoregressivePolicy
from repro_torch.core.policies.base import (HostRoundContext, PolicyObservation,
                                            SpecPolicy, available_policies,
                                            build_policy, register)
from repro_torch.core.policies.dsde import DSDEPolicy
from repro_torch.core.policies.static import KLDTrackingPolicy, StaticPolicy

__all__ = [
    "AutoregressivePolicy", "DSDEPolicy", "HostRoundContext",
    "KLDTrackingPolicy", "PolicyObservation", "SpecPolicy", "StaticPolicy",
    "available_policies", "build_policy", "register",
]
