"""The paper's contribution: bounded-asynchronous consistency models.

The faithful semantics layer — :mod:`repro_torch.core.server`, the
event-driven asynchronous PS simulator, with
:mod:`repro_torch.core.controller` deciding block/admit under a
:class:`~repro_torch.core.policies.Policy`.  All of it is host numpy logic.
"""
from repro_torch.core import controller, policies
from repro_torch.core.policies import (ConsistencySpec, Policy, bsp, cap,
                                       cvap, elastic, essp, from_spec, ssp,
                                       vap)
from repro_torch.core.server import (AsyncPS, NetworkModel, RunStats, Update,
                                     UpdateMap, ViewHandle)
from repro_torch.core.vector_clock import VectorClock

__all__ = [
    "AsyncPS", "ConsistencySpec", "NetworkModel", "Policy", "RunStats",
    "Update", "UpdateMap", "VectorClock", "ViewHandle", "bsp", "cap",
    "controller", "cvap", "elastic", "essp", "from_spec", "policies", "ssp",
    "vap",
]
