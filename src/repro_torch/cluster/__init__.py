"""Cluster-level discrete-event simulator (port of ``repro.cluster``): host
arithmetic only, the fleet router's lockstep placement oracle."""
from repro_torch.cluster.simulator import (  # noqa: F401
    ClusterSim,
    Instance,
    SimRecord,
    TaskArrival,
    philly_style_trace,
)
