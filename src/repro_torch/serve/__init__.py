# Serving layer of the port: one Deployment front-end over pluggable
# Schedulers and placed Replicas (deployment.py).
from .autoscale import Autoscaler  # noqa: F401
from .deployment import (AcceleratorReplica, ContinuousBatch,  # noqa: F401
                         Deployment, DetectRequest, FixedBatch, LmReplica,
                         Replica, Scheduler, SloAdmission)
from .dispatch import (RoundRobinDispatch, WeightedDispatch,  # noqa: F401
                       make_dispatch)
from .faults import (FaultEvent, FaultPlan, FaultyReplica,  # noqa: F401
                     HealthPolicy, ReplicaCrashed, ReplicaFault,
                     ReplicaHealth, ReplicaStalled, TransientFault)
