"""Cross-cluster federation: N independent filodb-tpu clusters answer
PromQL as one system (port of filodb_tpu/federation; doc/federation.md).
The federated leaf's frames are the reference's byte for byte, so a
port cluster and a JAX cluster federate with each other.

The layer is deliberately thin over machinery that already exists:

  - routing      — FederationPlanner (federation/planner.py) above each
                   dataset's planner stack picks the clusters that OWN
                   the matching series (label matchers / time windows,
                   the registry in federation/registry.py) and builds a
                   coordinator exec tree whose remote children are
                   FederatedLeafExec plans (federation/exec.py);
  - transport    — FederatedLeafExec rides the SAME CRC-framed node
                   query wire (parallel/transport.py) against the remote
                   cluster's federation door (federation/door.py), so
                   streaming partials, typed errors, deadline budgets,
                   kill frames and span shipping all come for free;
  - degradation  — a dead or deadline-blown cluster degrades through
                   the partial-results gate behind a `cluster:<name>`
                   circuit breaker; the warning names the cluster;
  - introspection— one query id names the whole federated query in every
                   participating cluster's ActiveQueryRegistry, one
                   trace id collects the stitched cross-cluster span
                   tree, one /admin/queries kill stops remote scans.

The reference's MultiPartitionPlanner/HighAvailabilityPlanner route
subtrees across partitions the same way (PAPER.md §1); Thanos/Cortex
federate over remote_read — here the AggPartial pushdown wire replaces
series shipping for exactly-mergeable aggregations.
"""
from filodb_tpu_torch.federation.registry import (  # noqa: F401
    ClusterDef, ClusterState, FederationRegistry)
from filodb_tpu_torch.federation.exec import FederatedLeafExec  # noqa: F401
from filodb_tpu_torch.federation.planner import FederationPlanner  # noqa: F401
from filodb_tpu_torch.federation.door import (  # noqa: F401
    FederationDoor, FederationSource)
