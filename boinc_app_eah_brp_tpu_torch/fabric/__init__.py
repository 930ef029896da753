"""Volunteer-fabric quorum control plane.

The server-side half of the BOINC deployment the paper's app ran under:
quorum validation of redundant results (``validator``), volunteer host
behavior models honest and adversarial (``hosts``), and the concurrent
work-fabric scheduler/simulator (``workfabric``).  Host code that imports
no torch — importable everywhere tools and soaks run.  (The optional
``server`` compute backend — ``ERP_FABRIC_BACKEND=server``,
:class:`ServerBackend` — lazily pulls in the fleet serving tier, and with
it torch and the card, only when constructed.)  The names are the JAX
package's ``fabric/__init__.py``'s.
"""

from .hosts import (
    ADVERSARY_KINDS,
    HOST_KINDS,
    HostModel,
    HostReputation,
    ReportGroundTruth,
)
from .validator import (
    DEFAULT_FA_ATOL,
    DEFAULT_PARAM_RTOL,
    DEFAULT_POWER_RTOL,
    QUORUM_SCHEMA,
    LoadedReplica,
    QuorumError,
    QuorumOutcome,
    Replica,
    canonical_candidate_lines,
    canonical_digest,
    compare_replicas,
    intrinsic_problems,
    load_replica,
    sign_verdict,
    validate_quorum,
    validate_quorum_verdict,
    validate_single,
    verify_verdict_signature,
)
from .workfabric import (
    FABRIC_BACKEND_ENV,
    Assignment,
    Fabric,
    FabricConfig,
    ServerBackend,
    WorkUnit,
    compute_backend,
    run_streams,
)

__all__ = [
    "ADVERSARY_KINDS",
    "HOST_KINDS",
    "HostModel",
    "HostReputation",
    "ReportGroundTruth",
    "DEFAULT_FA_ATOL",
    "DEFAULT_PARAM_RTOL",
    "DEFAULT_POWER_RTOL",
    "QUORUM_SCHEMA",
    "LoadedReplica",
    "QuorumError",
    "QuorumOutcome",
    "Replica",
    "canonical_candidate_lines",
    "canonical_digest",
    "compare_replicas",
    "intrinsic_problems",
    "load_replica",
    "sign_verdict",
    "validate_quorum",
    "validate_quorum_verdict",
    "validate_single",
    "verify_verdict_signature",
    "FABRIC_BACKEND_ENV",
    "Assignment",
    "Fabric",
    "FabricConfig",
    "ServerBackend",
    "WorkUnit",
    "compute_backend",
    "run_streams",
]
