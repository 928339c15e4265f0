"""Online serving: GAME models pinned on the cards of one process, answering requests.

Port of `photon_ml_tpu/serving/`:
`bundle.py` stages a model directory (or an in-memory model) onto the
device once (its random effects replicated on the home card, two-tier,
or row-sharded over the process's cards), `engine.py` scores request batches through one bucket program
per power-of-two batch size (a CUDA graph on the card), `batcher.py`
coalesces single requests into deadline micro-batches, and `lifecycle.py`
keeps it serving under faults: typed shedding and deadlines, the circuit
breaker with fixed-effect-only answers, the health state machine and
versioned hot-swap; `delta.py` flips a live engine onto an incremental
fit's delta bundle through the same generation change. `tenancy.py`
serves several named tenants on the card (`TenantRegistry`: quotas,
deadlines, weighted-fair co-batching bit-equal to solo dispatch, per-tenant
failure domains, demotion of cold tenants to the host tier, the
`TwoTierEntityStore` of `bundle.py`, and the precision ladder that
quantizes a tenant's random-effect rows to bf16 or int8 and restores them),
and `shadow.py` evaluates a challenger online beside the champion and
promotes or rejects it. `reshard.py` moves placement live: a reshard
onto a mesh of cards, back to one, or a two-tier hot-row rebalance.
"""

from photon_ml_tpu_torch.serving.batcher import MicroBatcher
from photon_ml_tpu_torch.serving.bundle import (
    ScoreRequest,
    ServingBundle,
    ServingCoordinate,
    ShardHealth,
    TwoTierEntityStore,
    demote_bundle_to_host_tier,
    load_bundle,
    promote_bundle_from_host_tier,
    request_from_record,
)
from photon_ml_tpu_torch.serving.engine import ScoreResult, ServingEngine
from photon_ml_tpu_torch.serving.reshard import (
    MeshReshardOrchestrator,
    ReshardPlan,
    plan_rebalance,
    plan_reshard,
)
from photon_ml_tpu_torch.serving.shadow import ShadowController
from photon_ml_tpu_torch.serving.tenancy import Tenant, TenantRegistry
from photon_ml_tpu_torch.serving.lifecycle import (
    BatcherUnhealthy,
    BundleManager,
    CircuitBreaker,
    CircuitState,
    DeadlineExceeded,
    HbmBudgetExceeded,
    HealthStateMachine,
    Overloaded,
    ServingState,
    SwapIncompatible,
)
from photon_ml_tpu_torch.utils.faults import DeviceHang

__all__ = [
    "BatcherUnhealthy",
    "BundleManager",
    "CircuitBreaker",
    "CircuitState",
    "DeadlineExceeded",
    "DeviceHang",
    "HbmBudgetExceeded",
    "HealthStateMachine",
    "MeshReshardOrchestrator",
    "MicroBatcher",
    "Overloaded",
    "ReshardPlan",
    "ScoreRequest",
    "ScoreResult",
    "ServingBundle",
    "ServingCoordinate",
    "ServingEngine",
    "ServingState",
    "ShadowController",
    "ShardHealth",
    "SwapIncompatible",
    "Tenant",
    "TenantRegistry",
    "TwoTierEntityStore",
    "demote_bundle_to_host_tier",
    "load_bundle",
    "plan_rebalance",
    "plan_reshard",
    "promote_bundle_from_host_tier",
    "request_from_record",
]
