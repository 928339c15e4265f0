"""Online serving: GAME models pinned on one device, answering requests.

Port of `photon_ml_tpu/serving/` for one device:
`bundle.py` stages a model directory (or an in-memory model) onto the
device once, `engine.py` scores request batches through one bucket program
per power-of-two batch size (a CUDA graph on the card), `batcher.py`
coalesces single requests into deadline micro-batches, and `lifecycle.py`
keeps it serving under faults: typed shedding and deadlines, the circuit
breaker with fixed-effect-only answers, the health state machine and
versioned hot-swap; `delta.py` flips a live engine onto an incremental
fit's delta bundle through the same generation change. `tenancy.py`
serves several named tenants on the card (`TenantRegistry`: quotas,
deadlines, weighted-fair co-batching bit-equal to solo dispatch, per-tenant
failure domains, demotion of cold tenants to the host tier, the
`TwoTierEntityStore` of `bundle.py`), and `shadow.py` evaluates a
challenger online beside the champion and promotes or rejects it.
`reshard.py` is not ported (ROADMAP item 9c).
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
    "MicroBatcher",
    "Overloaded",
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
    "promote_bundle_from_host_tier",
    "request_from_record",
]
