"""photon-lint for the port: self-hosted static analysis of
`photon_ml_tpu_torch`, its drivers (chip_smoke.py, tools/) and its tests.

The port's own copy of the JAX package's `photon_ml_tpu/analysis/`, with
the same nine checks under the same names; it imports neither jax nor
anything of `photon_ml_tpu`, and never imports the code it lints:

* knob-registry       — PHOTON_* env reads go through utils/knobs.py,
                        and the registry matches the port's README knob
                        table
* fault-site-sync     — fault_point() plants == SITE_DESCRIPTIONS, both
                        directions, sites literal
* jit-purity          — no host impurity inside a captured CUDA graph
                        (the callable passed to capture_graph, a
                        `with torch.cuda.graph` body) or one same-module
                        call deep
* thread-lifecycle    — threads are named and joinable in their scope
* donation-aliasing   — a name holding a captured graph's output is not
                        read after a later replay of that graph, except to
                        copy out of it
* contract-key-drift  — required-key schemas are imported from
                        contracts.py, never re-typed
* metric-name-sync    — incremented metric names == declared
                        utils/telemetry.METRIC_DESCRIPTIONS, both
                        directions, names statically resolvable
* planner-constant    — planned runtime quantities (wait-ms, chunk rows,
                        prefetch depth, fusion caps, bucket shape sets)
                        come from planner/ or the knob registry, never
                        magic-number literals
* tolerance-pin       — allclose-style parity comparisons take rtol/atol
                        from contracts.py pinned tolerance tables
                        (PORT_TOLERANCES, TIER_TOLERANCES), never inline
                        numeric literals

Run `python -m photon_ml_tpu_torch.analysis` (`--list-checks`, `--check
<name>`, paths for fixture corpora); zero findings on the live tree is a
tier-1 gate (tests/test_torch_analysis.py). Suppress a finding with
`# photon-lint: disable=<check> — <reason>`; an empty reason is itself a
finding.
"""

from photon_ml_tpu_torch.analysis.core import (  # noqa: F401
    CHECKS,
    Context,
    Finding,
    discover,
    load_paths,
    run_checks,
    run_on,
)

# Importing a check module registers it.
from photon_ml_tpu_torch.analysis import (  # noqa: F401  isort: skip
    contract_key_drift,
    donation_aliasing,
    fault_site_sync,
    jit_purity,
    knob_registry,
    metric_name_sync,
    planner_constant,
    thread_lifecycle,
    tolerance_pin,
)

__all__ = [
    "CHECKS",
    "Context",
    "Finding",
    "discover",
    "load_paths",
    "run_checks",
    "run_on",
]
