"""Deterministic fault injection and bounded retry.

Port of `photon_ml_tpu/utils/faults.py`:

* `FaultPlan` / `install` / `fault_point(site)`: a seeded, deterministic
  injection registry. A plan arms a site for its first N invocations
  (`site:N`), for explicit 1-based invocations (`site@i+j`), or with a
  seeded probability per invocation (`site:pX`, keyed on (seed, site,
  invocation) through `_mix64`), so a chaos run replays the same failure
  schedule. `PHOTON_FAULTS` / `PHOTON_FAULTS_SEED` arm a plan from the
  environment. An armed `fault_point` raises `InjectedFault`. The site
  registry is the reference's whole table, so a plan naming any of its
  sites parses here as there; the serving tier fires `lookup`, `score`,
  `admit`, `swap_stage`, `swap_commit` and `shard_upload`, its reshard
  `reshard_stage` and `reshard_commit`; a host-dispatched gather over the
  cards of one process (parallel/mesh.dispatch_collective: the
  transformer's over a row-sharded matrix) fires `collective` once per
  attempt, retried PHOTON_COLLECTIVE_RETRIES times and counted in
  `collective_retries`; coordinate
  descent fires `solve` once per attempt of an update and `mesh_loss` once
  per update; the checkpoint fires `checkpoint_write` and `resume_load`;
  the native ingest fires `decode` once per attempt of a file's read; the
  multi-host heartbeat fires `host_loss`, and a rejoining multi-host
  serving worker `host_join`.
* `MeshLoss` and its `HostLoss`: the loss of part of the ranks, never
  transient.
* `solve_retry_attempts()`: the extra attempts the divergence guard grants
  a rejected coordinate update (`PHOTON_SOLVE_RETRIES`).
* `retry(fn, policy)`: bounded exponential backoff around transient
  failures (`PHOTON_RETRY_MAX_ATTEMPTS`, `PHOTON_RETRY_BASE_DELAY_S`,
  `PHOTON_RETRY_MAX_DELAY_S`). Transient: injected faults, watchdog hangs,
  host I/O errors and the CUDA runtime's errors (`torch.AcceleratorError`
  where this torch has it, else a RuntimeError whose message begins
  "CUDA error"), the counterpart of the reference's `XlaRuntimeError`.
* `COUNTERS`: the process-wide robustness counters, a view of
  `utils/telemetry.METRICS`.

None of this changes what is computed, only whether work is retried or
degraded.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Callable, Dict, FrozenSet, Mapping, Optional

from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

# The reference's site registry, verbatim: every site a plan may name.
SITE_DESCRIPTIONS = {
    "decode": "Avro block decode in the ingest data plane",
    # photon-lint: disable=fault-site-sync — the registry stays the reference's verbatim (a plan
    # naming it parses in both packages); the port has no host CSR->ELL pack to plant it in.
    "pack": "host-side CSR->ELL pack (background pack pool)",
    # photon-lint: disable=fault-site-sync — the registry stays the reference's verbatim; the port
    # builds its layouts on the card and has no AsyncUploader job to plant it in.
    "upload": "host->device shard upload (AsyncUploader jobs)",
    "solve": "per-coordinate device solve in coordinate descent",
    "checkpoint_write": "durable checkpoint writes (state.json + model npz)",
    "lookup": "serving entity-id -> coefficient-row resolution",
    "score": "serving batched device dispatch (upload + fused program)",
    "admit": "serving admission control (an armed fault sheds the request)",
    "swap_stage": "bundle hot-swap staging (build + upload + warm the next bundle)",
    "swap_commit": "bundle hot-swap commit (the atomic flip between batches)",
    "collective": "mesh collective program dispatch (ring gather/scatter, "
    "psum bcast-gather, scan sweeps over them)",
    "shard_upload": "per-shard serving model staging (bundle build + "
    "shard restage after loss)",
    "promote": "two-tier serving store promotion (cold row -> HBM hot set)",
    "resume_load": "checkpoint model/shard file reads on resume",
    "mesh_loss": "device-mesh loss during a sharded coordinate update "
    "(sweep-boundary elastic resume)",
    "reshard_stage": "live serving reshard staging (per-shard upload of "
    "moved coefficient rows)",
    "reshard_commit": "live serving reshard commit (the atomic generation "
    "flip between batches)",
    "tenant_admit": "multi-tenant registry admission (staging a named "
    "tenant's bundle onto the shared fleet)",
    "tenant_evict": "multi-tenant cold-tenant demotion (RE rows to the "
    "host tier under HBM pressure)",
    "host_loss": "whole-host loss in the multi-host process group "
    "(heartbeat-detected dead peer; supervisor relaunch on survivors)",
    "host_join": "host rejoin into the multi-host serving fleet "
    "(restage of the lost host's row partition)",
    "shadow_mirror": "shadow traffic mirroring (submit of the challenger's "
    "co-batched copy of a champion request)",
    "label_join": "online-evaluation label join (uid -> label arrival into "
    "the shadow scoring window)",
    "shadow_promote": "shadow promotion (the challenger -> champion "
    "BundleManager generation flip)",
    "autopilot_act": "autopilot actuation (applying a ControlRule's "
    "decided action through the serving actuators)",
    "quantize_stage": "precision-ladder demotion build (quantizing a "
    "tenant's RE row planes to bf16/int8 — bounded retry; a terminal "
    "failure rolls back with the old generation still serving)",
    "tier_restore": "precision-ladder restore build (walking a tenant's "
    "RE row planes back toward f32 from the retained host copies — "
    "bounded retry; a terminal failure leaves the quantized generation "
    "serving)",
}
KNOWN_SITES = tuple(SITE_DESCRIPTIONS)


class InjectedFault(RuntimeError):
    """Raised by an armed `fault_point`. Always classified transient."""


class DeviceHang(RuntimeError):
    """A device dispatch exceeded its watchdog deadline (utils/watchdog.py).
    Classified transient and device-shaped: the serving breaker counts it
    toward opening."""


class MeshLoss(RuntimeError):
    """Part of the ranks is gone mid-fit: the fault no retry in place can
    fix, because the same work would meet the same dead peer. Not transient:
    `retry` never spins on it. Coordinate descent raises it from the armed
    `mesh_loss` site, once per coordinate update, and lets it propagate: on
    ranks a lost device is a lost process, so only a relaunch of the
    survivors (parallel/hostmesh.supervise) recovers, from the checkpoint."""


class HostLoss(MeshLoss):
    """A whole rank of the multi-host process group is gone, detected by the
    heartbeat (parallel/hostmesh.HostHeartbeat) or a barrier that a rank never
    reached. The worker journals `host_loss` and exits `EXIT_HOST_LOSS`; the
    supervisor relaunches the surviving ranks, which resume from the last
    committed checkpoint step."""


# --------------------------------------------------------------- fault plans


def _mix64(*parts: int) -> int:
    """splitmix64-style avalanche over the parts."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (p & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 30
        x = x * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """When one site fires: its first N invocations, explicit 1-based
    invocations, and/or a seeded probability per invocation."""

    first_n: int = 0
    indices: FrozenSet[int] = frozenset()
    probability: float = 0.0

    def should_fail(self, site: str, invocation: int, seed: int) -> bool:
        if invocation <= self.first_n or invocation in self.indices:
            return True
        if self.probability > 0.0:
            h = _mix64(seed, zlib.crc32(site.encode()), invocation)
            return (h >> 11) / float(1 << 53) < self.probability
        return False


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable site -> SiteSpec schedule and the probability seed."""

    sites: Mapping[str, SiteSpec]
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """`"lookup:1,score@3+5,admit:p0.25"`; an unknown site raises."""
        sites: Dict[str, SiteSpec] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "@" in part:
                site, _, idx = part.partition("@")
                entry = SiteSpec(indices=frozenset(int(i) for i in idx.split("+")))
            elif ":" in part:
                site, _, val = part.partition(":")
                val = val.strip()
                if val.startswith("p"):
                    entry = SiteSpec(probability=float(val[1:]))
                else:
                    entry = SiteSpec(first_n=int(val))
            else:
                site, entry = part, SiteSpec(first_n=1)
            site = site.strip()
            if site not in KNOWN_SITES:
                raise ValueError(f"unknown fault site {site!r} in {spec!r} "
                                 f"(known: {', '.join(KNOWN_SITES)})")
            prev = sites.get(site, SiteSpec())
            sites[site] = SiteSpec(first_n=max(prev.first_n, entry.first_n),
                                   indices=prev.indices | entry.indices,
                                   probability=max(prev.probability, entry.probability))
        return cls(sites=sites, seed=seed)


class FaultInjector:
    """A plan and thread-safe per-site invocation and injection counts."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.invocations: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self._lock = threading.Lock()

    def fire(self, site: str) -> None:
        with self._lock:
            n = self.invocations.get(site, 0) + 1
            self.invocations[site] = n
            spec = self.plan.sites.get(site)
            fail = spec is not None and spec.should_fail(site, n, self.plan.seed)
            if fail:
                self.injected[site] = self.injected.get(site, 0) + 1
        if fail:
            COUNTERS.increment("injected_faults")
            telemetry.emit_event("fault_injected", site=site, invocation=n)
            logger.warning("injected fault at site %r (invocation %d)", site, n)
            raise InjectedFault(f"injected fault at site {site!r} (invocation {n})")


_LOCK = threading.Lock()
_INJECTOR: Optional[FaultInjector] = None
_ENV_CHECKED = False


def install(plan, seed: int = 0) -> FaultInjector:
    """Arm a plan (a FaultPlan or a spec string) process-wide."""
    global _INJECTOR, _ENV_CHECKED
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan, seed=seed)
    with _LOCK:
        _INJECTOR = FaultInjector(plan)
        _ENV_CHECKED = True
    return _INJECTOR


def clear() -> None:
    """Disarm injection; the next `fault_point` reads PHOTON_FAULTS again."""
    global _INJECTOR, _ENV_CHECKED
    with _LOCK:
        _INJECTOR = None
        _ENV_CHECKED = False


def active_injector() -> Optional[FaultInjector]:
    """The armed injector, armed from PHOTON_FAULTS on first call."""
    global _INJECTOR, _ENV_CHECKED
    if _INJECTOR is not None:
        return _INJECTOR
    if _ENV_CHECKED:
        return None
    with _LOCK:
        if not _ENV_CHECKED:
            _ENV_CHECKED = True
            spec = str(get_knob("PHOTON_FAULTS")).strip()
            if spec:
                _INJECTOR = FaultInjector(FaultPlan.parse(spec, seed=int(get_knob("PHOTON_FAULTS_SEED"))))
    return _INJECTOR


def fault_point(site: str) -> None:
    """Raise InjectedFault when `site` is armed; a no-op otherwise."""
    inj = active_injector()
    if inj is not None:
        inj.fire(site)


@contextmanager
def inject(spec: str, seed: int = 0):
    """Arm `spec` for the scope, yield the injector, disarm on exit."""
    inj = install(spec, seed=seed)
    try:
        yield inj
    finally:
        clear()


# ------------------------------------------------------------------ counters


class _Counters:
    """The process-wide robustness counters: a view of telemetry.METRICS."""

    def increment(self, name: str, by: int = 1, labels=None) -> None:
        telemetry.METRICS.increment(name, by, labels=labels)

    def get(self, name: str) -> int:
        return telemetry.METRICS.get_counter(name)

    def snapshot(self) -> Dict[str, int]:
        return telemetry.METRICS.counters()


COUNTERS = _Counters()


def counters() -> Dict[str, int]:
    return COUNTERS.snapshot()


# --------------------------------------------------------------------- retry


def _is_cuda_runtime_error(exc: BaseException) -> bool:
    """The CUDA runtime's errors as torch raises them."""
    import torch

    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return type(exc) is RuntimeError and str(exc).startswith("CUDA error")


def _default_transient(exc: BaseException) -> bool:
    """Injected faults, watchdog hangs, host I/O failures and CUDA runtime
    errors. Programming errors (TypeError, ValueError, KeyError, ...) are
    not retried: they would fail the same way again."""
    if isinstance(exc, (InjectedFault, DeviceHang, OSError, ConnectionError, TimeoutError)):
        return True
    return _is_cuda_runtime_error(exc)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt k sleeps min(base * backoff**(k-1), max_delay) before retrying."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff: float = 2.0
    is_transient: Callable[[BaseException], bool] = _default_transient

    def delay(self, attempt: int) -> float:
        return min(self.base_delay_s * self.backoff ** max(0, attempt - 1), self.max_delay_s)


def default_policy() -> RetryPolicy:
    """The policy the PHOTON_RETRY_* knobs set."""
    return RetryPolicy(max_attempts=max(1, int(get_knob("PHOTON_RETRY_MAX_ATTEMPTS"))),
                       base_delay_s=float(get_knob("PHOTON_RETRY_BASE_DELAY_S")),
                       max_delay_s=float(get_knob("PHOTON_RETRY_MAX_DELAY_S")))


def bounded_policy(extra_attempts: int) -> RetryPolicy:
    """The default policy with 1 + `extra_attempts` attempts."""
    return dataclasses.replace(default_policy(), max_attempts=1 + max(0, int(extra_attempts)))


def retry(fn: Callable[[], object], policy: Optional[RetryPolicy] = None, *,
          label: str = "operation", counter: str = "retries",
          sleep: Callable[[float], None] = time.sleep):
    """Run `fn`, retrying transient failures under `policy`; each retry
    counts into COUNTERS[counter]. The last failure propagates unchanged."""
    policy = policy or default_policy()
    attempt = 1
    while True:
        try:
            return fn()
        except BaseException as exc:  # re-raised when final
            if attempt >= policy.max_attempts or not policy.is_transient(exc):
                raise
            delay = policy.delay(attempt)
            COUNTERS.increment(counter)
            telemetry.emit_event("fault_retry", label=label, counter=counter, attempt=attempt,
                                 error=repr(exc))
            logger.warning("transient failure in %s (attempt %d/%d): %s; retrying in %.2fs",
                           label, attempt, policy.max_attempts, exc, delay)
            sleep(delay)
            attempt += 1


def is_device_error(exc: BaseException) -> bool:
    """True for failures of the device or transport, which the serving
    circuit breaker counts (a malformed request is the request's fault)."""
    return _default_transient(exc)


def solve_retry_attempts() -> int:
    """Extra solve attempts the divergence guard grants a rejected
    (non-finite) coordinate update before keeping the last-good model
    (PHOTON_SOLVE_RETRIES, default 1). One retry makes a transient
    non-finite solve (an injected fault, a flaky card) converge back to the
    fault-free result bit for bit; a deterministic divergence reproduces on
    retry and falls through to last-good after one extra solve."""
    return max(0, int(get_knob("PHOTON_SOLVE_RETRIES")))


# ------------------------------------------------------------------ CLI


def main(argv=None) -> int:
    """`python -m photon_ml_tpu_torch.utils.faults --list-sites`: print the
    registered fault sites (site, what the ambient PHOTON_FAULTS plan arms
    at it, description), as the reference's command does."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m photon_ml_tpu_torch.utils.faults",
                                description="Inspect the deterministic fault-injection registry.")
    p.add_argument("--list-sites", action="store_true",
                   help="print every registered fault site and any armed plan")
    args = p.parse_args(argv)
    if not args.list_sites:
        p.print_help()
        return 2
    inj = active_injector()
    armed = dict(inj.plan.sites) if inj is not None else {}
    width = max(len(s) for s in KNOWN_SITES)
    print(f"{'site'.ljust(width)}  armed  description")
    for site in KNOWN_SITES:
        spec = armed.get(site)
        bits = []
        if spec is not None:
            if spec.first_n:
                bits.append(f"first {spec.first_n}")
            if spec.indices:
                bits.append("@" + "+".join(str(i) for i in sorted(spec.indices)))
            if spec.probability:
                bits.append(f"p={spec.probability}")
        tag = ",".join(bits) or "-"
        print(f"{site.ljust(width)}  {tag:5s}  {SITE_DESCRIPTIONS[site]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
