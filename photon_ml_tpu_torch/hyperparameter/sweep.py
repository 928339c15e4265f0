"""Batched hyperparameter sweeps: the trial executor.

Port of `photon_ml_tpu/hyperparameter/sweep.py`. The GP/Sobol searchers
(search.py) propose k-candidate batches; `SweepExecutor` is the
`BatchEvaluationFunction` that evaluates a (k, dim) candidate matrix of
regularization weights as trials, three ways:

* **serial**: the reference loop, `run_coordinate_descent` per candidate.
  It is the parity anchor the other two modes are pinned against.
* **stacked**: the reference's chunked mode, kept as bookkeeping. The
  data and the prepared coordinates stay resident once; a round is split
  into chunks of at most PHOTON_SWEEP_MAX_STACK trials (`stack_decisions`
  records every split), each trial runs `run_coordinate_descent` as the
  serial loop does, and the chunk's values come back in one host transfer.
  The reference runs a chunk as one `lax.scan` program, which pays for
  itself in dispatch; eager PyTorch has no single dispatch of a whole fit
  (the L-BFGS keeps its host-side convergence checks), so a second copy of
  the fit would run the same solves in the same order and gain nothing.
  The trial axis is never batched into the solver's lanes or a
  multi-vector kernel: that changes reduction orders and breaks the
  bitwise contract. Stacked trials are bit-equal to serial ones, cold and
  warm (tests/test_torch_sweep.py); unlike the reference's program, they
  pass through the `solve` fault site and its retry as serial ones do.
* **shard_group**: the cards (`parallel.mesh.local_cards`: the CUDA cards,
  or the CPU's CPU_CARDS ordinals, as the reference's tests have 8 host
  devices) are split into groups, the trials go round-robin over them, one
  worker thread a group with its home card (its first) current, each
  running the serial loop on its own copy of the coordinates
  (`group_builder`); the first group, when it is exactly the default
  device, reuses the main coordinates. A group of several cards row-shards
  each random effect's store over them (game/coordinate.py) and gives the
  serial loop's bits.

Each trial's value is the validation suite's primary metric over the
validation offsets plus the trial scorers' margins, summed in update order,
through one function in every mode, so trial values and the searcher's
trajectory do not depend on the mode. Between rounds the executor records a
`TrialRecord` a trial, emits `trial_start`/`trial_finish` journal events
and warm-starts the next round from the incumbent's arrays. `finalize()`
refits the winner cold, so the returned model is bit-equal to a standalone
fit of the winning configuration.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.game.model import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.parallel.mesh import local_cards
from photon_ml_tpu_torch.types import VarianceComputationType
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.knobs import _FALSE as _STACK_OFF
from photon_ml_tpu_torch.utils.knobs import _TRUE as _STACK_ON
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

Tensor = torch.Tensor
Arrays = Dict[str, Optional[Tensor]]

@dataclasses.dataclass
class TrialRecord:
    """One evaluated trial (zipped into the sweep record through
    contracts.SWEEP_TRIAL_KEYS)."""

    trial: int
    round: int
    mode: str
    seconds: float
    value: float
    diverged_steps: int
    point: np.ndarray  # the candidate, in tuned_ids order

    def timing_entry(self) -> Dict[str, object]:
        return {
            "trial": self.trial,
            "round": self.round,
            "mode": self.mode,
            "seconds": round(self.seconds, 4),
            "value": self.value,
            "diverged_steps": self.diverged_steps,
        }


@dataclasses.dataclass
class SweepResult:
    """finalize()'s summary: every trial, the winner, and the winner's cold
    refit (bit-equal to a standalone fit of the winning configuration)."""

    trials: List[TrialRecord]
    best_trial: int
    best_point: np.ndarray
    best_value: float
    winner_model: GameModel
    winner_value: float
    winner_refit_s: float
    stack_decisions: List[Dict[str, object]]


class SweepExecutor:
    """Batched trial evaluation behind the `BatchEvaluationFunction` seam.

    `coordinates` is the ordered id -> coordinate mapping of the main fit;
    `tuned_ids` names the coordinates whose reg weight the candidate columns
    set (the others keep `base_reg_weights`). `trial_scorers[cid](arrays)`
    maps a coordinate's model arrays to validation margins. Build it with
    `GameEstimator.sweep_executor`, which wires the prepared data, the
    scorers and the shard-group builder.
    """

    def __init__(
        self,
        coordinates: Mapping[str, object],
        tuned_ids: Sequence[str],
        num_iterations: int,
        *,
        task,
        base_reg_weights: Mapping[str, float],
        validation_suite,
        validation_offsets: Optional[Tensor],
        num_validation_samples: int,
        trial_scorers: Mapping[str, Callable],
        maximize: bool = False,
        seed: int = 0,
        mode: Optional[str] = None,
        warm_start: bool = True,
        max_stack: Optional[int] = None,
        shard_groups: Optional[int] = None,
        group_builder: Optional[Callable] = None,
        on_event: Optional[Callable] = None,
    ):
        if mode not in (None, "stacked", "shard_group", "serial"):
            raise ValueError(f"unknown sweep mode {mode!r}")
        self.coordinates = dict(coordinates)
        self.ids = list(self.coordinates)
        self.tuned_ids = list(tuned_ids)
        unknown = [c for c in self.tuned_ids if c not in self.coordinates]
        if unknown:
            raise ValueError(f"tuned_ids name unknown coordinates {unknown}")
        self.num_iterations = int(num_iterations)
        self.task = task
        self.base_reg_weights = dict(base_reg_weights)
        self.validation_suite = validation_suite
        self.validation_offsets = validation_offsets
        self.num_validation_samples = int(num_validation_samples)
        self.trial_scorers = dict(trial_scorers)
        self.maximize = bool(maximize)
        self.seed = int(seed)
        self.mode = mode
        self.warm_start = bool(warm_start)
        self.max_stack = max_stack
        self.shard_groups = shard_groups
        self.group_builder = group_builder
        self.on_event = on_event

        first = next(iter(self.coordinates.values())).dataset
        self._num_samples = first.num_samples
        self._base_offsets = first.offsets
        self._dtype = first.labels.dtype
        self._device = first.device

        self.trials: List[TrialRecord] = []
        self.stack_decisions: List[Dict[str, object]] = []
        self._round = 0
        # The incumbent: the best (value, trial, point, arrays) so far,
        # updated the same way in every mode (trial order, strict
        # improvement), so warm-started rounds compare across modes.
        self._best: Optional[Dict[str, object]] = None
        self._group_contexts: Optional[List[Dict[str, object]]] = None
        # The last round's per-trial model arrays, in candidate order (the
        # tests pin stacked == serial on them).
        self.last_trial_models: List[Dict[str, Arrays]] = []

    @property
    def rounds(self) -> int:
        """Proposal rounds evaluated so far."""
        return self._round

    def reset(self) -> None:
        """Forget every evaluated trial; keep the coordinates and the shard
        groups' copies (warm up on throwaway candidates, reset, then run
        the measured sweep)."""
        self.trials.clear()
        self.stack_decisions.clear()
        self.last_trial_models = []
        self._round = 0
        self._best = None

    # ------------------------------------------------------------ model glue

    def _is_re(self, cid: str) -> bool:
        return isinstance(self.coordinates[cid], RandomEffectCoordinate)

    def _re_rows(self, cid: str) -> int:
        return self.coordinates[cid].re_dataset.num_store_rows + 1

    def _want_var(self, cid: str) -> bool:
        return self.coordinates[cid].config.variance_computation != VarianceComputationType.NONE

    def _zero_arrays(self, cid: str) -> Arrays:
        coord = self.coordinates[cid]
        shape = (self._re_rows(cid), coord.dim) if self._is_re(cid) else (coord.dim,)
        zeros = lambda: torch.zeros(shape, dtype=self._dtype, device=self._device)
        var = zeros() if self._want_var(cid) else None
        return {"m": zeros(), "v": var} if self._is_re(cid) else {"w": zeros(), "var": var}

    def _model_to_arrays(self, cid: str, model) -> Arrays:
        if self._is_re(cid):
            if not isinstance(model.coefficients_matrix, Tensor):
                # A shard group's row-sharded store, as rows on its home card.
                model = model.on_device(model.coefficients_matrix.mesh.devices[0])
            return {"m": model.coefficients_matrix, "v": model.variances_matrix}
        return {"w": model.coefficients.means, "var": model.coefficients.variances}

    def _arrays_to_model(self, cid: str, arrays: Arrays):
        if self._is_re(cid):
            return RandomEffectModel(arrays["m"], arrays.get("v"), self.task)
        return FixedEffectModel(Coefficients(arrays["w"], arrays.get("var")), self.task)

    def _arrays_to_game_model(self, arrays_by_cid: Mapping[str, Arrays]) -> GameModel:
        return GameModel({c: self._arrays_to_model(c, a) for c, a in arrays_by_cid.items()})

    def _trial_arrays(self, cid: str, game_model: GameModel) -> Arrays:
        """A trained coordinate's arrays, or the zeros model when every
        update of the coordinate was rejected and the loop kept no model."""
        if cid in game_model:
            return self._model_to_arrays(cid, game_model[cid])
        return self._zero_arrays(cid)

    # ------------------------------------------------------------- valuation

    def _value_device(self, arrays_by_cid: Mapping[str, Arrays]) -> Tensor:
        """The trial value as a device scalar: the primary metric of the
        validation offsets plus each coordinate's margins, summed in update
        order. Every mode values through here."""
        total = self.validation_offsets
        if total is None:
            total = torch.zeros(self.num_validation_samples, dtype=self._dtype,
                                device=self._device)
        for cid in self.ids:
            total = total + self.trial_scorers[cid](arrays_by_cid[cid])
        suite = self.validation_suite
        metric = suite.metric_fn(suite.primary)(total, suite.labels, suite.weights)
        return metric.to(torch.float32)

    def _value_of(self, arrays_by_cid: Mapping[str, Arrays]) -> float:
        return float(self._value_device(arrays_by_cid))

    # ----------------------------------------------------------- mode choice

    def _stackable(self) -> bool:
        # `entity_sharded` is true on ranks and over a card mesh (`entity_mesh`).
        return not any(getattr(c, "entity_sharded", False) for c in self.coordinates.values())

    def _num_cards(self) -> int:
        return torch.cuda.device_count() if self._device.type == "cuda" else 1

    def _choose_mode(self, k: int) -> str:
        if self.mode is not None:
            return self.mode
        knob = str(get_knob("PHOTON_SWEEP_TRIAL_STACK")).strip().lower()
        multi = self._num_cards() > 1 and self.group_builder is not None
        if knob in _STACK_ON:
            if not self._stackable():
                raise ValueError(
                    "PHOTON_SWEEP_TRIAL_STACK forces trial stacking, but a coordinate's "
                    "store is entity-sharded; stacked trials need the one-process store "
                    "(use shard groups)")
            return "stacked"
        if knob in _STACK_OFF:
            return "shard_group" if multi else "serial"
        if self._stackable():
            return "stacked"
        return "shard_group" if multi else "serial"

    # --------------------------------------------------------- public driver

    def evaluate_point(self, point: np.ndarray) -> float:
        """Scalar `EvaluationFunction` adapter (a one-candidate round)."""
        return self.evaluate_batch(np.atleast_2d(np.asarray(point)))[0]

    def evaluate_batch(self, points: np.ndarray) -> List[float]:
        """Evaluate a (k, dim) candidate matrix; returns k values in order,
        records the TrialRecords, emits the trial events and advances the
        warm-start incumbent."""
        points = np.atleast_2d(np.asarray(points, np.float64))
        k = points.shape[0]
        if points.shape[1] != len(self.tuned_ids):
            raise ValueError(f"candidate matrix has {points.shape[1]} columns for "
                             f"{len(self.tuned_ids)} tuned coordinates")
        mode = self._choose_mode(k)
        round_idx = self._round
        self._round += 1
        base_trial = len(self.trials)
        for i in range(k):
            self._emit("trial_start", round=round_idx, trial=base_trial + i, mode=mode)
        warm = self._best["arrays"] if (self.warm_start and self._best) else None
        with telemetry.span("sweep_round", round=round_idx, mode=mode, trials=k):
            if mode == "stacked":
                out = self._evaluate_stacked(points, warm)
            elif mode == "shard_group":
                out = self._evaluate_shard_group(points, warm)
            else:
                out = self._evaluate_serial(points, warm)
        values, models, seconds, diverged = out
        self.last_trial_models = models
        records = []
        for i in range(k):
            rec = TrialRecord(trial=base_trial + i, round=round_idx, mode=mode,
                              seconds=seconds[i], value=values[i], diverged_steps=diverged[i],
                              point=points[i].copy())
            records.append(rec)
            self.trials.append(rec)
            self._update_incumbent(rec, models[i])
        for rec in records:
            self._emit("trial_finish", round=rec.round, trial=rec.trial, mode=rec.mode,
                       seconds=rec.seconds, value=rec.value, diverged_steps=rec.diverged_steps)
        return values

    def finalize(self) -> SweepResult:
        """Cold refit of the winning configuration through the serial loop:
        the returned model is bit-equal to a standalone fit of it (the
        warm-started trial models are search artifacts)."""
        if self._best is None:
            raise ValueError("finalize() needs at least one evaluated trial")
        best = self._best
        t0 = time.perf_counter()
        cd = run_coordinate_descent(self.coordinates, self.num_iterations,
                                    reg_weights=self._rw_map(best["point"]), seed=self.seed)
        winner_value = self._value_of({cid: self._trial_arrays(cid, cd.model) for cid in self.ids})
        refit_s = time.perf_counter() - t0
        return SweepResult(
            trials=list(self.trials),
            best_trial=int(best["trial"]),
            best_point=np.asarray(best["point"]),
            best_value=float(best["value"]),
            winner_model=cd.model,
            winner_value=winner_value,
            winner_refit_s=refit_s,
            stack_decisions=list(self.stack_decisions),
        )

    # ---------------------------------------------------------------- shared

    def _emit(self, etype: str, **fields) -> None:
        telemetry.emit_event(etype, **fields)
        if self.on_event is not None:
            try:
                self.on_event(etype, **fields)
            except Exception:  # noqa: BLE001 - an observer must not kill trials
                logger.warning("sweep on_event hook failed", exc_info=True)

    def _rw_map(self, point: np.ndarray) -> Dict[str, float]:
        """Every coordinate's reg weight as a Python float: the one route a
        weight takes into the objective, in every mode."""
        rw = {cid: float(w) for cid, w in self.base_reg_weights.items()}
        for j, cid in enumerate(self.tuned_ids):
            rw[cid] = float(point[j])
        return rw

    def _update_incumbent(self, rec: TrialRecord, arrays) -> None:
        v = rec.value
        if not np.isfinite(v):
            return
        better = self._best is None or (
            v > self._best["value"] if self.maximize else v < self._best["value"])
        if better:
            self._best = {"value": v, "trial": rec.trial, "point": rec.point, "arrays": arrays}

    # ---------------------------------------------------------------- serial

    def _evaluate_serial(self, points, warm):
        """The reference's per-trial loop (`run_coordinate_descent` per
        candidate): the parity anchor."""
        initial = self._arrays_to_game_model(warm) if warm is not None else None
        values, models, seconds, diverged = [], [], [], []
        for i in range(points.shape[0]):
            t0 = time.perf_counter()
            with telemetry.span("sweep_trial", index=i, mode="serial"):
                cd = run_coordinate_descent(self.coordinates, self.num_iterations,
                                            initial_models=initial,
                                            reg_weights=self._rw_map(points[i]), seed=self.seed)
            arrays = {cid: self._trial_arrays(cid, cd.model) for cid in self.ids}
            values.append(self._value_of(arrays))
            models.append(arrays)
            seconds.append(time.perf_counter() - t0)
            diverged.append(int(cd.diverged_steps))
        return values, models, seconds, diverged

    # --------------------------------------------------------------- stacked

    def _stack_plan(self, k: int) -> List[int]:
        cap = self.max_stack
        if cap is None:
            cap = int(get_knob("PHOTON_SWEEP_MAX_STACK"))
        cap = max(1, cap)
        chunks = [cap] * (k // cap)
        if k % cap:
            chunks.append(k % cap)
        self.stack_decisions.append({"k": k, "max_stack": cap, "chunks": list(chunks)})
        return chunks

    def _evaluate_stacked(self, points, warm):
        """The serial loop in chunks, each chunk's values fetched in one
        host transfer."""
        initial = self._arrays_to_game_model(warm) if warm is not None else None
        values, models, seconds, diverged = [], [], [], []
        start = 0
        for chunk in self._stack_plan(points.shape[0]):
            t0 = time.perf_counter()
            device_values = []
            for i in range(start, start + chunk):
                with telemetry.span("sweep_trial", index=i, mode="stacked"):
                    cd = run_coordinate_descent(self.coordinates, self.num_iterations,
                                                initial_models=initial,
                                                reg_weights=self._rw_map(points[i]),
                                                seed=self.seed)
                arrays = {cid: self._trial_arrays(cid, cd.model) for cid in self.ids}
                device_values.append(self._value_device(arrays))
                models.append(arrays)
                diverged.append(int(cd.diverged_steps))
            values.extend(torch.stack(device_values).cpu().tolist())
            wall = time.perf_counter() - t0
            seconds.extend([wall / chunk] * chunk)
            start += chunk
        return values, models, seconds, diverged

    # ------------------------------------------------------------ shard group

    def _groups(self) -> List[Dict[str, object]]:
        if self._group_contexts is not None:
            return self._group_contexts
        if self.group_builder is None:
            raise ValueError("shard-group evaluation needs a group_builder (build the executor "
                             "through GameEstimator.sweep_executor)")
        g = self.shard_groups
        if g is None:
            g = int(get_knob("PHOTON_SWEEP_SHARD_GROUPS"))
        devices = local_cards(self._device)
        if g <= 0:
            g = len(devices)
        g = max(1, min(g, len(devices)))
        # Balanced split: the first len(devices) % g groups take one more.
        base, extra = divmod(len(devices), g)
        contexts = []
        cursor = 0
        for gi in range(g):
            size = base + (1 if gi < extra else 0)
            devs = devices[cursor:cursor + size]
            cursor += size
            if gi == 0 and size == 1 and devs[0] == self._device and self._stackable():
                # The group that is exactly the default device reuses the
                # main (resident) coordinates.
                coords = self.coordinates
            else:
                coords = self.group_builder(devs)
            contexts.append({"index": gi, "devices": devs, "coordinates": coords})
        logger.info("sweep shard groups: %s",
                    " + ".join(f"{c['devices'][0]}x{len(c['devices'])}" for c in contexts))
        self._group_contexts = contexts
        return contexts

    def _place_warm(self, warm, devices):
        """Warm-start arrays for a group, on its home card: one device's
        group trains from them there, and a group of several cards reshards
        a random effect's matrix onto its mesh in `train` (JAX
        sweep.py:857-875 replicates them over the group)."""
        if warm is None:
            return None
        home = devices[0]
        return {cid: {name: None if a is None else a.to(home) for name, a in arrays.items()}
                for cid, arrays in warm.items()}

    def _evaluate_shard_group(self, points, warm):
        contexts = self._groups()
        g, k = len(contexts), points.shape[0]
        results: List[Optional[tuple]] = [None] * k
        errors: List[BaseException] = []

        def worker(ctx, trial_idxs):
            dev = ctx["devices"][0]
            placed = self._place_warm(warm, ctx["devices"])
            initial = self._arrays_to_game_model(placed) if placed is not None else None
            for i in trial_idxs:
                t0 = time.perf_counter()
                with telemetry.span("sweep_trial", index=int(i), mode="shard_group",
                                    group=ctx["index"]):
                    cd = run_coordinate_descent(ctx["coordinates"], self.num_iterations,
                                                initial_models=initial,
                                                reg_weights=self._rw_map(points[i]),
                                                seed=self.seed)
                    if dev.type == "cuda":
                        # The trial's wall ends when its cards have finished.
                        for d in dict.fromkeys(ctx["devices"]):
                            torch.cuda.synchronize(d)
                results[i] = (cd, time.perf_counter() - t0)

        span_h = telemetry.span_handoff()

        def run_worker(ctx, idxs):
            try:
                with telemetry.adopt_span(span_h):
                    dev = ctx["devices"][0]
                    if dev.type == "cuda":
                        # The current card is per thread: name it.
                        with torch.cuda.device(dev):
                            worker(ctx, idxs)
                    else:
                        worker(ctx, idxs)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        threads = []
        for gi, ctx in enumerate(contexts):
            idxs = list(range(gi, k, g))
            if not idxs:
                continue
            t = threading.Thread(target=run_worker, args=(ctx, idxs),
                                 name=f"photon-sweep-group-{gi}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        values, models, seconds, diverged = [], [], [], []
        for i in range(k):
            cd, wall = results[i]
            # The trial's model back on the main device, where valuation and
            # the warm-start state live.
            arrays = {cid: {name: None if a is None else a.to(self._device)
                            for name, a in self._trial_arrays(cid, cd.model).items()}
                      for cid in self.ids}
            values.append(self._value_of(arrays))
            models.append(arrays)
            seconds.append(wall)
            diverged.append(int(cd.diverged_steps))
        return values, models, seconds, diverged
