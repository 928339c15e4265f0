"""Random (Sobol) and Bayesian (GP + EI) hyperparameter search.

The port's copy of `photon_ml_tpu/hyperparameter/search.py`, on the port's
GP (gp.py: float64 torch on the CPU). Counterpart of photon-lib hyperparameter/search/ (RandomSearch.scala:34-183,
GaussianProcessSearch.scala:52-197) plus VectorRescaling.scala and
HyperparameterSerialization.scala. Candidates are drawn from a Sobol
quasi-random sequence in the unit cube (the reference uses commons-math3's
SobolSequenceGenerator; here scipy.stats.qmc.Sobol), rescaled to each
parameter's range with optional log transform, and evaluated through a
user evaluation function. Bayesian mode fits a GP to all observations and
picks the argmax of Expected Improvement over a 250-candidate Sobol pool
(candidatePoolSize, GaussianProcessSearch.scala:52-113).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.hyperparameter.gp import fit_gp

EvaluationFunction = Callable[[np.ndarray], float]
# Batch evaluation: (k, dim) candidate matrix -> k values. How trials run in
# parallel is the caller's choice; the searchers only need the values back.
BatchEvaluationFunction = Callable[[np.ndarray], Sequence[float]]

CANDIDATE_POOL_SIZE = 250  # GaussianProcessSearch.scala:52


@dataclasses.dataclass(frozen=True)
class HyperparameterConfig:
    """One tunable parameter (HyperparameterConfig.scala + tuning JSON doc).

    `transform`: None or "LOG" (VectorRescaling log-scale handling).
    """

    name: str
    min_value: float
    max_value: float
    transform: Optional[str] = None
    discrete: bool = False


def forward_scale(values: np.ndarray, configs: Sequence[HyperparameterConfig]) -> np.ndarray:
    """Parameter space -> unit cube (VectorRescaling.scaleForward)."""
    out = np.empty_like(values, dtype=np.float64)
    for i, c in enumerate(configs):
        lo, hi = c.min_value, c.max_value
        v = values[..., i]
        if c.transform == "LOG":
            lo, hi = np.log10(lo), np.log10(hi)
            v = np.log10(v)
        out[..., i] = (v - lo) / (hi - lo)
    return out


def backward_scale(unit: np.ndarray, configs: Sequence[HyperparameterConfig]) -> np.ndarray:
    """Unit cube -> parameter space (VectorRescaling.scaleBackward)."""
    out = np.empty_like(unit, dtype=np.float64)
    for i, c in enumerate(configs):
        lo, hi = c.min_value, c.max_value
        if c.transform == "LOG":
            llo, lhi = np.log10(lo), np.log10(hi)
            v = 10.0 ** (unit[..., i] * (lhi - llo) + llo)
        else:
            v = unit[..., i] * (hi - lo) + lo
        if c.discrete:
            v = np.clip(np.round(v), lo, hi)
        out[..., i] = v
    return out


@dataclasses.dataclass
class Observation:
    point: np.ndarray  # parameter space
    value: float


@dataclasses.dataclass
class SearchResult:
    observations: List[Observation]
    best_point: np.ndarray
    best_value: float


class RandomSearch:
    """Sobol quasi-random search (RandomSearch.scala:34-110)."""

    def __init__(
        self,
        configs: Sequence[HyperparameterConfig],
        evaluation_function: EvaluationFunction,
        *,
        maximize: bool = False,
        seed: int = 1,
    ):
        self.configs = list(configs)
        self.evaluation_function = evaluation_function
        self.maximize = maximize
        self.dim = len(self.configs)
        from scipy.stats import qmc  # here: scipy.stats takes seconds to import

        self._sobol = qmc.Sobol(d=self.dim, scramble=True, seed=seed)
        # Power-of-two draw buffer: scipy's Sobol.random warns on every
        # non-power-of-two draw (balance properties), and this searcher
        # draws 250-point candidate pools and arbitrary-k batches all the
        # time. _sobol_draw tops the buffer up in power-of-two blocks and
        # slices — the SERVED point stream is the same sequence prefix the
        # direct draws produced, warning-free.
        self._sobol_buffer = np.empty((0, self.dim), np.float64)
        self.observations: List[Observation] = []
        self.prior_observations: List[Observation] = []

    def _sobol_draw(self, m: int) -> np.ndarray:
        """The next `m` Sobol points, via power-of-two block draws."""
        while len(self._sobol_buffer) < m:
            need = m - len(self._sobol_buffer)
            block = 1 << max(0, (need - 1).bit_length())
            self._sobol_buffer = np.concatenate(
                [self._sobol_buffer, self._sobol.random(block)]
            )
        out = self._sobol_buffer[:m]
        self._sobol_buffer = self._sobol_buffer[m:]
        return out

    # -- candidate proposal (overridden by the GP search) --------------------

    def propose(self) -> np.ndarray:
        return backward_scale(self._sobol_draw(1)[0], self.configs)

    def propose_batch(self, k: int) -> np.ndarray:
        """k candidates for one parallel round. Sobol draws are quasi-random
        and space-filling, so a plain batch is already diverse."""
        return backward_scale(self._sobol_draw(k), self.configs)

    def on_observation(self, obs: Observation) -> None:
        pass

    # -- drive loop (findWithPriors / findWithPriorObservations / find) ------

    def find(self, n: int) -> SearchResult:
        for _ in range(n):
            point = self.propose()
            value = float(self.evaluation_function(point))
            obs = Observation(point, value)
            self.observations.append(obs)
            self.on_observation(obs)
        return self._result()

    def find_batched(
        self,
        n: int,
        batch_size: int,
        batch_evaluation_function: Optional[BatchEvaluationFunction] = None,
    ) -> SearchResult:
        """Run ~n trials in rounds of `batch_size` parallel evaluations.

        The reference's search loop is inherently serial — one full training
        run per observation (GameTrainingDriver.scala:643-680); the trials of
        a round can be evaluated together, so the searchers support proposing
        a whole round at once.
        `batch_evaluation_function` evaluates a (k, dim) candidate matrix;
        when omitted, candidates are mapped through the scalar evaluation
        function one by one (same results, no parallelism). With
        batch_size <= 1, a provided batch function still evaluates each
        single-candidate round (it is never silently dropped).
        """
        if batch_size <= 1 and batch_evaluation_function is None:
            return self.find(n)
        batch_size = max(batch_size, 1)
        done = 0
        while done < n:
            k = min(batch_size, n - done)
            points = self.propose_batch(k)
            if batch_evaluation_function is not None:
                values = list(batch_evaluation_function(points))
                if len(values) != k:
                    raise ValueError(
                        f"batch evaluation returned {len(values)} values for {k} candidates"
                    )
            else:
                values = [float(self.evaluation_function(p)) for p in points]
            for p, v in zip(points, values):
                obs = Observation(np.asarray(p, np.float64), float(v))
                self.observations.append(obs)
                self.on_observation(obs)
            done += k
        return self._result()

    def seed_priors(self, priors: Sequence[Tuple[np.ndarray, float]]) -> None:
        """Record observations from earlier runs without evaluating them."""
        for p, v in priors:
            obs = Observation(np.asarray(p, np.float64), float(v))
            self.prior_observations.append(obs)
            self.on_observation(obs)

    def find_with_priors(
        self, n: int, priors: Sequence[Tuple[np.ndarray, float]]
    ) -> SearchResult:
        """Seed the search with observations from earlier runs
        (findWithPriors, RandomSearch.scala:61-90)."""
        self.seed_priors(priors)
        return self.find(n)

    def _result(self) -> SearchResult:
        if not self.observations:
            raise ValueError("no observations")
        key = (lambda o: -o.value) if self.maximize else (lambda o: o.value)
        best = min(self.observations, key=key)
        return SearchResult(self.observations, best.point, best.value)


class GaussianProcessSearch(RandomSearch):
    """Bayesian search: GP posterior + Expected Improvement over a Sobol
    candidate pool (GaussianProcessSearch.scala:52-197)."""

    def __init__(
        self,
        configs: Sequence[HyperparameterConfig],
        evaluation_function: EvaluationFunction,
        *,
        maximize: bool = False,
        seed: int = 1,
        candidate_pool_size: int = CANDIDATE_POOL_SIZE,
        min_observations: int = 2,
        kernel: str = "matern52",
    ):
        super().__init__(configs, evaluation_function, maximize=maximize, seed=seed)
        self.candidate_pool_size = candidate_pool_size
        self.min_observations = min_observations
        self.kernel = kernel
        self._rng = np.random.default_rng(seed)

    def _fit(self):
        all_obs = self.prior_observations + self.observations
        if len(all_obs) < self.min_observations:
            return None
        x = np.stack([forward_scale(o.point, self.configs) for o in all_obs])
        y = np.asarray([o.value for o in all_obs])
        return fit_gp(
            x,
            y,
            kernel=self.kernel,
            maximize=self.maximize,
            seed=int(self._rng.integers(1 << 31)),
        )

    def propose(self) -> np.ndarray:
        model = self._fit()
        if model is None:
            return super().propose()
        pool = self._sobol_draw(self.candidate_pool_size)
        ei = model.expected_improvement(pool)
        return backward_scale(pool[int(np.argmax(ei))], self.configs)

    def propose_batch(self, k: int) -> np.ndarray:
        """qEI via the constant-liar heuristic: fit once, then pick argmax EI
        k times, each time conditioning the SAME sampled kernels on a fantasy
        observation at the picked point with the current best ("CL-min")
        value. The fantasy collapses predictive variance around prior picks,
        so EI moves elsewhere — a diverse batch without re-running the slice
        sampler per pick (kernel hyperparameters are reused).

        Pick 0 comes from the UNPADDED model, so it equals the plain EI
        argmax `propose()` would return. Later picks condition on a fantasy
        matrix pre-padded to its final (n + k - 1) shape — unused slots hold
        copies of the latest fantasy pick, which over-collapses variance at
        an already-picked point (pushing EI further away, i.e. extra batch
        diversity) instead of distorting the incumbent's basin. Picked pool
        points are masked out so a degenerate EI (~0
        everywhere) cannot return the same candidate twice.
        """
        model = self._fit()
        if model is None:
            return super().propose_batch(k)
        pool = self._sobol_draw(self.candidate_pool_size)
        n = model.x.shape[0]
        liar = float(np.min(model.y))  # best value in the internal
        # (standardized, minimization) space
        picks = []
        taken = np.zeros(len(pool), bool)
        x_aug = y_aug = None
        for i in range(k):
            if i == 0:
                m = model
            else:
                m = dataclasses.replace(model, x=x_aug, y=y_aug)
            ei = np.where(taken, -np.inf, m.expected_improvement(pool))
            j = int(np.argmax(ei))
            taken[j] = True
            picks.append(pool[j])
            if i == 0 and k > 1:
                x_aug = np.vstack([model.x, np.repeat(pool[j : j + 1], k - 1, axis=0)])
                y_aug = np.append(model.y, np.full(k - 1, liar))
            elif k > 1 and i < k - 1:
                # Fantasy slot layout: slot n+t is pick t's permanent home
                # (pick 0 claimed every slot at i == 0); after pick i only
                # the tail from its own home onward refills, preserving all
                # earlier picks' fantasies.
                x_aug = x_aug.copy()
                x_aug[n + i :] = pool[j]
        return backward_scale(np.stack(picks), self.configs)


def shrink_search_range(
    configs: Sequence[HyperparameterConfig],
    priors: Sequence[Tuple[np.ndarray, float]],
    *,
    radius: float = 0.25,
    candidate_pool_size: int = 1024,
    maximize: bool = False,
    seed: int = 1,
    kernel: str = "matern52",
) -> List[HyperparameterConfig]:
    """Narrow each parameter's range around the GP-predicted best point
    (photon-client hyperparameter/ShrinkSearchRange.scala:28-101).

    Fits a GP to the prior observations (unit-cube rescaled), predicts over a
    Sobol candidate pool, takes the best predicted candidate, and returns new
    configs whose [min, max] is the candidate +/- `radius` in unit space,
    clipped to the original range and back-scaled (log-space parameters are
    narrowed in log space, matching VectorRescaling).
    """
    if not priors:
        raise ValueError("shrink_search_range needs prior observations")
    x = np.stack([forward_scale(np.asarray(p, np.float64), configs) for p, _ in priors])
    y = np.asarray([v for _, v in priors], np.float64)
    model = fit_gp(x, y, kernel=kernel, maximize=maximize, seed=seed)
    from scipy.stats import qmc  # here: scipy.stats takes seconds to import

    pool = qmc.Sobol(d=len(configs), scramble=True, seed=seed).random(
        candidate_pool_size
    )
    mean, _ = model.predict(pool)
    best = pool[int(np.argmin(mean))]  # internal space is always minimized
    lo_unit = np.clip(best - radius, 0.0, 1.0)
    hi_unit = np.clip(best + radius, 0.0, 1.0)
    lo = backward_scale(lo_unit[None, :], configs)[0]
    hi = backward_scale(hi_unit[None, :], configs)[0]
    out = []
    for i, c in enumerate(configs):
        out.append(
            dataclasses.replace(
                c,
                min_value=max(float(lo[i]), c.min_value),
                max_value=min(float(hi[i]), c.max_value),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Config serialization (HyperparameterSerialization.scala:27-120)


def config_from_json(doc: str | dict) -> List[HyperparameterConfig]:
    """Parse the tuning JSON document: {"variables": [{"name", "min", "max",
    "transform"?}, ...]} (HyperparameterSerialization.configFromJson)."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    out = []
    for var in doc["variables"]:
        out.append(
            HyperparameterConfig(
                name=var["name"],
                min_value=float(var["min"]),
                max_value=float(var["max"]),
                transform=var.get("transform"),
                discrete=var.get("type", "").upper() == "DISCRETE",
            )
        )
    return out


def priors_from_json(doc: str | dict, configs: Sequence[HyperparameterConfig]):
    """Parse prior observations: {"records": [{"<name>": value, ...,
    "evaluationValue": v}]} (priorFromJson)."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    priors = []
    for rec in doc.get("records", []):
        point = np.asarray([float(rec[c.name]) for c in configs])
        priors.append((point, float(rec["evaluationValue"])))
    return priors
