"""Search spaces and trial generation (a copy of
``ray_tpu/tune/search.py``).

Reference: ``python/ray/tune/search/sample.py`` (Domain/Categorical/Float/
grid_search) and ``search/basic_variant.py`` (BasicVariantGenerator: grid
cross-product x num_samples random draws).  External searcher adapters
(Optuna/HyperOpt/...) plug in via the same Searcher interface
(``search/searcher.py``).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Float(Domain):
    def __init__(self, lower, upper, log=False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        import math
        if self.log:
            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower, upper) -> Float:
    return Float(lower, upper)


def loguniform(lower, upper) -> Float:
    return Float(lower, upper, log=True)


def randint(lower, upper) -> Integer:
    return Integer(lower, upper)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


class sample_from:
    """Explicit marker for config values sampled by calling a function
    (reference: tune.sample_from).  Bare callables in a param space are
    passed through untouched — they are often legitimate values, e.g. an
    env constructor."""

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn


class Searcher:
    """Pluggable suggestion interface (reference: search/searcher.py)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]):
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (the algorithm behind HyperOpt /
    Optuna's default sampler; reference surface: tune's external
    searcher adapters, search/hyperopt + search/optuna).  Self-contained
    so model-based search works with no extra dependency.

    After ``n_startup`` random trials, observations split into good/bad
    by the ``gamma`` quantile; numeric dims model each side with a
    Parzen (Gaussian-kernel) density and the suggestion maximizes
    l(x)/g(x) over ``n_candidates`` draws from the good side;
    categorical dims use smoothed per-side frequencies."""

    def __init__(self, space: Dict[str, Any], metric: str = "score",
                 mode: str = "max", num_samples: int = 64,
                 n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self._space = space
        self._metric = metric
        self._mode = mode
        self._budget = num_samples
        self._n_startup = n_startup
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested = 0
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._observed: List[tuple] = []  # (config, value)

    # -- densities ---------------------------------------------------------
    def _numeric_dims(self):
        return {k: v for k, v in self._space.items()
                if isinstance(v, (Float, Integer))}

    @staticmethod
    def _to_unit(dom, x: float) -> float:
        import math

        if isinstance(dom, Float) and dom.log:
            lo, hi = math.log(dom.lower), math.log(dom.upper)
            return (math.log(x) - lo) / (hi - lo)
        lo, hi = dom.lower, dom.upper
        return (x - lo) / (hi - lo)

    @staticmethod
    def _from_unit(dom, u: float):
        import math

        u = min(1.0, max(0.0, u))
        if isinstance(dom, Float) and dom.log:
            lo, hi = math.log(dom.lower), math.log(dom.upper)
            return math.exp(lo + u * (hi - lo))
        val = dom.lower + u * (dom.upper - dom.lower)
        if isinstance(dom, Integer):
            return min(dom.upper - 1, max(dom.lower, int(round(val))))
        return val

    def _parzen(self, points: List[float]):
        """Gaussian-mixture density over unit-interval points; bandwidth
        by Silverman's rule with a floor so single points still spread."""
        import math

        n = len(points)
        mean = sum(points) / n
        var = sum((p - mean) ** 2 for p in points) / max(1, n - 1)
        bw = max(0.08, 1.06 * math.sqrt(var + 1e-12) * n ** -0.2)

        def pdf(x: float) -> float:
            return sum(math.exp(-0.5 * ((x - p) / bw) ** 2)
                       for p in points) / (n * bw)

        def sample() -> float:
            p = self._rng.choice(points)
            return p + self._rng.gauss(0.0, bw)

        return pdf, sample

    def _random_config(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self._space.items():
            if isinstance(v, Domain):
                cfg[k] = v.sample(self._rng)
            elif isinstance(v, sample_from):
                cfg[k] = v.fn()
            elif isinstance(v, GridSearch):
                cfg[k] = self._rng.choice(v.values)
            else:
                cfg[k] = v
        return cfg

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self._budget:
            return None
        self._suggested += 1
        if len(self._observed) < self._n_startup:
            cfg = self._random_config()
            self._pending[trial_id] = cfg
            return cfg
        import math

        ranked = sorted(self._observed, key=lambda cv: cv[1],
                        reverse=True)
        n_good = max(2, int(math.ceil(self._gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        cfg = self._random_config()  # non-numeric dims + fallback
        for k, dom in self._numeric_dims().items():
            g_pts = [self._to_unit(dom, c[k]) for c in good if k in c]
            b_pts = [self._to_unit(dom, c[k]) for c in bad if k in c]
            if not g_pts or not b_pts:
                continue
            l_pdf, l_sample = self._parzen(g_pts)
            g_pdf, _ = self._parzen(b_pts)
            best_u, best_ratio = None, -1.0
            for _ in range(self._n_candidates):
                u = min(1.0, max(0.0, l_sample()))
                ratio = l_pdf(u) / (g_pdf(u) + 1e-12)
                if ratio > best_ratio:
                    best_ratio, best_u = ratio, u
            cfg[k] = self._from_unit(dom, best_u)
        for k, v in self._space.items():
            if isinstance(v, Categorical):
                counts_g = {c: 1.0 for c in v.categories}  # +1 smoothing
                counts_b = {c: 1.0 for c in v.categories}
                for c in good:
                    if k in c:
                        counts_g[c[k]] = counts_g.get(c[k], 1.0) + 1
                for c in bad:
                    if k in c:
                        counts_b[c[k]] = counts_b.get(c[k], 1.0) + 1
                cfg[k] = max(v.categories,
                             key=lambda cat: counts_g[cat]
                             / counts_b[cat])
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]):
        cfg = self._pending.pop(trial_id, None)
        v = (result or {}).get(self._metric)
        if cfg is None or v is None:
            return
        v = float(v) if self._mode == "max" else -float(v)
        self._observed.append((cfg, v))


class OptunaSearch(Searcher):
    """Adapter for an external Optuna study (reference:
    search/optuna/optuna_search.py).  Optional dependency: raises at
    construction when optuna is absent."""

    def __init__(self, space: Dict[str, Any], metric: str = "score",
                 mode: str = "max", num_samples: int = 64,
                 seed: Optional[int] = None):
        try:
            import optuna
        except ImportError as e:
            raise ImportError(
                "OptunaSearch needs the 'optuna' package; use "
                "TPESearcher for the built-in equivalent") from e
        self._optuna = optuna
        self._space = space
        self._metric = metric
        self._mode = mode
        self._budget = num_samples
        self._suggested = 0
        sampler = optuna.samplers.TPESampler(seed=seed)
        self._study = optuna.create_study(
            direction="maximize" if mode == "max" else "minimize",
            sampler=sampler)
        self._trials: Dict[str, Any] = {}

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self._budget:
            return None
        self._suggested += 1
        ot = self._study.ask()
        cfg = {}
        for k, v in self._space.items():
            if isinstance(v, Float):
                cfg[k] = ot.suggest_float(k, v.lower, v.upper, log=v.log)
            elif isinstance(v, Integer):
                cfg[k] = ot.suggest_int(k, v.lower, v.upper - 1)
            elif isinstance(v, Categorical):
                cfg[k] = ot.suggest_categorical(k, v.categories)
            elif isinstance(v, sample_from):
                cfg[k] = v.fn()
            else:
                cfg[k] = v
        self._trials[trial_id] = ot
        return cfg

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]):
        ot = self._trials.pop(trial_id, None)
        v = (result or {}).get(self._metric)
        if ot is None or v is None:
            return
        self._study.tell(ot, float(v))


class BasicVariantGenerator(Searcher):
    """Grid cross-product x num_samples random draws (reference:
    search/basic_variant.py)."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._rng = random.Random(seed)
        self._space = space
        grid_keys = [k for k, v in space.items()
                     if isinstance(v, GridSearch)]
        grids = [space[k].values for k in grid_keys]
        self._grid_points = [dict(zip(grid_keys, combo))
                             for combo in itertools.product(*grids)] \
            if grid_keys else [{}]
        self._num_samples = num_samples
        self._iter = self._generate()

    def _generate(self) -> Iterator[Dict[str, Any]]:
        for _ in range(self._num_samples):
            for grid_point in self._grid_points:
                cfg = {}
                for k, v in self._space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = grid_point[k]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    elif isinstance(v, sample_from):
                        cfg[k] = v.fn()
                    else:
                        cfg[k] = v
                yield cfg

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        try:
            return next(self._iter)
        except StopIteration:
            return None
