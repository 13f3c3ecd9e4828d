"""Declarative sweeps and claims over :class:`~repro_torch.api.ExperimentSpec`.

The interesting findings live in the *cross-product* of the stack's
axes (Fernandez et al., arXiv:2504.17674; Ifath & Haque,
arXiv:2604.09611). :func:`sweep` expands a cartesian grid of axis
values over a base spec, runs every point (memoized on the spec's
content hash, cached under ``experiments/bench/speccache_torch/``), and
returns a :class:`SweepResult` mapping stable labels to
:class:`~repro_torch.api.RunResult` records.

:class:`Claim` replaces the hand-rolled ``claim/`` row assembly in each
benchmark: a claim declares which results it compares (exact labels or
``fnmatch`` globs aggregated with min/max/mean), on which metric, and
against what threshold — e.g. ::

    Claim("shaped_vs_unshaped", ratio_of=("naive", "shaped/*"),
          metric="mean_energy_wh", threshold=10.0)

Axis values may be plain field values, or :class:`Option` bundles that
set several spec fields at once under one label (how an "arrival"
axis carries both the pattern name and its parameters).

The port's own copy of ``repro.sweep``. Its specs hash as the
reference's do, so its cache has a directory of its own: the reference's
records never answer a port sweep. ``torch_device=`` (``"cuda"`` by
default) names the torch device of executed specs
(:mod:`repro_torch.api`), in pool workers too.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import itertools
import json
import os
import tempfile
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    Optional, Sequence, Tuple, Union)

from repro_torch.api import DEFAULT_TORCH_DEVICE, ExperimentSpec, RunResult

#: default on-disk memoization directory (overridable per sweep call);
#: not the reference's ``speccache``, which holds records of equal hashes
DEFAULT_CACHE_DIR = os.path.join("experiments", "bench", "speccache_torch")

#: environment default for ``sweep(workers=...)`` (the reference's name,
#: so one setting reaches both packages' sweeps)
WORKERS_ENV = "REPRO_SWEEP_WORKERS"


@dataclasses.dataclass(frozen=True, init=False)
class Option:
    """One labelled point on a sweep axis that sets several spec fields
    at once (dotted keys reach into mapping fields, as in
    :meth:`ExperimentSpec.derive`)."""

    label: str
    changes: Mapping[str, Any]

    def __init__(self, label: str, **changes):
        object.__setattr__(self, "label", label)
        object.__setattr__(self, "changes", dict(changes))


def _axis_part(axis: str, value: Any) -> Tuple[str, Dict[str, Any]]:
    """(label part, spec changes) for one axis value."""
    if isinstance(value, Option):
        return value.label, dict(value.changes)
    leaf = axis.rsplit(".", 1)[-1]
    return f"{leaf}={value}", {axis: value}


def expand_grid(base: ExperimentSpec,
                axes: Optional[Mapping[str, Sequence[Any]]] = None,
                tag: str = "") -> "List[Tuple[str, ExperimentSpec]]":
    """Cartesian expansion of ``axes`` over ``base``: an ordered list of
    ``(label, spec)`` points. Labels join per-axis parts with ``/`` in
    axes order, prefixed by ``tag`` — deterministic, so claims can name
    them. No axes -> the single point labelled ``tag`` (or "base")."""
    axes = dict(axes or {})
    if not axes:
        return [(tag or "base", base)]
    points = []
    for combo in itertools.product(*axes.values()):
        parts, changes = [], {}
        for axis, value in zip(axes.keys(), combo):
            part, ch = _axis_part(axis, value)
            parts.append(part)
            changes.update(ch)
        label = "/".join(([tag] if tag else []) + parts)
        points.append((label, base.derive(**changes)))
    labels = [lbl for lbl, _ in points]
    if len(set(labels)) != len(labels):
        raise ValueError(f"sweep labels collide: {labels}")
    return points


# ---------------------------------------------------------------------------
# claims
# ---------------------------------------------------------------------------
_OPS: Dict[str, Callable[[float, Any], bool]] = {
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
    "range": lambda v, t: t[0] < v < t[1],
}


@dataclasses.dataclass(frozen=True)
class Claim:
    """A declarative pass/fail check over a set of labelled results.

    Exactly one value source:

    * ``ratio_of=(num, den)`` — metric(num) / metric(den),
    * ``value_of=sel``        — metric(sel),
    * ``value_fn``            — callable over the results mapping
      (escape hatch for composite values).

    Selectors are exact labels or ``fnmatch`` globs; a glob matching
    several results is reduced with ``agg`` (numerator / value) or
    ``agg_den`` (denominator). The claim passes when ``op(value,
    threshold)`` holds and the optional ``where`` predicate (over the
    full results mapping) agrees.
    """

    name: str
    metric: str = "mean_energy_wh"
    ratio_of: Optional[Tuple[str, str]] = None
    value_of: Optional[str] = None
    value_fn: Optional[Callable[[Mapping[str, RunResult]], float]] = None
    threshold: Union[float, Tuple[float, float]] = 1.0
    op: str = ">="
    agg: str = "min"
    agg_den: str = "min"
    where: Optional[Callable[[Mapping[str, RunResult]], bool]] = None

    def __post_init__(self):
        sources = [s is not None for s in
                   (self.ratio_of, self.value_of, self.value_fn)]
        if sum(sources) != 1:
            raise ValueError(
                f"claim {self.name!r} needs exactly one of ratio_of / "
                f"value_of / value_fn")
        if self.op not in _OPS:
            raise ValueError(f"unknown claim op {self.op!r}; "
                             f"known: {list(_OPS)}")

    # ------------------------------------------------------------------
    def value(self, results: Mapping[str, RunResult]) -> float:
        if self.value_fn is not None:
            return float(self.value_fn(results))
        if self.ratio_of is not None:
            num = select(results, self.ratio_of[0], self.metric, self.agg)
            den = select(results, self.ratio_of[1], self.metric,
                         self.agg_den)
            return num / den
        return select(results, self.value_of, self.metric, self.agg)

    def evaluate(self, results: Mapping[str, RunResult]) -> "ClaimResult":
        v = self.value(results)
        ok = _OPS[self.op](v, self.threshold)
        if ok and self.where is not None:
            ok = bool(self.where(results))
        return ClaimResult(name=self.name, value=float(v),
                           passed=bool(ok))


@dataclasses.dataclass(frozen=True)
class ClaimResult:
    name: str
    value: float
    passed: bool


def select(results: Mapping[str, RunResult], selector: str,
           metric: str = "mean_energy_wh", agg: str = "min") -> float:
    """Resolve a claim selector: the metric of one labelled result, or
    an aggregate (min/max/mean) over every label the glob matches."""
    if selector in results:
        return results[selector].metric(metric)
    matches = [results[k].metric(metric) for k in results
               if fnmatch.fnmatchcase(k, selector)]
    if not matches:
        raise KeyError(
            f"selector {selector!r} matches no result label; "
            f"have: {list(results)}")
    if len(matches) == 1:
        return matches[0]
    if agg == "min":
        return min(matches)
    if agg == "max":
        return max(matches)
    if agg == "mean":
        return sum(matches) / len(matches)
    raise ValueError(f"unknown aggregator {agg!r} for multi-match "
                     f"selector {selector!r}")


def check_claims(results: Mapping[str, RunResult],
                 claims: Iterable[Claim]) -> List[ClaimResult]:
    return [c.evaluate(results) for c in claims]


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SweepResult:
    """Ordered results of one (or several merged) sweeps, plus claim
    verdicts. ``results`` maps the stable grid labels to records."""

    results: Dict[str, RunResult]
    claims: List[ClaimResult] = dataclasses.field(default_factory=list)
    cache_hits: int = 0
    cache_misses: int = 0

    def __getitem__(self, label: str) -> RunResult:
        return self.results[label]

    @property
    def failed_claims(self) -> List[ClaimResult]:
        return [c for c in self.claims if not c.passed]

    def merge(self, other: "SweepResult") -> "SweepResult":
        """Combine two sweeps' results (labels must not collide) so one
        claim set can span several grids."""
        dup = set(self.results) & set(other.results)
        if dup:
            raise ValueError(f"merged sweeps share labels: {sorted(dup)}")
        merged = dict(self.results)
        merged.update(other.results)
        return SweepResult(results=merged,
                           claims=self.claims + other.claims,
                           cache_hits=self.cache_hits + other.cache_hits,
                           cache_misses=(self.cache_misses
                                         + other.cache_misses))

    def check(self, claims: Iterable[Claim]) -> List[ClaimResult]:
        """Evaluate ``claims`` against these results and record them."""
        out = check_claims(self.results, claims)
        self.claims.extend(out)
        return out


def _code_version() -> str:
    """Stamp cache entries with the package version so a release that
    changes engine/model semantics invalidates stale results instead of
    silently serving numbers computed by old code."""
    import repro_torch
    return repro_torch.__version__


def _cache_load(path: str, spec: ExperimentSpec) -> Optional[RunResult]:
    try:
        with open(path) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return None
    if blob.get("version") != _code_version():   # stale-code guard
        return None
    if blob.get("spec") != spec.to_dict():   # hash-prefix collision guard
        return None
    return RunResult.from_dict(blob["result"])


def _cache_path(spec: ExperimentSpec, cache_dir: Optional[str]) -> str:
    return os.path.join(cache_dir or DEFAULT_CACHE_DIR,
                        spec.spec_hash() + ".json")


def _cache_enabled(spec: ExperimentSpec, cache: bool) -> bool:
    """Replay-backend specs are never memoized: the hash sees only the
    trace-file *path*, so a re-recorded trace would silently serve
    stale results."""
    return cache and spec.backend != "replay"


def _cache_try(spec: ExperimentSpec, cache: bool,
               cache_dir: Optional[str]) -> Optional[RunResult]:
    """The one cache-probe policy shared by :func:`run_spec` and the
    parallel sweep pre-scan, so the two paths cannot drift."""
    if not _cache_enabled(spec, cache):
        return None
    return _cache_load(_cache_path(spec, cache_dir), spec)


def _atomic_write_json(blob: Mapping, path: str) -> None:
    """Write-to-temp + ``os.replace``: a cache entry is either absent
    or complete, never truncated — an interrupted (or parallel) sweep
    cannot leave half-written JSON for the corrupt-cache path to eat on
    every later run."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def run_spec(spec: ExperimentSpec, *, cache: bool = True,
             cache_dir: Optional[str] = None,
             torch_device=DEFAULT_TORCH_DEVICE
             ) -> Tuple[RunResult, bool]:
    """Run one spec with on-disk memoization; returns ``(result,
    was_cache_hit)``. The cache key is the spec's content hash, so any
    axis change re-runs and identical specs are served from disk.
    Cache writes are atomic (temp file + ``os.replace``), so parallel
    workers and interrupted sweeps never corrupt an entry.
    Replay-backend specs are never memoized (see
    :func:`_cache_enabled`). An executed spec runs on ``torch_device``."""
    cache = _cache_enabled(spec, cache)
    path = _cache_path(spec, cache_dir)
    if cache:
        hit = _cache_load(path, spec)
        if hit is not None:
            return hit, True
    result = spec.run(torch_device=torch_device)
    if cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write_json({"version": _code_version(),
                            "spec": spec.to_dict(),
                            "result": result.to_dict()}, path)
    return result, False


def _resolve_workers(workers: Optional[int]) -> int:
    if workers is None:
        workers = int(os.environ.get(WORKERS_ENV, "1") or 1)
    return max(int(workers), 1)


def _sweep_worker(payload) -> Tuple[Dict, bool]:
    """Run one grid point in a pool process. Specs travel as dicts and
    results come back as dicts (JSON-faithful either way), so nothing
    engine-side needs to pickle."""
    spec_dict, cache, cache_dir, torch_device = payload
    result, hit = run_spec(ExperimentSpec.from_dict(spec_dict),
                           cache=cache, cache_dir=cache_dir,
                           torch_device=torch_device)
    return result.to_dict(), hit


def sweep(base: ExperimentSpec,
          axes: Optional[Mapping[str, Sequence[Any]]] = None, *,
          tag: str = "", claims: Iterable[Claim] = (),
          cache: bool = True, cache_dir: Optional[str] = None,
          progress: Optional[Callable[[str, RunResult], None]] = None,
          workers: Optional[int] = None,
          torch_device=DEFAULT_TORCH_DEVICE) -> SweepResult:
    """Expand ``axes`` over ``base``, run every grid point (memoized),
    evaluate ``claims``, and return the labelled results.

    ``workers > 1`` runs the cache-miss points in a process pool
    (cache hits are still served in-process; memoization stays
    spec-hash keyed and atomic, so concurrent writers are safe).
    Results are returned in the deterministic grid-label order either
    way. Defaults to the ``REPRO_SWEEP_WORKERS`` environment variable,
    else 1.
    Each pool worker builds its own models for executed specs, on
    ``torch_device``.
    """
    points = expand_grid(base, axes, tag=tag)
    workers = _resolve_workers(workers)
    runs: List[Optional[Tuple[RunResult, bool]]] = [None] * len(points)
    if workers > 1 and len(points) > 1:
        # serve hits locally; only misses pay for a pool slot
        misses = []
        for idx, (_, spec) in enumerate(points):
            hit = _cache_try(spec, cache, cache_dir)
            if hit is not None:
                runs[idx] = (hit, True)
            else:
                misses.append(idx)
        if misses:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            # spawn, not fork: the parent has imported torch (the
            # port's import chain), whose internal threadpools (and a
            # CUDA context, once made) make forked children unsafe;
            # spawned workers pay an interpreter+import startup once per
            # pool slot instead
            with ProcessPoolExecutor(
                    max_workers=min(workers, len(misses)),
                    mp_context=multiprocessing.get_context(
                        "spawn")) as pool:
                futs = [pool.submit(
                    _sweep_worker,
                    (points[i][1].to_dict(), cache, cache_dir,
                     torch_device))
                    for i in misses]
                for idx, fut in zip(misses, futs):
                    blob, was_hit = fut.result()
                    runs[idx] = (RunResult.from_dict(blob), was_hit)
    else:
        runs = [run_spec(spec, cache=cache, cache_dir=cache_dir,
                         torch_device=torch_device)
                for _, spec in points]
    out: Dict[str, RunResult] = {}
    hits = misses_n = 0
    for (label, _), (result, was_hit) in zip(points, runs):
        hits, misses_n = hits + was_hit, misses_n + (not was_hit)
        out[label] = result
        if progress is not None:
            progress(label, result)
    res = SweepResult(results=out, cache_hits=hits,
                      cache_misses=misses_n)
    res.check(claims)
    return res


__all__ = ["sweep", "run_spec", "expand_grid", "Option", "Claim",
           "ClaimResult", "SweepResult", "select", "check_claims",
           "DEFAULT_CACHE_DIR", "WORKERS_ENV"]
