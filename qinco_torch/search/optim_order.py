"""Exploration ordering for the operating-point sweep (a copy of
``qinco_tpu/search/optim_order.py``, which the port does not import).

The reference ships a table of 209 empirically Pareto-optimal settings
and explores grid points nearest (in log2 space) to that prior first
(reference: qinco/search/optim_order.py, search_tasks.py:285-303).  That
table is experiment data we can't reproduce offline, so the prior here is
*generated*: a ladder of balanced pipeline settings following the scaling
relationships measured over the reference's table (201 rows):
``log2(nprobe/nshort)`` has median 0 with p10/p90 at ∓1, ``efSearch``
sits at a median 4·nprobe (p10 1x, p90 16x), and the mid-rerank
expansion stays small (1-6x, mode 1).  The distance-ordering machinery
is equivalent.
"""

from __future__ import annotations

import math


def generated_pareto_prior() -> list[dict]:
    prior = []
    for log_ns in range(0, 12):  # nshort 1 .. 2048
        nshort = 2**log_ns
        for probe_ratio in (0.5, 1.0, 2.0):
            nprobe = max(1, int(nshort * probe_ratio))
            for nmid in (1, 2, 4, 6):
                prior.append(
                    {
                        "nshort": nshort,
                        "nprobe": nprobe,
                        "quantizer_efSearch": max(4, 4 * nprobe),
                        "nmid_short": nmid,
                    }
                )
    return prior


PARETO_PRIOR = generated_pareto_prior()


def _log_distance(a: dict, b: dict) -> float:
    return sum(
        abs(
            math.log2(max(1, b[key])) - math.log2(max(1, a.get(key, 1)))
        )
        for key in b
    )


def sort_experiments_by_prior(op, keys: list[tuple]) -> list[tuple]:
    """Order grid keys for exploration: by distance to the nearest prior
    point (reference: sort_experiments_pareto_front,
    search_tasks.py:285-303), round-robined across (nshort, nmid_short)
    strata.

    The stratification is a workload-robustness fix the raw distance
    ordering lacks: which axis binds recall is workload-dependent (the
    reference's 1B/8-byte setup is shortlist-limited, so its table —
    and hence the generated prior — prefers balanced nprobe~nshort; a
    10M/easier-codes setup is coarse-limited and its frontier lives at
    minimal nshort).  Visiting each stratum early, at its most
    prior-plausible nprobe, covers both regimes in the first ~|strata|
    experiments.  Used as the SEED schedule for AdaptiveExplorer."""
    scored = []
    for i, key in enumerate(keys):
        params = op.get_parameters(key)
        min_dist = min(_log_distance(p, params) for p in PARETO_PRIOR)
        scored.append((min_dist, i, key, params))

    groups: dict[tuple, list] = {}
    for s in sorted(scored):
        stratum = (s[3].get("nshort", 0), s[3].get("nmid_short", 0))
        groups.setdefault(stratum, []).append(s)
    # visit strata in order of their most-plausible member
    ordered_groups = sorted(groups.values(), key=lambda g: g[0][:2])
    out = []
    for rank in range(max(len(g) for g in ordered_groups)):
        for g in ordered_groups:
            if rank < len(g):
                out.append(g[rank][2])
    return out


class AdaptiveExplorer:
    """Measurement-driven exploration ordering (goes beyond the
    reference, whose ordering is a 209-row hardcoded table from its own
    past experiments, optim_order.py:7-209).

    A static prior cannot predict which grid axis binds a given
    workload's recall/time frontier.  This explorer measures a diverse
    seed schedule (``sort_experiments_by_prior``), then repeatedly fits
    a tiny log-linear model (recall ~ log nprobe/nshort/nmid, log time ~
    same) on everything measured so far and picks the cheapest remaining
    point predicted to be non-dominated — i.e. the cheapest candidate
    that could still extend the measured frontier.  When nothing is
    predicted non-dominated, remaining points are taken cheapest-first
    (they can only confirm the frontier, so confirm cheaply).

    Exploration order only affects how soon the frontier is found — the
    search loop's Pareto pruning (`is_pareto_optimal`) supplies correctness —
    so a mis-prediction costs time, never recall.
    """

    def __init__(self, op, keys: list[tuple]):
        self.op = op
        ordered = sort_experiments_by_prior(op, keys)
        # Seed schedule: one pick per nshort stratum at the minimum nmid
        # (prior-nearest nprobe within the stratum), plus one pick per
        # remaining nmid value so its axis is identifiable to the model.
        # A full (nshort x nmid) pass burned more picks than 2x the
        # typical frontier size before adaptivity even started.
        # Strata are visited cheapest-first (nshort ascending): every
        # measured regime's frontier contains its cheapest settings, so
        # early seed picks double as frontier candidates.
        params = {k: op.get_parameters(k) for k in ordered}
        nmids = sorted({p.get("nmid_short", 0) for p in params.values()})
        stratum_pick: dict[int, tuple] = {}
        for k in ordered:
            p = params[k]
            ns = p.get("nshort", 0)
            if p.get("nmid_short", 0) == nmids[0] and ns not in stratum_pick:
                stratum_pick[ns] = k
        seeds = [stratum_pick[ns] for ns in sorted(stratum_pick)]
        for nm in nmids[1:]:
            for k in ordered:
                if params[k].get("nmid_short", 0) == nm and k not in seeds:
                    seeds.append(k)
                    break
        self.seed_n = len(seeds)
        self.remaining = seeds + [k for k in ordered if k not in seeds]
        self.measured: list[tuple[dict, float, float]] = []
        # Only axes that actually vary in this grid are identifiable;
        # constant axes add lstsq columns without information and would
        # inflate the overdetermined-fit gate below.
        self._varying = {
            axis for axis in ("nprobe", "nshort", "nmid_short",
                              "quantizer_efSearch")
            if len({p.get(axis, 1) for p in params.values()}) > 1
        }

    def update(self, params: dict, recall: float, time_s: float) -> None:
        self.measured.append((dict(params), float(recall), float(time_s)))

    def _feat(self, p: dict):
        # log2 terms model multiplicative cost; the reciprocal terms
        # capture recall's saturating shape (miss rate ~ 1/nprobe,
        # 1/nshort), which a pure log-linear model misfits badly enough
        # to corrupt the dominance test.  Constant axes are dropped (see
        # __init__) so the overdetermined gate reflects real unknowns.
        feats = [1.0]
        for axis in ("nprobe", "nshort", "nmid_short",
                     "quantizer_efSearch"):
            if axis in self._varying:
                feats.append(math.log2(max(1, p.get(axis, 1))))
        for axis in ("nprobe", "nshort"):
            if axis in self._varying:
                feats.append(1.0 / max(1, p.get(axis, 1)))
        return feats

    def next(self):
        """Pop the next key to measure (None when exhausted)."""
        if not self.remaining:
            return None
        n_feat = len(self._feat({}))
        # with fewer measurements than feature count + margin the fit
        # is (near-)interpolating and extrapolates junk — stay on the
        # stratified prior schedule until the model is overdetermined
        if len(self.measured) < max(self.seed_n, n_feat + 2):
            return self.remaining.pop(0)

        import numpy as np

        X = np.array([self._feat(p) for p, _, _ in self.measured])
        R = np.array([r for _, r, _ in self.measured])
        T = np.log(np.maximum([t for _, _, t in self.measured], 1e-9))

        wr, *_ = np.linalg.lstsq(X, R, rcond=None)
        wt, *_ = np.linalg.lstsq(X, T, rcond=None)
        # noise floor on the dominance test, calibrated to the model's
        # own residuals: a predicted gain below what the fit can resolve
        # is jitter, not a frontier extension — without it the explorer
        # burns picks on same-recall nmid/nshort variants
        eps_r = max(1e-3, 2.0 * float(np.std(R - X @ wr)))
        eps_t = 1.0 + max(0.05, 2.0 * float(np.std(T - X @ wt)))

        best = None  # (dominated?, predicted cost, key)
        for k in self.remaining:
            p = self.op.get_parameters(k)
            f = np.array(self._feat(p))
            rhat, that = float(f @ wr), float(np.exp(f @ wt))
            nondom = not any(
                r2 >= rhat - eps_r and t2 <= that * eps_t
                for _, r2, t2 in self.measured
            )
            # among predicted frontier extensions, walk cost-ascending:
            # each pick is then itself frontier-plausible at measurement
            # time.  Dominated leftovers are also taken cheapest-first —
            # they can only confirm the frontier, so confirm cheaply
            # (and under timing noise the cheap ones are the likeliest
            # to land on the true frontier anyway).
            cand = (not nondom, that, k)
            if best is None or cand < best:
                best = cand
        self.remaining.remove(best[2])
        return best[2]
