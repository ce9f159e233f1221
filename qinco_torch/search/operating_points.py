"""Operating-point exploration for large-scale search (a copy of
``qinco_tpu/search/operating_points.py``, which the port does not import).

Replaces the reference's use of faiss's ``OperatingPointsWithRanges``
(reference: qinco/search/search_tasks.py:357-414): a grid of search
parameters where each evaluated point records (recall, time), and a new
point is skipped when its *best-case* bound (max recall at min time,
taken over already-measured neighbors in the parameter lattice) is
already Pareto-dominated.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field


@dataclass
class OperatingPoints:
    """Cartesian parameter grid + Pareto bookkeeping."""

    ranges: dict[str, list] = field(default_factory=dict)
    # measured: key tuple -> (perf, time)
    measured: dict[tuple, tuple[float, float]] = field(default_factory=dict)

    def add_range(self, name: str, values: list) -> None:
        assert values == sorted(values)
        self.ranges[name] = list(values)

    @property
    def names(self) -> list[str]:
        return list(self.ranges)

    def num_experiments(self) -> int:
        n = 1
        for v in self.ranges.values():
            n *= len(v)
        return n

    def all_keys(self) -> list[tuple]:
        idx_ranges = [range(len(v)) for v in self.ranges.values()]
        return [k for k in itertools.product(*idx_ranges)]

    def get_parameters(self, key: tuple) -> dict:
        return {
            name: self.ranges[name][i] for name, i in zip(self.ranges, key)
        }

    def add_operating_point(self, key: tuple, perf: float, time: float) -> None:
        self.measured[tuple(key)] = (perf, time)

    def predict_bounds(self, key: tuple) -> tuple[float, float]:
        """(max possible perf, min possible time) for an unmeasured key,
        inferred from measured points assuming monotonicity: every
        parameter increase can only raise both recall and time.
        """
        max_perf, min_time = 1.0, 0.0
        for m_key, (perf, time) in self.measured.items():
            if all(m >= k for m, k in zip(m_key, key)):
                # measured point dominates key in every parameter
                max_perf = min(max_perf, perf)
            if all(m <= k for m, k in zip(m_key, key)):
                min_time = max(min_time, time)
        return max_perf, min_time

    def is_pareto_optimal(self, perf: float, time: float) -> bool:
        """Would a point with (perf, time) be on the current frontier?"""
        for m_perf, m_time in self.measured.values():
            if m_perf >= perf and m_time <= time and (m_perf, m_time) != (perf, time):
                return False
        return True
