"""Metrics — named performance counters (``bigdl_tpu/optim/metrics.py``).

One process drives the card, so plain dict counters suffice; the
reference's set/add/get/mean surface is kept.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, List[float]] = {}

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = [float(value)]

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self._values.setdefault(name, []).append(float(value))

    def get(self, name: str) -> Tuple[float, int]:
        """(sum, count) — reference ``Metrics.get``."""
        with self._lock:
            vals = self._values.get(name, [])
            return sum(vals), len(vals)

    def values(self, name: str) -> List[float]:
        """Copy of the raw recorded samples (percentile consumers)."""
        with self._lock:
            return list(self._values.get(name, []))

    def tail(self, name: str, n: int) -> List[float]:
        """The last ``n`` recorded samples, copied without the rest: a
        windowed reader costs O(n) however long the series has grown."""
        with self._lock:
            return self._values.get(name, [])[-int(n):]

    def mean(self, name: str) -> float:
        total, n = self.get(name)
        return total / n if n else 0.0

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {k: (sum(v) / len(v) if v else 0.0)
                    for k, v in self._values.items()}

    def clear(self) -> None:
        with self._lock:
            self._values.clear()
