"""EngineType — the compute-engine selector (``bigdl_tpu/utils/engine.py:26``).

Only the enum is ported: ``Engine``'s device-topology half (meshes,
multi-process start-up) comes with the data-parallel slice. The values
are the JAX package's and are accepted for source compatibility; none of
them selects code in the port, which runs on the device its caller names.
"""

from __future__ import annotations

from enum import Enum


class EngineType(Enum):
    MklBlas = "mklblas"
    MklDnn = "mkldnn"
    TPU = "tpu"

    @staticmethod
    def parse(name: str) -> "EngineType":
        key = name.strip().lower()
        for e in EngineType:
            if e.value == key or e.name.lower() == key:
                return e
        raise ValueError(f"unknown engine type: {name!r}")
