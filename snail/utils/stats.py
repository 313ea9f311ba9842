"""Traversal/render statistics — the rebuild of ``TreeStats``
(reference src/tree_stats.h:36-130: compile-time-gated counters for
intersections, loop iterations, rays, early-outs, plus timers; displayed on
the HUD via GenInfo "in:.. it:.. ms:..").

The GPU traversal keeps no work counters yet, so only ray counts are
filled in (the server marks its stats ``measured: false``). Collection is
off by default like the reference (stats::treeStatsEnabled,
tree_stats.h:5-13).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class TreeStats:
    intersects: int = 0
    loop_iters: int = 0
    rays: int = 0
    skips: int = 0  # shadow early-outs (reference stats.Skip())
    runs: int = 0
    timers_ms: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, other: "TreeStats") -> "TreeStats":
        self.intersects += other.intersects
        self.loop_iters += other.loop_iters
        self.rays += other.rays
        self.skips += other.skips
        self.runs += other.runs
        for k, v in other.timers_ms.items():
            self.timers_ms[k] = self.timers_ms.get(k, 0.0) + v
        return self

    def gen_info(self, ms: float, mrays: float) -> str:
        """HUD string (reference TreeStats::GenInfo)."""
        return (
            f"in:{self.intersects // 1000}k it:{self.loop_iters // 1000}k "
            f"ms:{ms:.2f} MRays/s:{mrays:.1f}"
        )

    def reset(self) -> None:
        self.__init__()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Timer:
    """Context-manager timer slot (the reference's 8 timer slots,
    tree_stats.h GetTime usage)."""

    def __init__(self, stats: TreeStats, name: str):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self.t0) * 1e3
        self.stats.timers_ms[self.name] = (
            self.stats.timers_ms.get(self.name, 0.0) + dt
        )
