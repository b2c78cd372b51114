"""What one run recorded, as the metric readers (``metrics/<name>.py``) see it."""
from __future__ import annotations

from typing import List, Optional

from gnnbench.harness import registry


class Record:
    def __init__(self, root=registry.BENCH_DIR):
        self.root = root
        self.cfg: dict = {}
        self.setup_s: float = 0.0
        self.window_s: float = 0.0            # host clock, first dispatch to the final sync
        self.steps: int = 0                   # steps the window completed
        self.step_times_ms: List[float] = []  # consecutive per-step device events
        self.host_enqueue_ms: List[float] = []
        self.profile = None                   # harness.profile.Profile of a traced run
        self.stats: Optional[dict] = None     # harness.counts.graph_stats
        self.num_features = 0
        self.num_classes = 0

    def work(self) -> list:
        """The step's least work (``counts/<model>.py``); empty before the
        graph's counts are taken."""
        if self.stats is None:
            return []
        counts = registry.load_module("counts", self.cfg["model"], self.root)
        return counts.step_ops(self.cfg, self.stats, self.num_features, self.num_classes)

    def read(self, metric: str):
        """The value of ``metrics/<metric>.py`` for this run, or None."""
        return registry.load_module("metrics", metric, self.root).read(self)
