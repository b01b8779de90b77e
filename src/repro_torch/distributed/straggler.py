"""Straggler mitigation scaffolding, the port of
``repro.distributed.straggler`` (pure Python, unchanged).

On a real cluster the runtime exposes missed-heartbeat / slow-host signals;
in-process we implement the policy layer: a per-step deadline watchdog that
(a) records step-time EWMA and flags outliers, (b) after `patience`
consecutive deadline misses signals the caller to checkpoint-and-rebalance
(elastic restart excluding the slow host). The decision logic is what's
testable offline; the signal plumbing is environment-specific."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class StepWatchdog:
    deadline_factor: float = 3.0     # miss = step > factor * EWMA
    patience: int = 3                # consecutive misses before escalation
    ewma_alpha: float = 0.1
    _ewma: Optional[float] = None
    _misses: int = 0
    steps: int = 0
    flagged_steps: int = 0

    def observe(self, step_seconds: float) -> str:
        """Returns 'ok' | 'slow' | 'rebalance'."""
        self.steps += 1
        if self._ewma is None:
            self._ewma = step_seconds
            return "ok"
        verdict = "ok"
        if step_seconds > self.deadline_factor * self._ewma:
            self._misses += 1
            self.flagged_steps += 1
            verdict = "rebalance" if self._misses >= self.patience else "slow"
        else:
            self._misses = 0
        # EWMA excludes flagged steps so a straggler cannot poison the baseline
        if verdict == "ok":
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * step_seconds
        return verdict

    class _Timer:
        def __init__(self, wd):
            self.wd = wd

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.verdict = self.wd.observe(time.perf_counter() - self.t0)
            return False

    def timed(self) -> "_Timer":
        """Context manager timing one step and feeding the watchdog."""
        return StepWatchdog._Timer(self)
