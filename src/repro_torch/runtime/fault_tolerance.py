"""Result-validation guard (copy of ``repro.runtime.fault_tolerance.NaNGuard``)."""
from __future__ import annotations

import numpy as np


class NaNGuard:
    """Counts consecutive non-finite values; advises reload after ``limit``."""

    def __init__(self, limit: int = 3):
        self.limit = limit
        self.consecutive = 0
        self.total_skipped = 0

    def observe(self, loss: float) -> str:
        """Returns 'ok' | 'skip' | 'reload'."""
        if np.isfinite(loss):
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.total_skipped += 1
        return "reload" if self.consecutive >= self.limit else "skip"
