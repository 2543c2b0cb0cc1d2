"""Stream locality estimator (paper §IV-A/B): LDSS tracking and prediction.

Per stream: a reservoir sample of the current estimation interval feeds the
unseen estimator at interval boundaries; historical LDSS values are smoothed
with self-tuned double exponential smoothing (Holt) to predict the next
interval's LDSS, which drives the prioritized cache.

Estimation triggers (paper §IV-B): (1) end of an estimation interval;
(2) a significant drop in inline dedup ratio; (3) stream join/quit.

The estimation interval is ``factor * cache_entries`` with
``factor ~= 1 - d`` where ``d`` is the historical inline dedup ratio
(paper §IV-B's practical rule).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .ffh import occurrence_counts
from .reservoir import Reservoir
from .unseen import ldss_batch, unseen_estimate_from_counts


class HoltPredictor:
    """Self-tuned double exponential smoothing over LDSS history.

    The smoothing constant alpha is re-fit from a small grid to minimize the
    one-step-ahead error over the recorded history ("self-tuned" per the
    paper); beta is tied to alpha (Holt's linear method with beta = alpha).
    """

    GRID = (0.2, 0.35, 0.5, 0.65, 0.8)

    def __init__(self, history_cap: int = 64):
        self.history: List[float] = []
        self.history_cap = history_cap

    def observe(self, y: float) -> None:
        self.history.append(float(y))
        if len(self.history) > self.history_cap:
            self.history.pop(0)

    @staticmethod
    def _run(history: List[float], alpha: float):
        level, trend = history[0], 0.0
        err = 0.0
        for y in history[1:]:
            pred = level + trend
            err += abs(y - pred)
            new_level = alpha * y + (1 - alpha) * (level + trend)
            trend = alpha * (new_level - level) + (1 - alpha) * trend
            level = new_level
        return level, trend, err

    def predict(self) -> Optional[float]:
        h = self.history
        if not h:
            return None
        if len(h) == 1:
            return h[0]
        best = None
        for alpha in self.GRID:
            level, trend, err = self._run(h, alpha)
            if best is None or err < best[2]:
                best = (level, trend, err)
        return max(0.0, best[0] + best[1])


class StreamLocalityEstimator:
    """Temporal-locality estimation for all streams of the mixed workload."""

    def __init__(
        self,
        cache_entries: int,
        sampling_rate: float = 0.15,
        interval_factor: float = 0.5,
        min_stream_writes: int = 64,
        default_small_ldss: float = 1.0,
        use_unseen: bool = True,
        batched_solver: bool = False,
        on_ldss: Optional[Callable[[Dict[int, float]], None]] = None,
        seed: int = 0,
        *,
        device="cuda",
    ):
        """``device`` is where the batched solver runs (``batched_solver``)."""
        self.device = device
        self.cache_entries = cache_entries
        self.sampling_rate = sampling_rate
        self.interval_factor = interval_factor
        self.min_stream_writes = min_stream_writes
        self.default_small_ldss = default_small_ldss
        self.use_unseen = use_unseen
        self.batched_solver = batched_solver
        self.on_ldss = on_ldss
        self.seed = seed

        self.interval_len = max(256, int(interval_factor * cache_entries))
        self.reservoirs: Dict[int, Reservoir] = {}
        self.stream_writes: Dict[int, int] = {}
        self.predictors: Dict[int, HoltPredictor] = {}
        self.predicted: Dict[int, float] = {}
        self.interval_count = 0
        self.writes_in_interval = 0
        # dedup-ratio tracking for trigger (2) and the interval-factor rule
        self._interval_dups = 0
        self._last_ratio: Optional[float] = None
        self.estimations = 0

    # -- ingest --------------------------------------------------------------
    def observe_write(self, stream: int, fp: int, was_inline_dup: bool = False) -> None:
        res = self.reservoirs.get(stream)
        if res is None:
            cap = max(16, int(self.sampling_rate * self.interval_len))
            res = Reservoir(cap, seed=self.seed + stream)
            self.reservoirs[stream] = res
            self.stream_writes[stream] = 0
            self.on_stream_join(stream)
        res.offer(fp)
        self.stream_writes[stream] += 1
        self.writes_in_interval += 1
        if was_inline_dup:
            self._interval_dups += 1
        if self.writes_in_interval >= self.interval_len:
            self.finish_interval()

    # -- triggers ------------------------------------------------------------
    def on_stream_join(self, stream: int) -> None:
        self.predictors.setdefault(stream, HoltPredictor())

    def on_stream_quit(self, stream: int) -> None:
        self.reservoirs.pop(stream, None)
        self.stream_writes.pop(stream, None)
        self.predicted.pop(stream, None)

    def maybe_trigger_on_ratio_drop(self, current_ratio: float, drop: float = 0.5) -> None:
        """Trigger (2): significant drop of inline dedup ratio."""
        if self._last_ratio is not None and current_ratio < self._last_ratio * (1 - drop):
            self.finish_interval()
        self._last_ratio = current_ratio

    # -- estimation ----------------------------------------------------------
    def finish_interval(self) -> None:
        streams = [s for s, n in self.stream_writes.items() if n > 0]
        if not streams:
            return
        self.estimations += 1
        big, small = [], []
        for s in streams:
            if self.stream_writes[s] < self.min_stream_writes:
                small.append(s)
            else:
                big.append(s)

        ldss_now: Dict[int, float] = {s: self.default_small_ldss for s in small}
        if big:
            counts_list = [occurrence_counts(self.reservoirs[s].sample()) for s in big]
            n_writes = np.array([self.stream_writes[s] for s in big], dtype=np.float64)
            if not self.use_unseen:
                # RS-only baseline (paper Fig. 4 dashed lines): scale the raw
                # duplicate count in the sample by the sampling rate
                vals = np.array(
                    [
                        (n / max(c.sum(), 1)) * max(0, c.sum() - len(c))
                        for c, n in zip(counts_list, n_writes)
                    ]
                )
            elif self.batched_solver:
                vals = ldss_batch(counts_list, n_writes, device=self.device)
            else:
                vals = np.array(
                    [
                        max(0.0, n - unseen_estimate_from_counts(c, int(n)))
                        for c, n in zip(counts_list, n_writes)
                    ]
                )
            ldss_now.update({s: float(v) for s, v in zip(big, vals)})

        for s, v in ldss_now.items():
            self.predictors.setdefault(s, HoltPredictor()).observe(v)
            self.predicted[s] = self.predictors[s].predict()

        if self.on_ldss is not None:
            self.on_ldss(dict(self.predicted))

        # interval-factor self-tuning: factor ~= 1 - d (paper §IV-B)
        if self.writes_in_interval > 0:
            d = self._interval_dups / self.writes_in_interval
            self.interval_factor = min(0.9, max(0.1, 1.0 - d))
            self.interval_len = max(256, int(self.interval_factor * self.cache_entries))

        # reset interval state
        for s in streams:
            self.reservoirs[s].reset()
            cap = max(16, int(self.sampling_rate * self.interval_len))
            self.reservoirs[s].k = cap
            self.stream_writes[s] = 0
        self.interval_count += 1
        self.writes_in_interval = 0
        self._interval_dups = 0

    # -- checkpointable state (resumable ingest pipeline + engine snapshots) --
    def state_dict(self) -> dict:
        return {
            "interval_len": self.interval_len,
            "interval_factor": self.interval_factor,
            "reservoirs": {s: r.state_dict() for s, r in self.reservoirs.items()},
            "stream_writes": dict(self.stream_writes),
            "history": {s: list(p.history) for s, p in self.predictors.items()},
            "predicted": dict(self.predicted),
            "interval_count": self.interval_count,
            "writes_in_interval": self.writes_in_interval,
            # bit-exact resume needs the trigger bookkeeping too: interval
            # dups feed the interval-factor self-tuning, last_ratio the
            # ratio-drop trigger
            "interval_dups": self._interval_dups,
            "last_ratio": self._last_ratio,
            "estimations": self.estimations,
        }

    def load_state(self, state: dict) -> None:
        self.interval_len = state["interval_len"]
        self.interval_factor = state["interval_factor"]
        self.reservoirs = {int(s): Reservoir.from_state(r) for s, r in state["reservoirs"].items()}
        self.stream_writes = {int(s): v for s, v in state["stream_writes"].items()}
        self.predictors = {}
        for s, h in state["history"].items():
            p = HoltPredictor()
            p.history = list(h)
            self.predictors[int(s)] = p
        self.predicted = {int(s): v for s, v in state["predicted"].items()}
        self.interval_count = state["interval_count"]
        self.writes_in_interval = state["writes_in_interval"]
        # absent in pre-snapshot checkpoints: fall back to fresh-interval values
        self._interval_dups = state.get("interval_dups", 0)
        self._last_ratio = state.get("last_ratio")
        self.estimations = state.get("estimations", 0)
