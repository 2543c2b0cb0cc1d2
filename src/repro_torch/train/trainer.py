"""Training loop with checkpoint/restart, failure injection and straggler
mitigation: the port's counterpart of the reference's ``train/trainer.py``.

* **Checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps
  hold the params, the optimizer state *and* the data pipeline's dedup
  state; on any step failure the trainer restores the latest complete
  checkpoint and replays from there.
* **Failure injection**: ``chaos`` gets the step index and may raise.
* **Straggler mitigation**: batches come through a bounded prefetch queue
  fed by a producer thread; if the next batch misses its deadline (EMA *
  factor), the trainer makes it itself (a backup producer).

Batches come as numpy, as the pipeline makes them, and go to the device the
parameters lie on.  Three faults of the reference are repaired here
(ROADMAP.md §3):

* (a) An exception raised in the reference's producer thread ends the
  thread in silence, and the trainer's next ``get`` waits forever.  Here
  ``get`` raises it, after the batches made before it, so the trainer's
  failure handling sees it; the restore, or with nothing to restore a new
  producer, makes the batch again.  That needs a batch iterator that
  survives an exception, as ``DedupIngestPipeline.batches`` does (a
  generator ends with its first exception); an iterator that ends stops the
  run with ``RuntimeError``.
* (b) The reference's producer drops the batch it made when the queue stays
  full for 0.5 s, behind any step slower than that.  Here the producer
  waits for room before it makes a batch, and keeps every batch it made.
* (c) The reference takes the pipeline's state while its producer runs up
  to ``depth + 1`` batches ahead of the trainer, so a restore skips the
  batches made but not consumed.  Here a batch is made and queued under one
  lock, and a checkpoint takes the pipeline's state under that lock together
  with the batches queued but not consumed (``extra["prefetched"]``); a
  restore serves those first.  A backup batch is the next one in order too:
  the backup first takes what the producer queued while it waited for the
  lock.  So the trainer consumes the batches in the order they were made,
  whatever the timing, and the batches after a restore are the
  uninterrupted run's.  A checkpoint without ``prefetched`` (the
  reference's) restores as the reference restores it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..pytree import leaves
from .optimizer import AdamW
from .train_step import make_grad_accum_train_step, make_train_step, trainable


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 20
    ckpt_async: bool = False
    microbatches: int = 1
    log_every: int = 10
    straggler_deadline_factor: float = 4.0


class PrefetchQueue:
    """Bounded prefetch with a backup producer for late batches.

    A producer thread calls ``batch_fn`` while fewer than ``depth`` batches
    wait, ``primed`` ones first.  Batches are served in the order they were
    made.  An exception from ``batch_fn`` ends the producer, and ``get``
    raises it once the batches made before it are served."""

    def __init__(self, batch_fn: Callable[[], Any], depth: int = 2, primed: Iterable = ()):
        self.batch_fn = batch_fn
        self.depth = depth
        self.backup_fires = 0
        self._ready = collections.deque(primed)
        self._failure: Optional[Exception] = None
        self._stopping = False
        self._make_lock = threading.Lock()  # batch_fn state is not thread-safe
        self._cond = threading.Condition()  # guards _ready, _failure, _stopping
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: len(self._ready) < self.depth or self._stopping)
                if self._stopping:
                    return
            with self._make_lock:
                try:
                    made = self.batch_fn()
                except Exception as e:  # raised by ``get``
                    with self._cond:
                        self._failure = e
                        self._cond.notify_all()
                    return
                with self._cond:
                    self._ready.append(made)
                    self._cond.notify_all()

    def _take(self) -> Any:
        """The oldest batch made, or the producer's exception; under ``_cond``."""
        if self._ready:
            item = self._ready.popleft()
            self._cond.notify_all()
            return item
        raise self._failure

    def get(self, deadline_s: Optional[float]) -> Any:
        with self._cond:
            if self._cond.wait_for(lambda: self._ready or self._failure, timeout=deadline_s):
                return self._take()
        # straggler: make the batch here, unless the producer queued it while
        # this waited for the lock
        self.backup_fires += 1
        with self._make_lock:
            with self._cond:
                if self._ready or self._failure:
                    return self._take()
            return self.batch_fn()

    def snapshot(self, state_fn: Callable[[], Any]) -> Tuple[Any, List[Any]]:
        """``state_fn()`` and the batches made but not served, taken while no
        batch is being made.  Raises the producer's exception, which may
        have left the batch function's state half changed."""
        with self._make_lock, self._cond:
            if self._failure is not None:
                raise self._failure
            return state_fn(), list(self._ready)

    def stop(self) -> List[Any]:
        """End the producer (after the batch it is making) and return the
        batches made but not served, oldest first."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join()
        return list(self._ready)


class Trainer:
    def __init__(
        self,
        model,
        opt: AdamW,
        params,
        batch_iter: Iterator[Dict[str, np.ndarray]],
        cfg: TrainerConfig,
        pipeline_state_fn: Optional[Callable[[], dict]] = None,
        pipeline_restore_fn: Optional[Callable[[dict], None]] = None,
        chaos: Optional[Callable[[int], None]] = None,
    ):
        """``params`` are trained in place (``train_step.trainable``)."""
        self.model = model
        self.opt = opt
        self.cfg = cfg
        self.params = trainable(params)
        self.device = leaves(self.params)[0].device
        self.opt_state = opt.init(self.params)
        self.batch_iter = batch_iter
        self.pipeline_state_fn = pipeline_state_fn
        self.pipeline_restore_fn = pipeline_restore_fn
        self.chaos = chaos
        self._step = (
            make_grad_accum_train_step(model, opt, cfg.microbatches)
            if cfg.microbatches > 1
            else make_train_step(model, opt)
        )
        self.losses: list = []
        self.restarts = 0
        self.step = 0
        self.backup_fires = 0
        self._step_ema: Optional[float] = None
        self._prefetch: Optional[PrefetchQueue] = None

    def _next_batch(self) -> Dict[str, np.ndarray]:
        return next(self.batch_iter)

    def _start_prefetch(self, primed: Iterable = ()) -> None:
        """A new producer, serving ``primed`` first; the old one is stopped."""
        if self._prefetch is not None:
            self._prefetch.stop()
            self.backup_fires += self._prefetch.backup_fires
        self._prefetch = PrefetchQueue(self._next_batch, primed=primed)

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    # -- checkpointing ----------------------------------------------------------
    def _save(self):
        if not self.cfg.ckpt_dir:
            return
        extra = {"losses": [float(l) for l in self.losses], "step": self.step}
        if self.pipeline_state_fn:
            state, pending = self._prefetch.snapshot(
                lambda: _jsonable(self.pipeline_state_fn()))
            extra["pipeline"] = state
            extra["prefetched"] = _jsonable(pending)
        ckpt.save(
            self.cfg.ckpt_dir,
            self.step,
            {"params": self.params, "opt": self.opt_state},
            extra=extra,
            async_save=self.cfg.ckpt_async,
        )

    def _restore_latest(self) -> bool:
        if not self.cfg.ckpt_dir:
            return False
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return False
        pending = self._prefetch.stop()  # no producer uses the pipeline while it is restored
        tree = ckpt.restore(self.cfg.ckpt_dir, step, {"params": self.params, "opt": self.opt_state})
        self.params, self.opt_state = trainable(tree["params"]), tree["opt"]
        extra = ckpt.restore_extra(self.cfg.ckpt_dir, step)
        self.losses = list(extra.get("losses", []))[: step]
        if self.pipeline_restore_fn and "pipeline" in extra:
            self.pipeline_restore_fn(_unjsonable(extra["pipeline"]))
            pending = _unjsonable(extra.get("prefetched", []))
        self._start_prefetch(pending)
        self.step = step
        return True

    # -- main loop ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        self._start_prefetch()
        try:
            while self.step < self.cfg.steps:
                try:
                    if self.chaos:
                        self.chaos(self.step)
                    deadline = (
                        self._step_ema * self.cfg.straggler_deadline_factor
                        if self._step_ema
                        else None
                    )
                    t0 = time.time()
                    batch = self._device_batch(self._prefetch.get(deadline))
                    self.params, self.opt_state, loss, _ = self._step(
                        self.params, self.opt_state, batch
                    )
                    loss = float(loss)
                    dt = time.time() - t0
                    self._step_ema = dt if self._step_ema is None else 0.9 * self._step_ema + 0.1 * dt
                    self.losses.append(loss)
                    self.step += 1
                    if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                        print(f"step {self.step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
                    if self.cfg.ckpt_every and self.step % self.cfg.ckpt_every == 0:
                        self._save()
                except KeyboardInterrupt:
                    raise
                except StopIteration as e:
                    raise RuntimeError(f"step {self.step}: the batch iterator ended") from e
                except Exception as e:  # node failure model: restore + continue
                    self.restarts += 1
                    restored = self._restore_latest()
                    if not restored:  # a producer that failed has ended: replace it
                        self._start_prefetch(self._prefetch.stop())
                    print(f"step {self.step}: failure ({type(e).__name__}: {e}); "
                          f"restored={restored}; restarts={self.restarts}")
                    if not restored and self.restarts > 3:
                        raise
        finally:
            self._prefetch.stop()
            self.backup_fires += self._prefetch.backup_fires
        self._save()
        return {
            "losses": self.losses,
            "restarts": self.restarts,
            "backup_fires": self.backup_fires,
            "final_step": self.step,
        }


def _jsonable(obj):
    """Make numpy-bearing nested state JSON-serializable."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"__nd__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _unjsonable(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return np.asarray(obj["__nd__"], dtype=obj["dtype"])
        return {k: _unjsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonable(v) for v in obj]
    return obj
