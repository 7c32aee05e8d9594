"""Async meta-batch pipeline (port of ``repro/data/pipeline.py``).

Episode generation is host-side numpy.  :class:`MetaBatchPipeline` moves
sampling onto a background thread, which also converts each episode into
page-locked (pinned) host tensors, so episode ``i+1`` is ready while the
card runs step ``i``.  The copy to the card is issued by the *consumer*, in
``__next__``, as ``.to(device, non_blocking=True)`` on the consumer's
current stream: the step that reads the batch is ordered after its copy by
the stream itself, so no second stream can race the step.

``depth=0`` is the synchronous fallback (no thread, sample-on-demand); any
depth produces the identical batch sequence because
``TaskSource.sample(step)`` is a pure function of ``step``.

``stack=C`` feeds the superstep driver: each item is C consecutive
episodes, handed to ``prepare`` as a list (grouped, never reordered).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

from repro_torch.data.episodes import TaskSource, host_tensors, to_device
from repro_torch.device import resolve_device

__all__ = ["MetaBatchPipeline"]

_POLL_S = 0.05


class MetaBatchPipeline:
    """Iterator of ``(support, query)`` tensor batches on ``device`` drawn
    from a :class:`TaskSource`, ``source.sample(step)`` for
    ``step = start_step, start_step+1, ...``.

    Args:
      source:     any TaskSource.
      device:     where batches land (None: the CUDA card, raising if
                  there is none).
      depth:      prefetch buffer depth; 0 = synchronous (no thread).
      start_step: first step index (e.g. a restored checkpoint's step).
      prepare:    ``Episode -> numpy pytree`` run on the producer side
                  (default: ``(support, query)``); with ``stack > 1`` it
                  receives a list of ``stack`` consecutive Episodes, and
                  must be given.
      stack:      meta-batches per item (the superstep's dispatch); the
                  sample sequence is the same for every ``stack``.
      extras:     tensors already on ``device`` added to every (dict) item
                  as it is handed out: the modality stubs, the same for
                  every batch, made once.
    """

    def __init__(self, source: TaskSource, device=None, *, depth: int = 2,
                 start_step: int = 0,
                 prepare: Callable[[Any], Any] | None = None,
                 stack: int = 1, extras: dict | None = None):
        if stack < 1:
            raise ValueError(f"stack must be >= 1, got {stack}")
        if stack > 1 and prepare is None:
            raise ValueError("stack > 1 needs a prepare that takes a list "
                             "of episodes")
        self.source = source
        self.device = resolve_device(device)
        self.depth = depth
        self.stack = stack
        self.extras = extras or {}
        self._prepare = prepare if prepare is not None else (
            lambda ep: (ep.support, ep.query))
        self._pin = self.device.type == "cuda"
        self._step = start_step
        self._exc: BaseException | None = None
        self._thread = None
        if depth > 0:
            self._queue: queue.Queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._worker, name="meta-batch-prefetch", daemon=True)
            self._thread.start()

    # --- producer ----------------------------------------------------------

    def _sample_item(self, step: int):
        """One host-side item: ``prepare`` of the episode (or of ``stack``
        consecutive episodes) as CPU tensors, pinned when the batches go to
        a card."""
        if self.stack == 1:
            item = self._prepare(self.source.sample(step))
        else:
            item = self._prepare([self.source.sample(step + j)
                                  for j in range(self.stack)])
        return host_tensors(item, pin=self._pin)

    def _worker(self) -> None:
        step = self._step
        try:
            while not self._stop.is_set():
                item = self._sample_item(step)
                step += self.stack
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced to the consumer in __next__
            self._exc = e
            self._stop.set()

    # --- consumer ----------------------------------------------------------

    def __iter__(self) -> "MetaBatchPipeline":
        return self

    def __next__(self):
        if self.depth <= 0:
            item = self._sample_item(self._step)
        else:
            while True:
                try:
                    item = self._queue.get(timeout=_POLL_S)
                    break
                except queue.Empty:
                    if self._exc is not None:
                        raise RuntimeError(
                            "MetaBatchPipeline prefetch worker failed"
                        ) from self._exc
                    if self._thread is None or not self._thread.is_alive():
                        raise StopIteration   # stop() was called
        self._step += self.stack
        item = to_device(item, self.device)
        return {**item, **self.extras} if self.extras else item

    @property
    def step(self) -> int:
        """Index of the next episode the consumer will receive."""
        return self._step

    # --- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        while True:  # drain so a blocked put() observes the stop event
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        self._thread = None
        while True:  # a blocked put() may have landed one last item
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "MetaBatchPipeline":
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()

