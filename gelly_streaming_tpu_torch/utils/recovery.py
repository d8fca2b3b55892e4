"""Failure recovery: supervised re-execution from checkpoints.

Port of ``gelly_streaming_tpu/utils/recovery.py``, whole.  Summary state
and the stream position checkpoint uniformly
(``core/aggregation.py`` ``run(checkpoint_path=...)``), so recovery is:
rebuild the pipeline, replay the source, and let the restored position skip
already-folded windows or batches.  This module supplies the supervisor
that does that loop.

Guarantees:
  * summary state is exactly-once: a window folds into the running summary
    exactly once no matter how many restarts happen;
  * emissions are at-least-once: windows emitted after the last snapshot are
    re-emitted on recovery (the reference's Merger behaves the same way).
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, Optional, Tuple, Type

logger = logging.getLogger(__name__)


def run_supervised(
    make_stream: Callable[[], Iterator[tuple]],
    max_restarts: int = 3,
    recoverable: Tuple[Type[BaseException], ...] = (Exception,),
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    max_total_restarts="auto",
) -> Iterator[tuple]:
    """Iterate ``make_stream()``'s records, rebuilding the pipeline on failure.

    ``make_stream`` must build a FRESH record iterator each call, e.g.
    ``lambda: stream_factory().aggregate(agg, checkpoint_path=ckpt)`` where
    the factory replays the input from the beginning; the aggregation's
    restored stream position makes the replay safe.  ``on_restart(attempt,
    exc)`` observes each recovery (metrics/logging hook).

    Two budgets bound the restart loop:
      * ``max_restarts``: consecutive failures without progress; a restart
        that yielded at least one record resets it;
      * ``max_total_restarts``: absolute cap across the whole run ("auto" =
        ``10 * max_restarts``), so a pipeline that deterministically crashes
        on window N+1 after re-emitting window N cannot restart forever.
        Pass ``None`` for indefinitely supervised streams.
    """
    if max_total_restarts == "auto":
        max_total_restarts = 10 * max_restarts
    elif max_total_restarts is None:
        max_total_restarts = float("inf")
    restarts = 0
    total_restarts = 0
    while True:
        progressed = False
        try:
            for record in make_stream():
                progressed = True
                yield record
            return
        except recoverable as e:
            if progressed:
                restarts = 0
            restarts += 1
            total_restarts += 1
            if restarts > max_restarts or total_restarts > max_total_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            logger.warning(
                "pipeline failed (%s); restart %d/%d (total %d/%s) from checkpoint",
                e,
                restarts,
                max_restarts,
                total_restarts,
                "unbounded" if max_total_restarts == float("inf") else max_total_restarts,
            )
