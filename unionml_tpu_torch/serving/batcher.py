"""Request coalescing: merge concurrent /predict requests into one predictor call.

A copy of ``unionml_tpu/serving/batcher.py`` (standard library only).

The resident graph's cost is nearly flat across the batch bucket, so N concurrent
single-row requests served individually waste N-1 executions. The batcher queues
feature rows from concurrent requests, drains the queue up to ``max_batch`` rows
(waiting at most ``max_wait_ms`` for stragglers after the first arrival), runs ONE
predictor call, and fans results back out to the waiting requests.

Correctness contract: feature payloads must be row-lists (the `/predict
{"features": [...]}` shape) and the predictor must return one result per row; anything
else bypasses coalescing (the caller falls back to per-request prediction).
"""

import asyncio
from typing import Any, Callable, List, Optional, Sequence

from unionml_tpu_torch._logging import logger


class RequestBatcher:
    """Coalesces concurrent row-list predictions into shared predictor calls."""

    def __init__(
        self,
        predict_rows: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        adaptive: bool = True,
        preferred_multiple: Optional[int] = None,
    ):
        """
        ``adaptive=True`` keys the straggler wait on the observed arrival rate: when
        requests arrive sparsely (EMA inter-arrival gap above ``max_wait_ms``),
        waiting would add latency and coalesce nothing, so batches flush
        immediately; under bursts the full ``max_wait_ms`` window applies.

        ``preferred_multiple`` (mesh-sharded predictors: the data-axis shard
        count) grants one extra ``max_wait_ms`` straggler window when the drained
        row count is not a multiple — a shard-even batch pads less after
        bucketing — but never blocks a flush beyond that: correctness and the
        bounded-latency contract are unchanged.
        """
        self._predict_rows = predict_rows
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.adaptive = adaptive
        self.preferred_multiple = (
            int(preferred_multiple) if preferred_multiple and preferred_multiple > 1 else None
        )
        self._ema_gap_s: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._queue: Optional[asyncio.Queue] = None
        self._worker: Optional[asyncio.Task] = None
        self.stats = {"requests": 0, "rows": 0, "batches": 0}

    def _ensure_worker(self) -> None:
        if self._queue is None:
            self._queue = asyncio.Queue()
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_running_loop().create_task(self._run())

    async def submit(self, rows: List[Any]) -> List[Any]:
        """Queue one request's rows; resolves with that request's predictions."""
        self._ensure_worker()
        now = asyncio.get_running_loop().time()
        if self._last_arrival is not None:
            # clamp: one long idle period must not poison the EMA for the burst
            # that follows it (recovery would otherwise take dozens of requests)
            gap = min(now - self._last_arrival, 10 * self.max_wait_s)
            self._ema_gap_s = gap if self._ema_gap_s is None else 0.8 * self._ema_gap_s + 0.2 * gap
        self._last_arrival = now
        future = asyncio.get_running_loop().create_future()
        self.stats["requests"] += 1
        self.stats["rows"] += len(rows)
        await self._queue.put((rows, future))
        return await future

    @property
    def ema_gap_ms(self) -> Optional[float]:
        """Observed EMA inter-arrival gap (ms); None before any traffic."""
        return None if self._ema_gap_s is None else self._ema_gap_s * 1e3

    def _effective_wait_s(self) -> float:
        """The straggler window for this batch under the adaptive policy."""
        if not self.adaptive or self._ema_gap_s is None:
            return self.max_wait_s
        if self._ema_gap_s > self.max_wait_s:
            return 0.0  # sparse traffic: waiting only adds latency
        return self.max_wait_s

    async def _run(self) -> None:
        while True:
            rows, future = await self._queue.get()
            pending = [(rows, future)]
            total = len(rows)
            deadline = asyncio.get_running_loop().time() + self._effective_wait_s()
            topped_up = False
            while total < self.max_batch:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    # window spent (or adaptive zero-wait): still drain whatever is
                    # ALREADY queued — simultaneous arrivals must coalesce even when
                    # the straggler wait is zero
                    while total < self.max_batch:
                        try:
                            more_rows, more_future = self._queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        pending.append((more_rows, more_future))
                        total += len(more_rows)
                    if (
                        self.preferred_multiple
                        and not topped_up
                        and total % self.preferred_multiple != 0
                        and total < self.max_batch
                    ):
                        # mesh-sharded predictor: one extra window to reach a
                        # shard-even row count, then flush regardless
                        topped_up = True
                        deadline = asyncio.get_running_loop().time() + self.max_wait_s
                        continue
                    break
                try:
                    more_rows, more_future = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    continue  # loop re-checks the deadline (and the top-up rule)
                pending.append((more_rows, more_future))
                total += len(more_rows)
                if (
                    self.preferred_multiple
                    and topped_up
                    and total % self.preferred_multiple == 0
                ):
                    break  # top-up reached a shard-even count: flush now
            await self._flush(pending)

    async def _flush(self, pending) -> None:
        self.stats["batches"] += 1
        all_rows: List[Any] = []
        for rows, _ in pending:
            all_rows.extend(rows)
        try:
            predictions = await asyncio.get_running_loop().run_in_executor(
                None, self._predict_rows, all_rows
            )
            predictions = _as_row_sequence(predictions, len(all_rows))
            offset = 0
            for rows, future in pending:
                if not future.done():
                    future.set_result(predictions[offset : offset + len(rows)])
                offset += len(rows)
        except Exception as exc:
            logger.exception("Coalesced prediction failed")
            for _, future in pending:
                if not future.done():
                    future.set_exception(exc)
        finally:
            # cancellation (close() mid-flush) is a BaseException: never strand waiters
            for _, future in pending:
                if not future.done():
                    future.set_exception(RuntimeError("batcher shut down mid-request"))

    def close(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            self._worker = None
        # fail any requests still queued: their handlers must not hang on shutdown
        if self._queue is not None:
            while not self._queue.empty():
                _, future = self._queue.get_nowait()
                if not future.done():
                    future.set_exception(RuntimeError("batcher shut down before dispatch"))


def _as_row_sequence(predictions: Any, n_rows: int) -> List[Any]:
    """Coerce predictor output to a per-row list, rejecting ambiguous shapes.

    A bare ``list()`` would iterate a mapping's KEYS or a DataFrame's COLUMNS — when
    either count coincides with the row count, requests would silently receive
    garbage; only explicit row-sequence types are accepted.
    """
    from collections.abc import Mapping

    if isinstance(predictions, Mapping):
        raise ValueError("coalescing requires a per-row sequence; predictor returned a mapping")
    if hasattr(predictions, "iloc"):  # pandas: rows as records
        rows = predictions.to_dict(orient="records") if hasattr(predictions, "to_dict") else None
        if rows is None or len(rows) != n_rows:
            raise ValueError("coalescing requires one result per row")
        return rows
    if hasattr(predictions, "shape"):  # numpy / torch: first axis is the row axis
        if predictions.ndim < 1 or predictions.shape[0] != n_rows:
            raise ValueError(
                f"predictor returned shape {getattr(predictions, 'shape', None)} for {n_rows} rows"
            )
        return list(predictions)
    if isinstance(predictions, (list, tuple)):
        if len(predictions) != n_rows:
            raise ValueError(
                f"predictor returned {len(predictions)} results for {n_rows} rows; "
                "coalescing requires one result per row"
            )
        return list(predictions)
    raise ValueError(f"coalescing cannot split predictor output of type {type(predictions)!r}")
