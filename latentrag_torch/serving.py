"""Dynamic micro-batching for concurrent serving (HTTP mode).

The port's own copy of the JAX package's ``serving.py``. The fold and
exact kernels score a batch of 64 queries at about the cost of one (they
are bound by reading the corpus, not by the batch), and the encoder runs
a padded batch bucket either way, so under concurrent load the right
serving shape is to COALESCE in-flight requests into one device call
instead of serializing them. The classic dynamic-batching discipline
(cf. TF Serving / Triton): the first request of a group opens a small
window; requests arriving within it join the batch (up to
``max_batch``); one encode + search runs; results are split back per
caller.

Groups are keyed by everything that changes the result semantics: (k,
canonical filter key, nprobe). Mutations (add/remove) do not route here:
they take the serve lock directly, and the batch runner itself runs
under that same lock, so mutation/search interleaving is unchanged.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Sequence


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into batched ``run_batch``.

    ``run_batch(queries: list[str], k: int, filter: dict | None)`` must
    return ONE sliceable sequence (list or array) whose leading axis is
    ``len(queries)``, e.g. a list of per-query hit lists assembled under
    the caller's lock, so result assembly can never race a concurrent
    index mutation. ``submit`` blocks until its slice is ready and
    re-raises any batch-level exception in every waiting caller.

    Requests carrying a per-request ``nprobe`` group separately: the knob
    changes result semantics, so it is part of the group key;
    ``run_batch`` receives it as a keyword only when set (3-argument
    callbacks keep working unchanged).
    """

    def __init__(
        self,
        run_batch: Callable[[Sequence[str], int, dict | None], Any],
        window_ms: float = 5.0,
        max_batch: int = 64,
    ):
        self._run_batch = run_batch
        self._window_s = max(0.0, window_ms) / 1e3
        self._max_batch = max(1, max_batch)
        self._cv = threading.Condition()
        # group key -> list of (queries, filter_spec, future, n)
        self._pending: dict[Any, list] = {}
        self._opened_at: dict[Any, float] = {}
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public

    def submit(
        self, queries: Sequence[str], k: int, filter: dict | None,
        filter_key: str | None, nprobe: int | None = None,
    ):
        """Enqueue and block until the coalesced batch completes.

        ``filter_key`` is the caller-computed canonical key (None for
        unfiltered): the batcher never interprets the spec itself.
        """
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            key = (int(k), filter_key, nprobe)
            group = self._pending.setdefault(key, [])
            if not group:
                self._opened_at[key] = time.monotonic()
            group.append((list(queries), filter, fut, len(queries)))
            self._cv.notify_all()
        return fut.result()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=10)
        # fail anything still queued so no caller blocks forever
        with self._cv:
            for group in self._pending.values():
                for _, _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(
                            RuntimeError("MicroBatcher closed")
                        )
            self._pending.clear()

    # ------------------------------------------------------------- worker

    def _take_ready(self):
        """Under the lock: pop (up to ``max_batch`` queries of) the first
        group whose window elapsed or whose size reached max_batch;
        returns (key, items) or None. max_batch is a hard CAP on the
        dispatched batch, not just a flush trigger: it bounds the batch
        sizes the encoder and the kernels see (a single oversized submit
        still dispatches alone)."""
        now = time.monotonic()
        for key, group in self._pending.items():
            size = sum(n for *_, n in group)
            if not (
                self._closed  # drain everything on close
                or size >= self._max_batch
                or now - self._opened_at[key] >= self._window_s
            ):
                continue
            taken, total = [], 0
            while group and (
                not taken or total + group[0][3] <= self._max_batch
            ):
                item = group.pop(0)
                taken.append(item)
                total += item[3]
            if group:  # leftovers dispatch on the next loop pass
                self._opened_at[key] = now - self._window_s
            else:
                del self._pending[key]
                del self._opened_at[key]
            return key, taken
        return None

    def _next_deadline(self):
        if not self._opened_at:
            return None
        return min(self._opened_at.values()) + self._window_s

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed and not self._pending:
                        return
                    ready = self._take_ready()
                    if ready is not None:
                        break
                    deadline = self._next_deadline()
                    if deadline is None:
                        self._cv.wait()
                    else:
                        self._cv.wait(
                            timeout=max(0.0, deadline - time.monotonic())
                        )
            key, group = ready
            k, _, nprobe = key
            queries = [q for qs, *_ in group for q in qs]
            # pad the coalesced batch UP to the next power of two, so live
            # traffic touches only O(log max_batch) batch shapes (the
            # encoder's batch buckets, the kernels' query tiles). Pad rows
            # repeat the last query; the per-member fan-out below never
            # reads them.
            n_real = len(queries)
            bucket = 1
            while bucket < n_real:
                bucket <<= 1
            bucket = min(bucket, max(self._max_batch, n_real))
            if bucket > n_real:
                queries = queries + [queries[-1]] * (bucket - n_real)
            # all members share the canonical filter key, so the first
            # member's spec is the group's spec
            spec = group[0][1]
            try:
                out = self._run_batch(
                    queries, k, spec,
                    **({"nprobe": nprobe} if nprobe is not None else {}),
                )
            except Exception as e:  # noqa: BLE001 - fan the error out
                for _, _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            pos = 0
            for _, _, fut, n in group:
                if not fut.done():
                    fut.set_result(out[pos:pos + n])
                pos += n
