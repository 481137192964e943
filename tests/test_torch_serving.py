"""The port's MicroBatcher against the JAX package's, scenario by scenario.

Each scenario of the JAX package's batcher tests runs once through each
class. So that the batches do not depend on thread timing, a blocker
batch holds the worker inside ``run_batch`` while the scenario's
requests queue one at a time, in a fixed order; the blocker is then
released and the worker sees the whole queue at once. Both classes must
hand ``run_batch`` the same batches (group key, queries with their pads,
filter spec, nprobe) and hand each caller the same slice.
"""

import threading
import time

import pytest

from latentrag_torch.serving import MicroBatcher
from latentrag_tpu.serving import MicroBatcher as JaxMicroBatcher

BLOCKER_K = -1  # a group of its own


def _pending(b) -> int:
    with b._cv:
        return sum(len(g) for g in b._pending.values())


def _wait(cond, what, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def run_scenario(cls, requests, *, window_ms, max_batch, fail=False,
                 three_args=False, close_before_release=False,
                 settle=True):
    """Queue ``requests`` (tuples of submit's arguments) behind a blocker
    batch, release it, and return (the batches run_batch got, each
    caller's result or error text, seconds from release to the last
    result)."""
    calls, entered, release = [], threading.Event(), threading.Event()

    def body(queries, k, flt, nprobe=None):
        if k == BLOCKER_K:
            entered.set()
            release.wait(10)
            return list(queries)
        calls.append((k, tuple(queries), flt, nprobe))
        if fail:
            raise RuntimeError("kaboom")
        return [(q, k, flt, nprobe) for q in queries]

    if three_args:
        def run_batch(queries, k, flt):
            return body(queries, k, flt)
    else:
        run_batch = body
    b = cls(run_batch, window_ms=window_ms, max_batch=max_batch)
    out = [None] * len(requests)

    def submit(i, args):
        try:
            out[i] = list(b.submit(*args))
        except Exception as e:  # noqa: BLE001 - recorded per caller
            out[i] = f"{type(e).__name__}: {e}"

    # a full batch: it dispatches at once, whatever the window
    blocker = threading.Thread(target=lambda: b.submit(
        ["blocker"] * max_batch, BLOCKER_K, None, None))
    blocker.start()
    assert entered.wait(10)
    threads = []
    for i, args in enumerate(requests):
        t = threading.Thread(target=submit, args=(i, args))
        t.start()
        threads.append(t)
        _wait(lambda: _pending(b) == i + 1, f"request {i} to queue")
    if settle:  # every group's window has elapsed at release
        time.sleep(window_ms / 1e3 + 0.02)
    closer = None
    if close_before_release:
        closer = threading.Thread(target=b.close)
        closer.start()
        _wait(lambda: b._closed, "close")
    t0 = time.monotonic()
    release.set()
    for t in threads + [blocker]:
        t.join(timeout=20)
        assert not t.is_alive()
    elapsed = time.monotonic() - t0
    if closer is not None:
        closer.join(timeout=20)
        assert not closer.is_alive()
    else:
        b.close()
    return calls, out, elapsed


def _singles(n, k=5, prefix="q"):
    return [([f"{prefix}{i}"], k, None, None) for i in range(n)]


SCENARIOS = {
    # eight singles in one window coalesce into one batch of eight
    "coalesces": dict(requests=_singles(8), window_ms=50, max_batch=64),
    # (k, filter key) groups never mix; three of each pad to four
    "groups_by_k_and_filter_key": dict(
        requests=[(["a1"], 3, {"x": 1}, "fk1"), (["b0"], 7, None, None),
                  (["a3"], 3, {"x": 1}, "fk1"), (["b2"], 7, None, None),
                  (["a5"], 3, {"x": 1}, "fk1"), (["b4"], 7, None, None)],
        window_ms=40, max_batch=64),
    # nprobe is part of the key and reaches run_batch as a keyword
    "groups_by_nprobe": dict(
        requests=[(["d0"], 3, None, None), (["p1"], 3, None, None, 16),
                  (["d2"], 3, None, None), (["p3"], 3, None, None, 16)],
        window_ms=40, max_batch=64),
    # a callback written without nprobe still works
    "three_arg_callback": dict(requests=_singles(2, k=2), window_ms=5,
                               max_batch=8, three_args=True),
    # eight singles against a cap of four flush at the cap, long before
    # the 3 s window
    "max_batch_flushes_early": dict(requests=_singles(8, k=1),
                                    window_ms=3000, max_batch=4,
                                    settle=False),
    # a batch-level error reaches every member
    "error_fans_out": dict(requests=_singles(3, k=2), window_ms=30,
                           max_batch=64, fail=True),
    # close drains what is queued
    "close_drains": dict(requests=_singles(3, k=1), window_ms=3000,
                         max_batch=8, close_before_release=True,
                         settle=False),
    # an indivisible member larger than the cap dispatches alone, unpadded
    "oversized_single": dict(
        requests=[([f"q{i}" for i in range(6)], 1, None, None)],
        window_ms=5, max_batch=4),
    # the cap splits ten singles 3 + 3 + 3 + 1, everyone served
    "cap_splits": dict(requests=_singles(10, k=1), window_ms=200,
                       max_batch=3),
    # three singles pad up to four
    "pads_to_power_of_two": dict(requests=_singles(3), window_ms=40,
                                 max_batch=64),
}

# the batch sizes each scenario must hand run_batch
SIZES = {
    "coalesces": [8],
    "groups_by_k_and_filter_key": [4, 4],
    "groups_by_nprobe": [2, 2],
    "three_arg_callback": [2],
    "max_batch_flushes_early": [4, 4],
    "error_fans_out": [4],
    "close_drains": [4],
    "oversized_single": [6],
    "cap_splits": [3, 3, 3, 1],
    "pads_to_power_of_two": [4],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_microbatcher_matches_jax(name):
    kw = SCENARIOS[name]
    calls, out, elapsed = run_scenario(MicroBatcher, **kw)
    want_calls, want_out, _ = run_scenario(JaxMicroBatcher, **kw)
    assert calls == want_calls
    assert out == want_out
    assert [len(c[1]) for c in calls] == SIZES[name]
    for (queries, k, flt, *rest), got in zip(kw["requests"], out):
        if kw.get("fail"):
            assert got == "RuntimeError: kaboom"
        else:  # each caller gets exactly its own queries back
            nprobe = rest[1] if len(rest) > 1 else None
            assert got == [(q, k, flt, nprobe) for q in queries]
    if name.startswith("groups_by"):  # no batch mixes two groups
        assert all(len({q[0] for q in c[1]}) == 1 for c in calls)
    if name == "max_batch_flushes_early":
        assert elapsed < 2.0


def test_microbatcher_close_rejects_new():
    for cls in (MicroBatcher, JaxMicroBatcher):
        b = cls(lambda queries, k, flt: list(queries), window_ms=5,
                max_batch=8)
        assert list(b.submit(["x"], 1, None, None)) == ["x"]
        b.close()
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(["y"], 1, None, None)
