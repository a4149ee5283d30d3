"""Statistics of the benchmark's numbers."""

from __future__ import annotations


def rate(count: float, start: float, last_end: float) -> float:
    """Work per second from the window's start to the last completion."""
    if last_end <= start:
        raise ValueError("no completion after the window's start")
    return count / (last_end - start)


def union_seconds(intervals: list[tuple[int, int]]) -> float:
    """Seconds covered by at least one of the (start_ns, end_ns) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9
