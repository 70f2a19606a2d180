"""The arithmetic of a measured window, kept apart from the card so that it
can be checked against hand-made call logs.

A window runs from the first submission to the return of the final
synchronize.  Every rate is taken over all the work and all the time of
the window; no statistic of chunks or loops stands in for it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence


class Window(NamedTuple):
    """What a window did: ``calls`` calls of ``samples_per_call`` input
    samples each, submitted from ``start`` to the final synchronize's
    return at ``end`` (seconds on one clock)."""

    start: float
    end: float
    calls: int
    samples_per_call: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


def msamples_per_s(window: Window) -> float:
    """Input samples of every call of the window over its seconds, in
    millions a second."""
    if window.calls <= 0 or window.seconds <= 0:
        raise ValueError(f"an empty window: {window}")
    return window.calls * window.samples_per_call / window.seconds / 1e6


def mean_call_ms(window: Window) -> float:
    """The window's seconds over its calls, in ms: the mean time of a call
    where the caller waits for each before it submits the next."""
    if window.calls <= 0 or window.seconds <= 0:
        raise ValueError(f"an empty window: {window}")
    return window.seconds / window.calls * 1e3


def pod_window(windows: Sequence[Window]) -> Window:
    """The window of ranks that ran together: from the earliest start to
    the latest end, with the samples of every rank's calls.  Every rank
    makes the same number of calls (they meet at collectives)."""
    calls = {w.calls for w in windows}
    if len(calls) != 1:
        raise ValueError(f"the ranks made different numbers of calls: "
                         f"{sorted(calls)}")
    return Window(min(w.start for w in windows), max(w.end for w in windows),
                  windows[0].calls,
                  sum(w.samples_per_call for w in windows))

