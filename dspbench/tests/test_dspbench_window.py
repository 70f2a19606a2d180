"""The window arithmetic against hand-made call logs."""

import math

import pytest

from dspbench.window import Window, mean_call_ms, msamples_per_s, pod_window


def test_rate_is_every_call_over_the_whole_window():
    # 7 calls of 3e6 samples from t = 10.0 to the final sync at 10.5 s.
    w = Window(10.0, 10.5, 7, 3_000_000)
    assert w.seconds == pytest.approx(0.5)
    assert msamples_per_s(w) == pytest.approx(7 * 3.0 / 0.5)


def test_mean_call_is_the_window_over_its_calls():
    # A caller that waits for each call: 4 calls in 10 ms.
    assert mean_call_ms(Window(2.0, 2.01, 4, 1)) == pytest.approx(2.5)


@pytest.mark.parametrize("w", [Window(1.0, 1.0, 3, 5), Window(1.0, 2.0, 0, 5)])
def test_an_empty_window_is_refused(w):
    with pytest.raises(ValueError):
        msamples_per_s(w)
    with pytest.raises(ValueError):
        mean_call_ms(w)


def test_pod_window_spans_every_rank_and_sums_their_samples():
    ranks = [Window(5.0, 6.0, 10, 100), Window(5.1, 6.2, 10, 100),
             Window(4.9, 6.1, 10, 100), Window(5.0, 6.0, 10, 100)]
    w = pod_window(ranks)
    assert (w.start, w.end, w.calls, w.samples_per_call) == (4.9, 6.2, 10,
                                                             400)
    assert msamples_per_s(w) == pytest.approx(10 * 400 / 1.3 / 1e6)


def test_pod_window_refuses_ranks_that_made_different_calls():
    with pytest.raises(ValueError):
        pod_window([Window(0, 1, 10, 1), Window(0, 1, 9, 1)])



def test_a_reading_that_is_not_a_number_is_the_worst():
    from dspbench.harness import worse, worst_row
    assert worse(0.0, math.nan) == math.inf
    assert worse(math.nan, 1e-7) == math.inf
    assert worse(2e-7, 1e-7) == 2e-7
    assert worst_row([4.0, 1.0], [1.0, 1.0]) == 2.0
    assert worst_row([1.0, math.nan, 0.0], [1.0, 1.0, 1.0]) == math.inf
    assert worst_row([1.0, math.inf], [1.0, 1.0]) == math.inf
