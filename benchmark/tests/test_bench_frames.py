"""frame_ms and frame_ms_p90 on synthetic frame-end times."""
import pytest

from harness import frames


def test_steady_frames():
    ends = [10.0 * (i + 1) for i in range(100)]
    assert frames.frame_ms(ends) == pytest.approx(10.0)
    assert frames.frame_ms_p90(ends) == pytest.approx(10.0)


def test_one_stall_moves_both():
    ends = [10.0 * (i + 1) for i in range(100)]
    stalled = ends[:50] + [e + 200.0 for e in ends[50:]]
    assert frames.frame_ms(stalled) == pytest.approx(12.0)
    assert frames.frame_ms_p90(stalled) == pytest.approx(10.0)
    # ten stalls of 20 ms: the slowest tenth of the frames
    ten = []
    t = 0.0
    for i in range(100):
        t += 30.0 if i % 10 == 0 else 10.0
        ten.append(t)
    assert frames.frame_ms(ten) == pytest.approx(12.0)
    assert frames.frame_ms_p90(ten) > 10.0


def test_intervals_start_at_the_window():
    assert frames.intervals([5.0, 7.0, 12.0]) == [5.0, 2.0, 5.0]


def test_percentile_matches_linear_interpolation():
    v = [float(x) for x in range(1, 11)]
    assert frames.percentile(v, 90.0) == pytest.approx(9.1)
    assert frames.percentile([3.0], 90.0) == 3.0


def test_spread_is_quartile_distance_over_median():
    assert frames.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)
