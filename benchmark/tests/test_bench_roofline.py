"""The roofline bounds are functions of the frame's shapes and the scene's
triangle count alone."""
import pytest

from harness import roofline


def test_k1_msaa_bound_is_bytes_bound_at_4k():
    b = roofline.k1_msaa_bound_s(3840, 2160, 28868)
    px = 3840 * 2160
    want = (28868 * roofline.TRI_GBUF_BYTES
            + px * roofline.GBUF_MSAA_PIXEL_BYTES) / roofline.PEAK_BYTES_PER_S
    assert b == pytest.approx(want)
    assert b > px * roofline.OPS_GBUF_MSAA / roofline.PEAK_F32_FLOP_PER_S


@pytest.mark.parametrize("w,h,t", [(3840, 2160, 28868), (3840, 540, 28868),
                                   (1920, 1080, 649412)])
def test_k1_bound_scales_with_shapes_only(w, h, t):
    a = roofline.k1_msaa_bound_s(w, h, t)
    assert roofline.k1_msaa_bound_s(w, h, t) == a
    assert roofline.k1_msaa_bound_s(2 * w, h, t) > a
    assert roofline.k1_msaa_bound_s(w, h, 2 * t) > a


def test_k2_bound_counts_every_triangle_once_per_view():
    one = roofline.k2_bound_s(1024, 649412)
    assert one == pytest.approx(
        (649412 * roofline.TRI_CLIP_BYTES + 1024 ** 2 * 8)
        / roofline.PEAK_BYTES_PER_S)


def test_share_is_none_without_time():
    assert roofline.share_percent(1.0, 0.0) is None
    assert roofline.share_percent(1.0, 4.0) == pytest.approx(25.0)
