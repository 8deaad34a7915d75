"""The frozen roofline counts (CPU)."""

import pytest

from benchport import roofline


def test_short_product_of_cell_one_is_bound_by_operations():
    # 4096 queries over 9,990,000 x 96 bf16 rows at pool 82, masked.
    flop, nbytes = roofline.scan_work(4096, 9_990_000, 96, 82, "bf16", masked=True)
    assert flop == 2 * 4096 * 9_990_000 * 96
    assert nbytes == 2 * 9_990_000 * 96 + 4 * 4096 * 96 + 8 * 4096 * 82 + 9_990_000
    t = roofline.scan_bound_s(4096, 9_990_000, 96, 82, "bf16", masked=True)
    assert t == pytest.approx(flop / 989e12)
    assert t == pytest.approx(7.94e-3, rel=1e-2)


def test_bytes_bound_a_thin_scan():
    t = roofline.scan_bound_s(1, 1_000_000, 128, 10, "bf16")
    assert t == pytest.approx((2 * 1_000_000 * 128 + 4 * 128 + 80) / 3.35e12)


def test_f32_tables_at_one_tf32_pass():
    t = roofline.scan_bound_s(4096, 9_990_000, 96, 116, "f32")
    assert t == pytest.approx(2 * 4096 * 9_990_000 * 96 / 495e12)


def test_share_is_never_clamped():
    assert roofline.share_pct(2.0, 1.0) == 200.0
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
