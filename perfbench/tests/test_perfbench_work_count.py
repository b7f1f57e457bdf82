"""The screen's work count at a tiny shape, and the least time."""
import pytest

from perfbench import work_count


def test_screen_work_at_a_tiny_shape():
    # 8 rows, 4 dims, d1 above the width: the lead block is the whole row
    nbytes, flops = work_count.screen_work(8, 4, 128, 3)
    assert nbytes == 4 * (8 * 4 + 3 * 4 + 3) + 8 * 3
    assert flops == 2 * 8 * 3 * 4


def test_lead_block_is_d1_when_narrower():
    nbytes, flops = work_count.screen_work(1000, 960, 128, 100)
    assert flops == 2.0 * 1000 * 100 * 128
    assert nbytes == 4 * (1000 * 128 + 100 * 128 + 100) + 1000 * 100


@pytest.mark.parametrize("nbytes,flops,want", [
    (3.35e12, 0.0, 1.0), (0.0, 67e12, 1.0), (3.35e12, 134e12, 2.0)])
def test_least_seconds_takes_the_larger_bound(nbytes, flops, want):
    assert work_count.least_seconds(nbytes, flops) == pytest.approx(want)
