"""The roofline arithmetic reproduces PERF.md's kernel bounds."""

import pytest

from hevc_bench import roofline


def test_me_sad_720p():
    # PERF.md row 1: 720p (736 rows at CTU 32), B 32, S 16, nb 920
    assert (736 // 32) * (1280 // 32) == 920
    assert roofline.me_sad_differences(736, 1280, 32, 16) == pytest.approx(
        1.026e9, rel=1e-3)
    least, by = roofline.me_sad_least_s(736, 1280, 32, 16)
    assert by == "operations"
    assert round(least * 1e3, 4) == 0.0153


def test_me_sad_1080p():
    least, by = roofline.me_sad_least_s(1088, 1920, 32, 16)
    assert by == "operations" and round(least * 1e3, 4) == 0.0340


def test_gather_1080p():
    # PERF.md rows 2m and 2n: luma G 41 and the chroma pair G 19, nb 2,040
    luma = roofline.gather_bytes(1088, 1920, 32, 41, 1)
    assert round(luma / roofline.HBM_BYTES_PER_S * 1e3, 5) == 0.00331
    chroma = roofline.gather_bytes(544, 960, 16, 19, 2)
    assert round(chroma / roofline.HBM_BYTES_PER_S * 1e3, 5) == 0.00151


def test_gather_sites():
    assert roofline.gather_sites(1088, 1920, [32], 16) == [
        (1088, 1920, 32, 41, 1), (544, 960, 16, 19, 2)]
    g = [s[3] for s in roofline.gather_sites(768, 1280, [64, 32, 16], 16)]
    assert g == [73, 35, 41, 19, 25, 11]
    assert len(roofline.gather_sites(768, 1280, [32], 64)) == 3
