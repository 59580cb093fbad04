"""The check's control comes out not correct, on the same sample on which
the program's output comes out correct (the CPU, at a small size; on the
card, at the cell's size, hevc_bench/control.py)."""

import time

import pytest

from hevc_bench import check, harness


@pytest.mark.parametrize("cell,size", [
    ("ldp_1080p_fastest.batch", dict(width=384, height=256)),
    ("ldp_1080p_fastest.live", dict(width=384, height=256)),
])
def test_control_fails(root, cell, size):
    m = harness.Manifest(root)
    seed = 3 * 2 ** 31 + 1
    run = harness.drive(m, cell, seed, 0.5, False,
                        t_start=time.perf_counter(), device="cpu",
                        overrides=size)
    start = harness.check_unit(run, seed)
    sound, _ = check.verify(run, start)
    assert harness.is_correct(sound), sound
    ctrl, _ = check.verify(run, start, control=True)
    assert not harness.is_correct(ctrl)
    assert ctrl["recon_mismatch"]["value"] > 0
