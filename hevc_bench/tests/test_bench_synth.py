"""The generator: deterministic in the seed, cuts every shot_frames."""

import numpy as np
import pytest

from hevc_bench import synth


def _clip(seed, **kw):
    return synth.Clip(96, 64, seed=seed, travel=32, square=16, **kw)


def test_same_seed_same_frames():
    a, b = _clip(2 ** 31 + 5), _clip(2 ** 31 + 5)
    for t in (0, 3, 40):
        for pa, pb in zip(a.frame(t), b.frame(t)):
            assert pa.dtype == np.uint8 and np.array_equal(pa, pb)


def test_other_seed_other_frames():
    a, b = _clip(1), _clip(2)
    assert not np.array_equal(a.frame(0)[0], b.frame(0)[0])


def test_frame_shapes():
    y, u, v = _clip(1).frame(7)
    assert y.shape == (64, 96) and u.shape == v.shape == (32, 48)


def test_cuts_every_shot_frames():
    c = _clip(9, patterns=tuple(range(8)), shot_frames=32, cut_phase=10)
    cuts = [t for t in range(200) if c.is_cut(t)]
    assert cuts == [10, 42, 74, 106, 138, 170]
    # each shot shows its own pattern, the order drawn from the seed
    shots = [c.order[c.shot(t) % 8] for t in (0, 10, 42)]
    assert len(set(shots)) == 3
    assert sorted(c.order) == list(range(8))
    orders = {tuple(_clip(s, patterns=tuple(range(8))).order)
              for s in range(6)}
    assert len(orders) > 1
    # every cut changes a plain texture for an inverted one or back
    inv = [synth.PATTERNS[p][3] for p in c.order]
    assert all(inv[k] != inv[(k + 1) % 8] for k in range(8))


def test_no_cut_without_shots():
    c = _clip(3)
    assert not any(c.is_cut(t) for t in range(300))


def test_pan_never_jumps():
    assert [synth.triangle(3 * t, 256) for t in (84, 85, 86, 87)] == \
        [252, 255, 254, 251]
    steps = [abs(synth.triangle(3 * (t + 1), 256) - synth.triangle(3 * t, 256))
             for t in range(500)]
    assert max(steps) <= 3


def test_playback_back_and_forth():
    assert [synth.play(p, 5) for p in range(12)] == [0, 1, 2, 3, 4, 3, 2,
                                                     1, 0, 1, 2, 3]


def test_cuts_stay_32_apart_over_the_playback():
    from hevc_bench import harness
    c = _clip(4, patterns=tuple(range(8)), shot_frames=32, cut_phase=16)
    pb = harness.Playback(list(range(320)))
    cuts = [p for p in range(2000) if pb.is_cut(c, p)]
    assert cuts[:3] == [16, 48, 80]
    assert set(np.diff(cuts)) <= {31, 32}


@pytest.mark.parametrize("t,t_ref", [(5, 4), (4, 5), (86, 85), (90, 70)])
def test_true_motion(t, t_ref):
    # the texture of frame t lies at (x + mvx, y + mvy) of frame t_ref
    # (the square and the grain left out)
    c = synth.Clip(96, 64, seed=21, travel=256, square=16, grain=0)
    mvx, mvy = c.motion(t, t_ref)
    plain = synth.Clip(96, 64, seed=21, travel=256, square=16, grain=0,
                       square_gain=0)
    y, y_ref = plain.frame(t)[0], plain.frame(t_ref)[0]
    ys, xs = np.mgrid[0:64, 0:96]
    inside = ((0 <= ys + mvy) & (ys + mvy < 64) & (0 <= xs + mvx)
              & (xs + mvx < 96))
    assert inside.sum() > 1000
    assert np.array_equal(y[inside], y_ref[ys[inside] + mvy,
                                             xs[inside] + mvx])


def test_no_true_motion_across_a_cut():
    c = _clip(9, patterns=tuple(range(8)), shot_frames=32, cut_phase=10)
    assert c.motion(10, 9) is None and c.motion(11, 10) is not None
