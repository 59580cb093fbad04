"""The reference decoder against the port on the CPU, at small sizes:
every configuration's path decodes to the session's own reference planes,
sample for sample."""

import numpy as np
import pytest

from hevc_bench import check, synth
from hevc_bench.reference.decoder import Decoder

CASES = {
    # name: (encoder keywords, width, height, seeded, chunk, cuts)
    "fastest": (dict(cu_size=32, performance_mode=3), 192, 128, False, None,
                False),
    "fastest_chunks_cuts": (dict(cu_size=32, performance_mode=3), 192, 128,
                            False, 2, True),
    "fastest64_search64_chunks": (dict(cu_size=64, performance_mode=3,
                                       me_search_range=64), 192, 128, False,
                                  2, False),
    "quadtree_vbr_wpp": (dict(cu_size=64, performance_mode=1, rd_mode=2,
                              bitrate_mode=2, bitrate=300, wpp=True), 256,
                         192, True, 2, False),
}


def encode(kw, W, H, seeded, chunk, cuts, n=6):
    from homerhevc_tpu_torch.api import HomerEncoder
    from hevc_bench.harness import encoder_config
    cfg = encoder_config(dict(encoder=dict(kw, width=W, height=H, qp=32,
                                           intra_period=0)), {})
    enc = HomerEncoder(cfg, device="cpu", fetch_recon=False)
    clip = synth.Clip(W, H, seed=11, travel=64, square=32,
                      patterns=(0, 1, 2, 3), shot_frames=3 if cuts else 0,
                      cut_phase=2)
    frames = clip.frames(0, n + 1)
    start = None
    aus = []
    if seeded:
        start = synth.padded(frames[0], cfg.padded_height, cfg.padded_width)
        enc.seed_reference(start, poc=1)
    else:
        aus.append(enc.encode_frame(*frames[0]))
    if chunk:
        aus += enc.encode_frames(frames[1:], chunk=chunk)
    else:
        aus += [enc.encode_frame(*f) for f in frames[1:]]
    end = tuple(p.numpy().copy() for p in enc._ref)
    return cfg, frames, start, aus, end


@pytest.mark.parametrize("case", sorted(CASES))
def test_decodes_to_the_sessions_reference(case):
    kw, W, H, seeded, chunk, cuts = CASES[case]
    cfg, frames, start, aus, end = encode(kw, W, H, seeded, chunk, cuts)
    enc = dict(kw, width=W, height=H, qp=32)
    params = check.expected_params(enc)
    dec = Decoder(params=params if seeded else None, ref=start)
    for au, src in zip(aus, frames[0 if not seeded else 1:]):
        pic = dec.decode_au(au)
        assert check.header_mismatches(dec, dict(enc, bitrate_mode=kw.get(
            "bitrate_mode", 0)), params) == []
        assert check.luma_mse(pic, src, W, H) < 200
    if not seeded:
        assert check.param_mismatches(dec.params, params) == []
    for a, b in zip(pic, end):
        assert a.shape == b.shape and np.array_equal(a, b)
    if cuts:
        assert [check.is_idr(a) for a in aus] == [
            True, False, True, False, False, True, False]


def test_a_flipped_byte_is_caught():
    kw, W, H, seeded, chunk, cuts = CASES["fastest"]
    cfg, frames, start, aus, end = encode(kw, W, H, seeded, chunk, cuts, n=2)
    bad = bytearray(aus[2])
    bad[len(bad) // 2] ^= 0x10
    dec = Decoder()
    dec.decode_au(aus[0])
    dec.decode_au(aus[1])
    try:
        pic = dec.decode_au(bytes(bad))
    except (ValueError, IndexError):
        return
    assert any(not np.array_equal(a, b) for a, b in zip(pic, end))
