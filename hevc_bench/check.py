"""The check that decides a run's `correct`: the reference decoder
(hevc_bench/reference) against what the timed path produced.

After the window, from a run of `check_frames` frames drawn from the seed
(one segment, or a run of single-frame calls), the check takes the AUs
the window returned, the source frames, and the session's reference
planes at the run's first and last call boundaries. The decoder starts
from the first planes, decodes every AU, and its last picture has to
equal the last planes sample for sample. The parameter sets and slice
headers are held against what the configuration states. Every frame
offered in the window has to have its AU, every cut in the window has to
start an IDR, and no other frame may be one (the configurations state
`intra_period` 0). These numbers are exact, with the limit 0.

The P stage's decisions (integer and quarter-pel motion search, merge
and skip, intra in P, the residual's coding) are held by three numbers of
the sampled P frames, each worked out by the reference from the stream
and the source frames alone:

- `p_pred_excess`: over the inter CUs, by how much the decoded motion-
  compensated prediction (before the residual) misses the source more
  than the prediction along the content's true motion does (the pan that
  `synth.Clip.motion` knows), summed where it misses more, per luma
  sample;
- `p_pred_mae`: the mean absolute difference, over the visible luma
  samples of every inter CU, between the source and that prediction;
- `p_bits_per_pixel`: the P AUs' bits over their visible luma samples.

A search that finds worse vectors raises all three. Their limits are the
configuration file's `limits`, set between the largest reading of sound
runs and the smallest of a decision fault, the integer search handing
back the zero vector (control.py; PERF.md).

The worst luma MSE against the source is printed beside them and not
compared: at this content and QP it is set by the quantiser, and neither
the control nor the fault moves it by three times (PERF.md).

The control (`control=True`) puts the reference's own pictures, at 7-bit
precision (the configuration states 8-bit samples), in the place of the
program's reference planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reference import predict
from .reference.bitstream import (NAL_IDR_N_LP, NAL_IDR_W_RADL, NAL_PPS,
                                  NAL_SPS, split_nals)
from .reference.decoder import SLICE_P, Decoder, DecodeError
from .reference.headers import Params, parse_pps, parse_sps

FASTEST, FAST = 3, 1
FIXED_QP = 0


def expected_params(enc: dict) -> Params:
    """The parameter sets that an encoder configuration states: sizes,
    tools and guarantees, in HomerHEVC's terms (FASTEST codes fixed CUs of
    min(CTU, 32); the other modes a CU quadtree down to 8x8; the inter
    residual quadtree in FAST and FULL; row QPs with rate control on the
    quadtree)."""
    ctu = enc["cu_size"]
    w = -(-enc["width"] // ctu) * ctu
    h = -(-enc["height"] // ctu) * ctu
    mode = enc.get("performance_mode", FAST)
    ctb_log2 = ctu.bit_length() - 1
    split = mode != FASTEST
    rc = enc.get("bitrate_mode", FIXED_QP) != FIXED_QP
    return Params(
        width=w, height=h, ctb_log2=ctb_log2,
        min_cb_log2=3 if split else min(ctu, 32).bit_length() - 1,
        max_tb_log2=min(5, ctb_log2),
        max_tr_depth_intra=int(split and enc.get("max_intra_tr_depth", 1)
                               >= 1),
        max_tr_depth_inter=int(mode <= FAST
                               and enc.get("max_inter_tr_depth", 1) >= 1),
        sao=enc.get("sample_adaptive_offset", True),
        sign_hiding=enc.get("sign_hiding", True),
        init_qp=enc.get("qp", 32),
        cu_qp_delta=rc and mode <= FAST,
        cb_qp_offset=enc.get("chroma_qp_offset", 0),
        cr_qp_offset=enc.get("chroma_qp_offset", 0),
        wpp=enc.get("wpp", False), deblocking=enc.get("deblocking", True))


STATED = ("width", "height", "ctb_log2", "min_cb_log2", "max_tb_log2",
          "max_tr_depth_intra", "max_tr_depth_inter", "amp", "sao",
          "temporal_mvp", "sign_hiding", "init_qp", "cu_qp_delta",
          "cb_qp_offset", "cr_qp_offset", "wpp", "deblocking")


def param_mismatches(got: Params, want: Params) -> list:
    return [k for k in STATED if getattr(got, k) != getattr(want, k)]


def header_mismatches(dec: Decoder, enc: dict, want: Params) -> list:
    """Fields of the last slice header that differ from the
    configuration: the QP at a fixed QP, SAO on both planes, deblocking."""
    sh = dec.header
    out = []
    if enc.get("bitrate_mode", FIXED_QP) == FIXED_QP and sh.qp != want.init_qp:
        out.append("slice_qp")
    if want.sao and not (sh.sao_luma and sh.sao_chroma):
        out.append("slice_sao")
    if sh.deblocking != want.deblocking:
        out.append("slice_deblocking")
    return out


def is_idr(au: bytes) -> bool:
    """The AU holds an IDR slice (NAL headers read after each start
    code)."""
    i = au.find(b"\x00\x00\x01")
    while 0 <= i < len(au) - 3:
        if (au[i + 3] >> 1) & 0x3F in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
            return True
        i = au.find(b"\x00\x00\x01", i + 3)
    return False


def luma_mse(pic, src, width: int, height: int) -> float:
    d = pic[0][:height, :width].astype(np.int64) - src[0].astype(np.int64)
    return float((d * d).mean())


class Decisions:
    """Sums over the P pictures of a decoded run that the decision numbers
    are read from."""

    def __init__(self):
        self.excess = 0
        self.abs_err = 0
        self.inter_samples = 0
        self.bits = 0
        self.samples = 0

    def add(self, dec: Decoder, au: bytes, src, width: int, height: int,
            true_mv):
        """Add a decoded picture: its AU, its source frame and the true
        motion of the source's texture from the previous frame's (None
        where there is none)."""
        if dec.header.slice_type != SLICE_P:
            return
        pic = dec.picture
        self.bits += 8 * len(au)
        self.samples += width * height
        if not pic.inter_cus:
            return
        H, W = pic.inter_pred.shape
        srcp = np.zeros((H, W), dtype=np.int64)
        srcp[:height, :width] = src[0]
        seen = np.zeros((H, W), dtype=bool)
        seen[:height, :width] = True
        cus = np.array(pic.inter_cus, dtype=np.int64)
        for s in np.unique(cus[:, 2]):
            g = cus[cus[:, 2] == s]
            n = int(s)
            ar = np.arange(n)
            rows = g[:, 1, None, None] + ar[None, :, None]
            cols = g[:, 0, None, None] + ar[None, None, :]
            vis = seen[rows, cols]
            sad = (np.abs(pic.inter_pred[rows, cols] - srcp[rows, cols])
                   * vis).sum(axis=(1, 2))
            self.abs_err += int(sad.sum())
            self.inter_samples += int(vis.sum())
            if true_mv is None:
                continue
            true = predict.motion_compensate(
                pic.ref[0], g[:, 0], g[:, 1], n,
                np.full(len(g), 4 * true_mv[0]),
                np.full(len(g), 4 * true_mv[1]), chroma=False)
            sad_true = (np.abs(true.astype(np.int64) - srcp[rows, cols])
                        * vis).sum(axis=(1, 2))
            self.excess += int(np.maximum(sad - sad_true, 0).sum())

    def numbers(self) -> dict:
        """{name: value}; an empty dict where the run held no P picture."""
        if not self.samples:
            return {}
        if not self.inter_samples:      # no inter CU: the largest error
            return dict(p_pred_excess=255.0, p_pred_mae=255.0,
                        p_bits_per_pixel=self.bits / self.samples)
        return dict(p_pred_excess=self.excess / self.inter_samples,
                    p_pred_mae=self.abs_err / self.inter_samples,
                    p_bits_per_pixel=self.bits / self.samples)


def decode_run(params: Params, start_planes, aus, sources, enc: dict,
               setup_aus=(), motions=None):
    """Decode `aus` from `start_planes`; returns (AUs that failed, worst
    luma MSE, stream mismatches, last picture, Decisions). Parameter sets
    in `setup_aus` or in the AUs replace `params` and are held to them.
    `motions`: the true motion of each source frame's texture from the
    frame before (None for each where unknown)."""
    motions = motions or [None] * len(aus)
    dec = Decoder(params=params, ref=tuple(start_planes))
    mism = []
    for au in setup_aus:
        for sps, pps in _parameter_sets(au):
            dec.sps, dec.pps = sps, pps
            dec.params = Params(**sps, **pps)
            mism += param_mismatches(dec.params, params)
    worst, pic = 0.0, None
    decisions = Decisions()
    for done, (au, src, mv) in enumerate(zip(aus, sources, motions)):
        try:
            pic = dec.decode_au(au)
        except (DecodeError, NotImplementedError, ValueError,
                IndexError) as e:
            mism.append(f"decode: {type(e).__name__}: {e}")
            return len(aus) - done, worst, mism, None, decisions
        if NAL_SPS in dec.nal_types:
            mism += param_mismatches(dec.params, params)
        mism += header_mismatches(dec, enc, params)
        worst = max(worst, luma_mse(pic, src, enc["width"], enc["height"]))
        decisions.add(dec, au, src, enc["width"], enc["height"], mv)
    return 0, worst, mism, pic, decisions


def _parameter_sets(au: bytes):
    """(SPS, PPS) pairs of an AU, parsed."""
    sps = None
    for nal in split_nals(au):
        if nal.type == NAL_SPS:
            sps = parse_sps(nal.rbsp)
        elif nal.type == NAL_PPS and sps is not None:
            yield sps, parse_pps(nal.rbsp)


def verify(run, start: int, control: bool = False):
    """({name: {value, limit}}, failed frames) of a finished run; with
    `control`, of the control in the program's place. The decision
    numbers' limits are the configuration's `limits`."""
    enc = dataclasses.asdict(run.cfg)
    limits = run.conf.get("limits", {})
    unit = run.traffic["check_frames"]
    run.check_notes = []
    aus = {}
    offered = 0
    for call in run.calls:
        offered += call.n
        for i, au in enumerate(call.aus[:call.n]):
            aus[call.pos + i] = au
    missing = offered - sum(1 for a in aus.values() if a)
    frames = list(range(start, start + unit))
    sample = [aus.get(t) for t in frames]
    failed = missing
    checks = dict(frames_missing=dict(value=missing, limit=0))
    params = expected_params(enc)
    if any(a is None for a in sample):
        checks["aus_undecodable"] = dict(value=unit, limit=0)
        return checks, failed + unit
    bad, worst, mism, pic, decisions = decode_run(
        params, run.snaps[start], sample, [run.frames[t] for t in frames],
        enc, run.setup_aus[:1], [run.frames.motion(run.clip, t)
                                 for t in frames])
    failed += bad
    checks["aus_undecodable"] = dict(value=bad, limit=0)
    checks["stream_mismatches"] = dict(value=len(mism), limit=0)
    end = run.snaps[start + unit]
    if control and pic is not None:
        end = tuple(p & 0xFE for p in pic)
    if pic is None:
        diff = sum(int(p.size) for p in end)
    else:
        diff = sum(int(np.count_nonzero(a != b)) for a, b in zip(pic, end))
    checks["recon_mismatch"] = dict(value=diff, limit=0)
    if pic is not None:
        for name, value in decisions.numbers().items():
            checks[name] = dict(value=value, limit=limits[name])
    run.check_printed = dict(luma_mse_max=worst)
    # intra_period 0: an IDR starts the clip and every hard cut, no other
    # frame
    cut = {t: run.frames.is_cut(run.clip, t) for t in aus}
    idr = {t: bool(a) and is_idr(a) for t, a in aus.items()}
    checks["idr_unexpected"] = dict(
        value=sum(1 for t in aus if idr[t] and not cut[t]), limit=0)
    if run.clip.shot_frames:
        checks["idr_missing"] = dict(
            value=sum(1 for t in aus if cut[t] and not idr[t]), limit=0)
    run.check_notes = mism[:5]
    return checks, failed
