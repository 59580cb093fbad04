"""Rate control (CBR, VBR) with per-CTU-row QPs, and WPP, in the torch port
against the JAX package, on the CPU (the port runs its kernels' plain
versions):

  rate_control.RateControl       vs the JAX package's, driven by one seeded
                                    sequence of (IDR, bits, scene cut, B)
                                    over 200 frames: every frame_qp,
                                    plan_rows and state field
  p_torch._level_encode(qp_rows) vs p_jax._level_encode at S 16, 32 and 64
  p_torch.p_frame_tree_device    vs p_jax.p_frame_tree_device with qp_rows,
                                    key by key (qp_ctu, qp16, levels, the
                                    deblocked reference), CTU 32 with WPP on
                                    and off and with 8x8 CUs; the row plans
                                    differ within each frame, leave leading
                                    quantisation groups uncoded, and the
                                    slice QPs take three values
  p_torch._intra_in_p            accepted CUs coded at their rows' QPs, as
                                    the JAX package codes them
  p_torch.decoded_qp_maps        vs a walk of the decoder's QP derivation
                                    (spec 8.6.1 with one quantisation group
                                    per CTB), CU by CU in z-order, at CTU 32
                                    and 64, with WPP on and off
  sessions                       every new fixture run's AUs equal the JAX
                                    package's hashes and decode in libde265
                                    to the port's reconstruction; CBR at
                                    CTU 64 on the quadtree path (where the
                                    JAX package raises) decodes in libde265
                                    to the port's reconstruction

The JAX package's decoded-QP model cannot run at CTU 64: its CU pooling
reshapes an already pooled map (p_jax.py:1192-1196) and raises TypeError;
test_reference_row_qp_model_raises_at_ctu64 records that, and the port's
model at CTU 64 is held to the decoder walk and to libde265 instead.
Inputs are made from a seed with numpy. Tolerance: exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import rate_control as jrc
from homerhevc_tpu import tables as jtables
from homerhevc_tpu.config import BitrateMode as JaxBitrate
from homerhevc_tpu.config import EncoderConfig as JaxConfig
from homerhevc_tpu.pipeline import p_jax
from homerhevc_tpu_torch import rate_control as trc
from homerhevc_tpu_torch.api import HomerEncoder
from homerhevc_tpu_torch.config import BitrateMode, EncoderConfig
from homerhevc_tpu_torch.pipeline import assemble, p_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from test_torch_ctu64 import (TREE_KEYS, check_decodes, eq, fixture,
                              hier_ints, i32, pad_refs)
from test_torch_ctu64 import make_frames as make_frames64
from test_torch_tree import VIS, make_frames
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

RC_SESSIONS = ("cbr_fast_small", "vbr_fast_small", "cbr_wpp_small",
               "wpp_fast_small", "vbr_fastest_small", "cbr_scene_small",
               "cbr_full_small", "cbr_fastest64_small")


# ---------------------------------------------------------------------------
# RateControl
RC_CASES = {
    "cbr": dict(bitrate_mode="CBR", bitrate=600, vbv_size=900, vbv_init=450,
                intra_period=30),
    "vbr": dict(bitrate_mode="VBR", bitrate=400, vbv_size=1200, vbv_init=300,
                intra_period=0),
    "cbr_b": dict(bitrate_mode="CBR", bitrate=800, vbv_size=1000,
                  vbv_init=900, intra_period=16, gop_size=2),
}


def _rc_pair(case):
    kw = RC_CASES[case]
    port = trc.RateControl(EncoderConfig(**dict(
        kw, bitrate_mode=BitrateMode[kw["bitrate_mode"]])).validate())
    ref = jrc.RateControl(JaxConfig(**dict(
        kw, bitrate_mode=JaxBitrate[kw["bitrate_mode"]])).validate())
    return port, ref


def _state(rc):
    return {k: v for k, v in vars(rc).items() if k not in ("cfg", "mode")}


@pytest.mark.parametrize("case", list(RC_CASES))
def test_rate_control_matches_jax(case):
    port, ref = _rc_pair(case)
    assert port.mode.name == ref.mode.name
    rng = np.random.default_rng(17)
    avg = ref.avg
    nrows = 23
    seen = set()
    inflight = []                      # (is_idr, is_b) issued, not ended
    for i in range(200):
        is_idr = i == 0 or (ref.intra_period > 1
                            and i % ref.intra_period == 0)
        is_b = case == "cbr_b" and not is_idr and i % 2 == 1
        if rng.random() < 0.03:
            port.on_scene_change()
            ref.on_scene_change()
        q = port.frame_qp(is_idr, is_b)
        assert q == ref.frame_qp(is_idr, is_b), i
        seen.add(q)
        inflight.append((is_idr, is_b))
        load = rng.integers(0, 400, nrows)
        bits = (None if rng.random() < 0.2
                else rng.gamma(2.0, 500.0, nrows))
        for args in ((q, nrows, None, None), (q, nrows, load, None),
                     (q, nrows, load, bits)):
            np.testing.assert_array_equal(port.plan_rows(*args),
                                          ref.plan_rows(*args))
        # bits come back in bursts, as chunks finish
        if len(inflight) >= rng.integers(1, 4):
            while inflight:
                idr, b = inflight.pop(0)
                spend = int(avg * (6 if idr else 1) * rng.uniform(0.3, 2.5))
                port.end_frame(spend, idr, b)
                ref.end_frame(spend, idr, b)
        assert _state(port) == _state(ref), i
    assert len(seen) >= 6
    assert port is not ref and type(port).__module__ != type(ref).__module__


# ---------------------------------------------------------------------------
# device stage with row QPs
# (wpp, slice QP, row plan, cu8): the plans differ within each frame and
# leave quantisation groups uncoded at row starts (the new smooth content
# of frame 1 is coded, the static parts are not); three slice QPs. The 8x8
# CU case runs on the 192x128 frames with 8x8 patches of their own motion.
TREE_CASES = {
    "wpp_off": (False, 34, (30, 45, 35), False),
    "wpp_on": (True, 34, (30, 45, 35), False),
    "wpp_on_qp28": (True, 28, (33, 26, 40), False),
    "cu8_wpp_off": (False, 30, (27, 35, 31, 33), True),
}


@functools.lru_cache(maxsize=None)
def tree_rows_both(case):
    wpp, qp, rows, cu8 = TREE_CASES[case]
    frames = make_frames64() if cu8 else make_frames()
    cur, ref = frames[1], frames[0]
    kw = dict(ctu=32, qp=qp, search=16, me_precision=2, deblock=True,
              sign_hiding=True, tr_split=True, intra_in_p=True, cu8=cu8,
              vis=(120, 184) if cu8 else VIS, wpp=wpp)
    qp_rows = np.asarray(rows, np.int32)
    want = p_jax.p_frame_tree_device(*map(jnp.asarray, cur + ref),
                                     qp_rows=jnp.asarray(qp_rows), **kw)
    got = p_torch.p_frame_tree_device(*map(torch.as_tensor, cur + ref),
                                      qp_rows=torch.as_tensor(qp_rows), **kw)
    return want, got


def test_tree_cases_cover_three_slice_qps():
    assert len({c[1] for c in TREE_CASES.values()}) >= 3
    for wpp, qp, rows, cu8 in TREE_CASES.values():
        assert len(set(rows)) == len(rows) and qp not in rows


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_p_frame_tree_device_row_qp(case):
    wpp, qp, rows, cu8 = TREE_CASES[case]
    want, got = tree_rows_both(case)
    for k in TREE_KEYS:
        eq(want[k], got[k], k)
    qp_ctu = got["qp_ctu"].numpy()
    coded = (got["cbf_u"].numpy() != 0)       # luma only: a lower bound
    # a leading quantisation group left uncoded keeps the prediction
    lead = [r for r in range(len(rows)) if qp_ctu[r, 0] != rows[r]]
    assert lead, "no uncoded leading quantisation group"
    assert coded.any()
    # the prediction differs with and without WPP where a row starts
    # uncoded below a coded row
    if not wpp:
        assert any(qp_ctu[r, 0] not in (qp, rows[r]) for r in lead)
    else:
        assert all(qp_ctu[r, 0] == qp for r in lead)
    qp16 = got["qp16"].numpy()
    assert set(np.unique(qp16)) <= set(rows) | {qp} | set(qp_ctu.ravel())
    if cu8:
        assert (got["depth_u"] == 2).any(), "no 8x8 CU chosen"
    assert not torch.equal(got["ref_y"], got["recon_y"]), "nothing filtered"


def test_intra_in_p_codes_each_row_at_its_qp():
    # the accepted intra CUs of the CTU-32 cases sit in rows of different
    # QPs; their levels equal the JAX package's (coded at the row QP, not
    # the slice QP)
    rows_hit = set()
    for case in ("wpp_off", "wpp_on_qp28"):
        want, got = tree_rows_both(case)
        acc = got["pred_intra_u"].numpy()[::8, ::8].astype(bool)
        assert acc.any(), "no intra CU accepted"
        rows = TREE_CASES[case][2]
        rows_hit |= {(case, rows[r]) for r in np.nonzero(acc)[0]}
        m = np.repeat(np.repeat(acc, 32, 0), 32, 1)
        eq(np.asarray(want["lev_y"])[m], got["lev_y"][torch.as_tensor(m)])
        eq(np.asarray(want["recon_y"])[m],
           got["recon_y"][torch.as_tensor(m)])
    assert len({q for _, q in rows_hit}) >= 2


@pytest.mark.parametrize("S,search", [(16, 16), (32, 16), (64, 64)])
def test_level_encode_row_qp(S, search):
    qp = 32
    if S == 64:
        frames = make_frames64()
        ivy, ivx, _ = hier_ints((16, 32, 64))[S]
        rows = np.asarray([26, 40], np.int32)                 # CTU 64
        vis = (120, 184)
    else:
        frames = make_frames()
        H, W = frames[0][0].shape
        ivy = torch.zeros((H // S, W // S), dtype=torch.int32)
        ivx = torch.full((H // S, W // S), -2, dtype=torch.int32)
        rows = np.asarray([28, 41, 35], np.int32)             # CTU 32
        vis = VIS
    cur, ref = frames[1], frames[0]
    lam = int(jtables.LAMBDA_ME_FX_P[qp])
    qp_c = int(jtables.chroma_qp_from_luma(qp))
    fn = jax.jit(p_jax._level_encode,
                 static_argnames=("S", "search", "me_precision",
                                  "sign_hiding", "tr_split", "vis"))
    want = fn(jnp.asarray(cur[0]).astype(jnp.int32), jnp.asarray(cur[1]),
              jnp.asarray(cur[2]), *pad_refs(ref, jnp),
              jnp.asarray(ivy.numpy()), jnp.asarray(ivx.numpy()), S=S,
              qp=jnp.int32(qp), qp_c=jnp.int32(qp_c), lam=jnp.int32(lam),
              search=search, me_precision=2, sign_hiding=True,
              tr_split=True, qp_rows=jnp.asarray(rows), vis=vis)
    got = p_torch._level_encode(
        torch.as_tensor(cur[0]).to(torch.int32), torch.as_tensor(cur[1]),
        torch.as_tensor(cur[2]), *pad_refs(ref, torch), ivy, ivx, S=S,
        qp=i32(qp), qp_c=i32(qp_c), lam=i32(lam), search=search,
        me_precision=2, sign_hiding=True, tr_split=True,
        qp_rows=torch.as_tensor(rows), vis=vis)
    # the port adds each block's refined MV before the merge decision
    assert set(got) == set(want) | {"amvp"}
    for k in want:
        eq(want[k], got[k], k)
    # the rows' QPs show in the levels: the finest row codes the most
    nz = (got["lev_y"] != 0).reshape(got["lev_y"].shape[0], -1).sum(1)
    per_row = nz.reshape(len(rows), -1).sum(1).numpy()
    assert per_row[np.argmin(rows)] > per_row[np.argmax(rows)]


def test_reference_row_qp_model_raises_at_ctu64():
    # the JAX package cannot build its decoded-QP maps at CTU 64 (k = 4
    # 16-blocks per CTB side): the port's model there is held to the
    # decoder walk below and to libde265 (test_ctu64_cbr_session_decodes)
    frames = make_frames64()
    cur, ref = frames[1], frames[0]
    with pytest.raises(TypeError, match="reshape"):
        p_jax.p_frame_tree_device(
            *map(jnp.asarray, cur + ref), ctu=64, qp=32, search=16,
            me_precision=2, deblock=True, sign_hiding=True, tr_split=True,
            qp_rows=jnp.asarray([30, 36], jnp.int32), vis=(120, 184))


# ---------------------------------------------------------------------------
# the decoder's QP derivation, CU by CU
def _cus(depth_u, y, x, size, depth, merge):
    """CUs of one CTB in z-order as (y, x, size) in 4x4 units, from the
    unit depth map; CUs smaller than `merge` units count as one CU of that
    size (the JAX package's model: merge 4, a 16x16 block)."""
    if size > 2 and depth_u[y, x] > depth:
        h = size // 2
        if h < merge:
            return [(y, x, size)]
        out = []
        for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
            out += _cus(depth_u, y + dy, x + dx, h, depth + 1, merge)
        return out
    return [(y, x, size)]


def decoder_qp_walk(qp, rows, depth_u, nz_u, ctu, wpp, block=8):
    """qp_ctu and the per-unit QP map as a decoder assigns them: qPY_PREV
    restarts at the slice QP at the slice start and, with entropy sync, at
    every CTB row; each CU takes the prediction until its quantisation
    group's first coded CU, the group's target from there on. `block` 16
    walks CUs below 16x16 as their 16x16 block, the JAX package's model."""
    uh, uw = depth_u.shape
    g = ctu // 4
    nby, nbx = uh // g, uw // g
    qp_ctu = np.zeros((nby, nbx), np.int32)
    qp_u = np.zeros((uh, uw), np.int32)
    prev = qp
    for r in range(nby):
        if wpp:
            prev = qp
        for c in range(nbx):
            pred, target = prev, int(rows[r])
            seen = False
            for y, x, s in _cus(depth_u, r * g, c * g, g, 0, block // 4):
                if nz_u[y:y + s, x:x + s].any():
                    seen = True
                qp_u[y:y + s, x:x + s] = target if seen else pred
            qp_ctu[r, c] = target if seen else pred
            prev = qp_ctu[r, c]
    return qp_ctu, qp_u


def _random_tree(rng, ctu, uh, uw):
    """A unit depth map that is a quadtree (depths 0 to log2(ctu/8)) and
    sparse coded units, some CTBs coded late in z-order or not at all."""
    def up(a, k):
        return np.repeat(np.repeat(a, k, 0), k, 1)

    depth = np.zeros((uh, uw), np.int32)
    s = ctu // 4                           # node side in units, depth 0
    split = rng.random((uh // s, uw // s)) < 0.7
    while s > 2:                           # down to 8x8 CUs (2 units)
        depth += up(split, s).astype(np.int32)
        s //= 2
        split = up(split, 2) & (rng.random((uh // s, uw // s)) < 0.55)
    nz = up(rng.random((uh // 2, uw // 2)) < 0.12, 2)
    nz[:, : ctu // 4] &= rng.random() < 0.5            # column 0 often empty
    return depth, nz


@pytest.mark.parametrize("ctu,wpp,block", [
    (32, False, 16), (32, True, 16), (32, False, 8),
    (64, False, 8), (64, True, 8), (64, False, 16)])
def test_decoded_qp_maps_match_decoder_walk(ctu, wpp, block):
    # block 16 is the JAX package's model (and the port's at CTU 32), block
    # 8 the exact one (the port's at CTU 64 with 8x8 CUs); they differ only
    # where an 8x8 CU is coded after uncoded ones of its 16x16 block
    rng = np.random.default_rng(ctu + wpp + block)
    H, W = 4 * ctu, 5 * ctu
    uh, uw = H // 4, W // 4
    qp = 33
    split_ctbs = set()
    for trial in range(6):
        depth_u, nz_u = _random_tree(rng, ctu, uh, uw)
        if trial == 0:
            nz_u[: ctu // 4] = False                     # an uncoded row
        rows = rng.integers(22, 45, H // ctu).astype(np.int32)
        want_ctu, want_u = decoder_qp_walk(qp, rows, depth_u, nz_u, ctu,
                                           wpp, block)
        got_ctu, got_u = p_torch.decoded_qp_maps(
            i32(qp), torch.as_tensor(rows), ctu=ctu,
            nz_u=torch.as_tensor(nz_u.astype(np.int32)),
            depth_u=torch.as_tensor(depth_u), wpp=wpp, block=block)
        eq(want_ctu, got_ctu, f"qp_ctu, trial {trial}")
        eq(want_u, got_u, f"qp_u, trial {trial}")
        # CTBs whose first CUs keep the prediction before the first coded
        # CU, and CTBs that stay uncoded
        g = ctu // 4
        for r in range(H // ctu):
            for c in range(W // ctu):
                blk = want_u[r * g:(r + 1) * g, c * g:(c + 1) * g]
                split_ctbs.add(len(set(blk.ravel())))
    assert split_ctbs >= {1, 2}
    assert depth_u.max() == (ctu.bit_length() - 4)        # 8x8 CUs present


def test_block_16_model_differs_only_at_8x8_cus():
    # the two models agree on every CTB without 8x8 CUs
    rng = np.random.default_rng(3)
    ctu, H, W = 32, 128, 160
    n_diff = 0
    for _ in range(8):
        depth_u, nz_u = _random_tree(rng, ctu, H // 4, W // 4)
        rows = rng.integers(22, 45, H // ctu).astype(np.int32)
        _, exact = decoder_qp_walk(30, rows, depth_u, nz_u, ctu, False, 8)
        _, model = decoder_qp_walk(30, rows, depth_u, nz_u, ctu, False, 16)
        diff = exact != model
        assert not diff[depth_u < 2].any()
        n_diff += int(diff.sum())
    assert n_diff, "no CTB where the 16x16 model is inexact"


def test_decoded_qp_maps_equal_jax_at_ctu32():
    # the walk and the JAX package's model agree where the latter runs
    for case in ("wpp_off", "wpp_on", "cu8_wpp_off"):
        wpp, qp, rows, _ = TREE_CASES[case]
        want, got = tree_rows_both(case)
        uh, uw = got["depth_u"].shape
        lev = [got[k].numpy() for k in ("lev_y", "lev_u", "lev_v")]
        nz = ((lev[0].reshape(uh, 4, uw, 4) != 0).any((1, 3))
              | (lev[1].reshape(uh, 2, uw, 2) != 0).any((1, 3))
              | (lev[2].reshape(uh, 2, uw, 2) != 0).any((1, 3)))
        walk_ctu, walk_u = decoder_qp_walk(qp, rows, got["depth_u"].numpy(),
                                           nz, 32, wpp, block=16)
        eq(want["qp_ctu"], torch.as_tensor(walk_ctu), case)
        eq(want["qp16"], torch.as_tensor(walk_u[::4, ::4]), case)


# ---------------------------------------------------------------------------
# sessions
@functools.lru_cache(maxsize=None)
def traced_run(name):
    """The port's run of one of RUNS or DECODER_RUNS: (AUs, final reference
    planes, StreamParams, trace), the trace holding each AU's slice QP and
    coded row QPs, each row plan, and the VBV fullness at each frame QP."""
    trace = dict(slices=[], plans=[], fracs=[])
    p_au, i_au = (assemble.assemble_p_au_from_maps,
                  assemble.assemble_idr_au_from_maps)

    def p_hook(params, maps, **kw):
        q = maps.get("qp_ctu")
        trace["slices"].append(("P", kw["slice_qp"],
                                None if q is None else np.unique(q).tolist()))
        return p_au(params, maps, **kw)

    def i_hook(params, maps, **kw):
        trace["slices"].append(("I", kw["slice_qp"], None))
        return i_au(params, maps, **kw)

    r = fx.run_spec(name)
    enc = HomerEncoder(fx.run_config(name), device="cpu", fetch_recon=False)
    rc = enc._rc
    if rc is not None:
        frame_qp, plan_rows = rc.frame_qp, rc.plan_rows

        def fq(is_idr, is_b=False):
            trace["fracs"].append(rc.fullness / rc.vbv_size)
            return frame_qp(is_idr, is_b)

        def pr(*a, **k):
            plan = plan_rows(*a, **k)
            trace["plans"].append(plan.tolist())
            return plan

        rc.frame_qp, rc.plan_rows = fq, pr
    assemble.assemble_p_au_from_maps = p_hook
    assemble.assemble_idr_au_from_maps = i_hook
    try:
        aus = enc.encode_frames(fx.clip(name), chunk=r["chunk"])
    finally:
        assemble.assemble_p_au_from_maps = p_au
        assemble.assemble_idr_au_from_maps = i_au
    ref = tuple(p.numpy() for p in enc._ref)
    enc.close()
    return aus, ref, enc.params, trace


def check_rate_control(name, params, trace):
    """The run drives what it is meant to: WPP and cu_qp_delta as the
    configuration says; with rate control, three slice QPs or more, the VBV
    guardrails, and on the quadtree path row QPs that differ within a
    frame."""
    cfg = fx.run_config(name)
    row_qp = (cfg.bitrate_mode != BitrateMode.FIXED_QP
              and cfg.performance_mode.name in ("FAST_COMPUTATION",
                                                "FULL_COMPUTATION"))
    assert params.wpp_enabled == cfg.wpp
    assert params.cu_qp_delta_enabled == row_qp
    if cfg.bitrate_mode == BitrateMode.FIXED_QP:
        assert {s[1] for s in trace["slices"]} == {cfg.qp}
        return
    assert len({s[1] for s in trace["slices"]}) >= 3
    lo, hi = ((0.3, 0.7) if cfg.bitrate_mode == BitrateMode.CBR
              else (0.1, 0.9))
    assert any(f < lo or f > hi for f in trace["fracs"]), "no guardrail"
    coded_rows = [s[2] for s in trace["slices"] if s[2] is not None]
    assert bool(coded_rows) == row_qp
    if row_qp:
        assert any(len(q) > 1 for q in coded_rows), "row QPs all equal"


# FULL under rate control at CTU 32: the JAX package gives an 8x8 CU its
# 16x16 block's decoded QP, so its stream (these very bytes) deblocks
# differently in a decoder and drifts from its own reconstruction (ROADMAP,
# faults of the reference); the port keeps the bytes equal there
REFERENCE_DRIFTS = ("cbr_full_small",)


def check_drifts(name, aus, ref):
    from homerhevc_tpu_torch.validate import de265
    if not de265.available():
        return
    r = fx.run_spec(name)
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == len(aus)
    assert not np.array_equal(dec[-1][0], ref[0][:r["height"], :r["width"]])


@pytest.mark.parametrize("name", RC_SESSIONS)
def test_rc_session_matches_fixture(name):
    entry = fixture()[name]
    assert {k: entry[k] for k in fx.RUNS[name]} == fx.RUNS[name]
    aus, ref, params, trace = traced_run(name)
    assert fx.au_digest(aus) == entry["aus"]
    if name in REFERENCE_DRIFTS:
        check_drifts(name, aus, ref)
    else:
        check_decodes(name, aus, ref)
    check_rate_control(name, params, trace)
    if name == "cbr_scene_small":
        assert sum(s[0] == "I" for s in trace["slices"]) >= 2, "no scene cut"


@pytest.mark.parametrize("name", list(fx.DECODER_RUNS))
def test_ctu64_cbr_session_decodes(name):
    # the quadtree path at CTU 64 under rate control: the JAX package
    # raises there, so libde265 holds the port's decoded-QP model (a wrong
    # QP deblocks differently and the references drift apart), 8x8 CUs
    # (FULL) included
    from homerhevc_tpu_torch.validate import de265
    aus, ref, params, trace = traced_run(name)
    assert fx.run_config(name).cu_size == 64
    check_rate_control(name, params, trace)
    if not de265.available():
        pytest.skip("libde265 does not load")
    check_decodes(name, aus, ref)


def test_rc_fixture_entries_pinned():
    # the rate-control runs as the JAX package wrote them; a later change
    # that moves one must say so here
    import hashlib
    import json
    want = {
        "cbr_fast_small": "2d97eb4af13d67186d454c5097cbe4ef16f15cdfdf4125c"
                          "d76106b39f888d308",
        "vbr_fast_small": "631afe050e88607349d9f063632a9cd40b0dbb31cb1963e"
                          "0c1f891f965e26210",
        "cbr_wpp_small": "57442934d47a6d04f4c92937389b5a1f8fb1b4d6fb6b1ae5"
                         "dedf20b24e68b974",
        "wpp_fast_small": "a8d97bf343e6e532524e066e8650764bc91fad0cf5dcf78"
                          "7c5ecf6ac169a79f5",
        "vbr_fastest_small": "5fe2693eb654d29151894ad76ff4d1567d7d5e64b2bc"
                             "b394e8e4f4132e71f34b",
        "cbr_scene_small": "0dd48a89297a4cd3b27c8cc2366245e72c233addc12544"
                           "a29b4ecda3f77c2d8c",
        "cbr_full_small": "1bb54e231521969341cb5a84c066456584146ac0c29e87d"
                          "1f26b8f1c5c423469",
        "cbr_fastest64_small": "c96259c7950d532cfba5b462d5bc65db649b80b00"
                               "9c3ba62abdaece31e78d769",
        "cbr_wpp_720p": "1c88a967ecc3f08d6f94055d46af618c82bf2d1a4cd541edc"
                        "e5fcab98e29e39f",
        "vbr_fastest_720p": "f979c5e7daec88dfe592b81c30859575ee995a3bd5f8a"
                            "c20efabf2fc4a8cf37d",
    }
    got = fixture()
    for name, digest in want.items():
        aus = got[name]["aus"]
        assert len(aus) == fx.RUNS[name]["frames"]
        assert hashlib.sha256(json.dumps(aus, sort_keys=True)
                              .encode()).hexdigest() == digest, name
    # both 720p paths start from the same clip at QP 32; rate control moves
    # the IDR to QP 30, so neither shares the fixed-QP runs' first AU
    assert got["cbr_wpp_720p"]["aus"][0] != got["fast_720p"]["aus"][0]
    assert got["vbr_fastest_720p"]["aus"][0] != got["720p"]["aus"][0]
