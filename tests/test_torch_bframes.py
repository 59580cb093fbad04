"""B frames (gop_size 2, the reference's default IBP GOP) in the torch port
against the JAX package, on the CPU (the port runs its kernels' plain
versions):

  b_torch.b_frame_device   vs b_jax.b_frame_device key by key (idc, mv0,
                           mv1, levels, recon) at 96x64, search 8 (the
                           dense search) and 128x96, search 32 (the
                           hierarchical one), with and without sign hiding,
                           and at 120x88 (padded: `vis`); the wire unpacks
                           to the same arrays
  b_golden.build_b_plans   the port's copy vs the original on those arrays
  sessions                 IBP through push_frame / flush (intra_period 0
                           and 4, odd and even lengths, VBR, CBR on the
                           quadtree path, FAST with search 64, WPP, padded),
                           and encode_frames with gop_size 2, against the
                           JAX package's AU hashes; libde265 decodes each
                           IBP stream to one picture per frame, every anchor
                           to the port's reconstruction
  fault 6                  a scene cut with a pending B: the explicit P
                           before the IDR carries POC -1, as the JAX package
                           writes it (held to its hash only)
  encode_frames, gop 2     IPPP chunks under the two-reference SPS, whose
                           RPS names the picture two back: the JAX package's
                           bytes, which drift in libde265
  check_slice              refuses gop_size 2 at cu_size 64

Inputs are made from a seed with numpy. Tolerance: exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu.pipeline import b_golden as jb_golden
from homerhevc_tpu.pipeline import b_jax
from homerhevc_tpu_torch.api import HomerEncoder, check_slice
from homerhevc_tpu_torch.entropy import headers
from homerhevc_tpu_torch.pipeline import b_golden, b_torch
from homerhevc_tpu_torch.utils import fixtures as fx
from homerhevc_tpu_torch.utils.synth import synth_clip
from test_torch_ctu64 import fixture
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)

B_KEYS = ("idc", "mv0", "mv1", "lev_y", "lev_u", "lev_v", "rec_y", "rec_u",
          "rec_v")
# (width, height, search, sign_hiding)
B_CASES = {
    "dense": (96, 64, 8, True),
    "dense_no_sbh": (96, 64, 8, False),
    "hier": (128, 96, 32, True),
    "hier_no_sbh": (128, 96, 32, False),
    "padded": (120, 88, 8, True),
}
IBP_SESSIONS = ("ibp_small", "ibp_ip4_small", "ibp_odd_small",
                "ibp_vbr_small", "ibp_cbr_fast_small", "ibp_fast_small",
                "ibp_wpp_small", "ibp_padded_small")



def _padded(frame, ph, pw):
    return tuple(np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])),
                        mode="edge")
                 for p, (h, w) in zip(frame, ((ph, pw), (ph // 2, pw // 2),
                                              (ph // 2, pw // 2))))


@functools.lru_cache(maxsize=None)
def b_both(case):
    """(JAX outputs as numpy, port outputs) of one B frame: frame 1 of a
    seeded clip between frames 0 and 2."""
    W, H, search, sh = B_CASES[case]
    ph, pw = -(-H // 32) * 32, -(-W // 32) * 32
    f0, f1, f2 = (_padded(f, ph, pw) for f in synth_clip(W, H, 3, seed=1))
    kw = dict(B=32, qp=32, search=search, me_precision=2, sign_hiding=sh,
              vis=(H, W))
    want = b_jax.b_frame_device(*(jnp.asarray(p) for p in f1 + f0 + f2),
                                **kw)
    got = b_torch.b_frame_device(*(torch.from_numpy(p) for p in f1 + f0 + f2),
                                 **kw)
    return {k: np.asarray(want[k]) for k in B_KEYS}, got


@pytest.mark.parametrize("case", list(B_CASES))
def test_b_frame_device_matches_jax(case):
    want, got = b_both(case)
    for k in B_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    W, H = B_CASES[case][:2]
    wire = b_torch.unpack_b_wire(got["wire"].numpy(), -(-H // 32) * 32,
                                 -(-W // 32) * 32, 32)
    for k, v in wire.items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"wire {k}")
    # the frame exercises every prediction direction
    if case.startswith("hier"):
        assert set(np.unique(want["idc"])) == {0, 1, 2}


@pytest.mark.parametrize("case", ["dense", "padded"])
def test_build_b_plans_copy_matches_original(case):
    want, _ = b_both(case)
    args = [want[k] for k in ("idc", "mv0", "mv1", "lev_y", "lev_u",
                              "lev_v")]
    kw = dict(size=32, poc=3, poc_refs=(2, 4))
    a = jb_golden.build_b_plans(*args, (None, None, None), **kw)
    b = b_golden.build_b_plans(*args, (None, None, None), **kw)
    assert len(a.ctu_plans) == len(b.ctu_plans) > 1
    for pa, pb in zip(a.ctu_plans, b.ctu_plans):
        for k in ("x0", "y0", "coeff_y", "coeff_cb", "coeff_cr", "skip",
                  "merge_flag", "merge_idx", "mvd", "mvp_idx", "inter_dir",
                  "mvd_l1", "mvp_idx_l1"):
            np.testing.assert_array_equal(getattr(pb, k), getattr(pa, k),
                                          err_msg=k)
    np.testing.assert_array_equal(b.cbf_y_unit, a.cbf_y_unit)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def push_run(name):
    """(AUs, {display index: cropped decoded planes} of every anchor, the
    session's StreamParams) of the port for one of the fixture's runs."""
    enc = HomerEncoder(fx.run_config(name), device="cpu")
    aus, recons = [], {}
    for d, f in enumerate(fx.clip(name)):
        out = enc.push_frame(*f)
        aus += out
        if d % 2 == 0:
            recons[d] = enc.last_recon
    aus += enc.flush()
    enc.close()
    return aus, recons, enc.params


def check_fixture(name, aus):
    entry = fixture()[name]
    assert {k: entry[k] for k in fx.RUNS[name]} == fx.RUNS[name]
    assert fx.au_digest(aus) == entry["aus"]


def nal_types(aus):
    return [a[4] >> 1 & 0x3F for a in aus]


def slice_types(aus):
    """slice_type of every non-IRAP AU (one slice, after the start code and
    the NAL header), None for the IRAP ones."""
    out = []
    for a, t in zip(aus, nal_types(aus)):
        if t != 1:
            out.append(None)
            continue
        read, read_ue = _bits(a[6:])
        read(1)
        read_ue()
        out.append(read_ue())
    return out


@pytest.mark.parametrize("name", IBP_SESSIONS)
def test_ibp_session_matches_fixture_and_decodes(name):
    from homerhevc_tpu_torch.validate import de265
    aus, recons, params = push_run(name)
    check_fixture(name, aus)
    n = fx.RUNS[name]["frames"]
    assert len(aus) == n
    assert params.num_ref_frames == 2 and params.num_reorder_pics == 1
    assert headers.SLICE_B in slice_types(aus)
    if not de265.available():
        return
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == n
    for d, rec in recons.items():
        for p, q in zip(dec[d], rec):
            np.testing.assert_array_equal(p, q, err_msg=f"anchor {d}")


def test_ibp_intra_period_codes_explicit_p_before_each_idr():
    aus, _, _ = push_run("ibp_ip4_small")
    # decode order: I0 P2 B1 P3 I4 P5 (an explicit P where the B would
    # reference across an IDR, and the trailing one at flush)
    assert nal_types(aus) == [32, 1, 1, 1, 32, 1]
    assert slice_types(aus) == [None, headers.SLICE_P, headers.SLICE_B,
                                headers.SLICE_P, None, headers.SLICE_P]


def test_ibp_even_length_flushes_trailing_p():
    aus, _, _ = push_run("ibp_small")
    odd, _, _ = push_run("ibp_odd_small")
    assert len(aus) == 8 and len(odd) == 5
    assert slice_types(aus)[-2:] == [headers.SLICE_B, headers.SLICE_P]
    assert slice_types(odd)[-1] == headers.SLICE_B
    enc = HomerEncoder(fx.run_config("ibp_odd_small"), device="cpu")
    assert enc.flush() == []


def _bits(data):
    """A bit reader over bytes: (read(n), read_ue())."""
    pos = [0]

    def read(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | (data[pos[0] // 8] >> (7 - pos[0] % 8) & 1)
            pos[0] += 1
        return v

    def read_ue():
        z = 0
        while read(1) == 0:
            z += 1
        return (1 << z) - 1 + read(z)

    return read, read_ue


def test_scene_cut_with_pending_b_writes_poc_minus_one():
    # fault 6 of the reference: the scene-cut IDR moves last_idr before the
    # pending frame is coded as an explicit P, so its POC is -1; the port
    # writes the same bytes (libde265 outputs that picture as junk, so the
    # stream is held to its hash alone)
    name = "ibp_scene_small"
    aus, _, params = push_run(name)
    check_fixture(name, aus)
    types = nal_types(aus)
    k = fx.RUNS[name]["cut"]
    # I0 P2 B1 | P(3, POC -1) IDR4 | trailing P5
    assert types[:3] == [32, 1, 1] and types[4] == 32
    read, read_ue = _bits(aus[3][6:])
    assert read(1) == 1                                 # first slice
    assert read_ue() == 0                               # PPS id
    assert read_ue() == headers.SLICE_P
    lsb = read(headers.LOG2_MAX_POC_LSB)
    assert lsb == (k - 1 - k) % (1 << headers.LOG2_MAX_POC_LSB)
    assert read(1) == 1 and read(2) == 2                # rps 2: one back
    assert len(aus) == fx.RUNS[name]["frames"]
    from homerhevc_tpu_torch.validate import de265
    if de265.available():
        # one picture per frame, the POC -1 one among them
        assert len(de265.decode_annexb(b"".join(aus))) == len(aus)


def test_encode_frames_gop2_matches_fixture_and_drifts():
    # the JAX package's encode_frames never looks at gop_size: IPPP chunks
    # under the two-reference SPS, each P slice naming rps 0 (the picture
    # two back) while the encoder predicted from the one before; the port
    # writes the same bytes, which a decoder reconstructs differently
    from homerhevc_tpu_torch.validate import de265
    name = "ibp_frames_small"
    enc = HomerEncoder(fx.run_config(name), device="cpu", fetch_recon=False)
    aus = enc.encode_frames(fx.clip(name), chunk=fx.RUNS[name]["chunk"])
    ref = tuple(p.numpy() for p in enc._ref)
    check_fixture(name, aus)
    assert nal_types(aus) == [32] + [1] * (len(aus) - 1)
    assert set(slice_types(aus)[1:]) == {headers.SLICE_P}
    if not de265.available():
        return
    dec = de265.decode_annexb(b"".join(aus))
    assert len(dec) == len(aus)
    assert not np.array_equal(dec[-1][0], ref[0][:96, :128])


def test_check_slice_refuses_b_frames_at_ctu64():
    kw = fx.ctu64_kwargs(128, 128, gop_size=2)
    with pytest.raises(NotImplementedError, match="gop_size=2 at cu_size=64"):
        check_slice(fx.config_from(kw).validate())
    with pytest.raises(NotImplementedError, match="gop_size=2"):
        HomerEncoder(fx.config_from(kw), device="cpu")
    check_slice(fx.config_from(fx.slice_kwargs(128, 128,
                                               gop_size=2)).validate())
