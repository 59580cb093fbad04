"""ctypes wrapper for the native C++ CABAC slice encoder (entropy/native/).

Port of homerhevc_tpu/entropy/native_backend.py. libhenc.so is this
package's own library: layout.h is generated from the Python tables (so the
two backends share one source of truth) and henc_native.cc is compiled with
g++ at first use, both into entropy/native/_build/ (listed in .gitignore),
named by a hash of the sources so an edited source is rebuilt. A failed
build raises: there is no numpy fallback on the encode path. The Python
CABAC classes (entropy/syntax.py, entropy/cabac.py) stay as the oracle the
tests hold libhenc against: encode_slice_from_maps gives the same bytes as
assemble.encode_slice_data(native=False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = os.path.join(_DIR, "_build")
_SRC = os.path.join(_DIR, "henc_native.cc")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


class _SliceParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "pic_width", "pic_height", "ctu_log2", "min_cu_log2",
        "max_tr_depth_intra", "max_tr_depth_inter", "sign_hiding",
        "slice_type", "max_merge_cand", "wpp", "sao_luma", "sao_chroma",
        "cu_qp_delta_enabled", "slice_qp")]


def pack_sao(sao_info: dict, nby: int, nbx: int) -> np.ndarray:
    """Pack per-CTU SAO params into the (nby, nbx, 21) int8 layout the C++
    walker reads (see SAO_REC in henc_native.cc)."""
    rec = np.zeros((nby, nbx, 21), np.int8)
    rec[..., 0] = sao_info["merge_left"]
    rec[..., 1] = sao_info["merge_up"]
    lu, cb, cr = sao_info["luma"], sao_info["cb"], sao_info["cr"]
    rec[..., 2] = lu["type"]
    rec[..., 3] = lu["eo_class"]
    rec[..., 4] = lu["band_pos"]
    rec[..., 5:9] = lu["offsets"]
    rec[..., 9] = cb["type"]
    rec[..., 10] = cb["eo_class"]
    rec[..., 11] = cb["band_pos"]
    rec[..., 12:16] = cb["offsets"]
    rec[..., 16] = cr["band_pos"]
    rec[..., 17:21] = cr["offsets"]
    return rec


def build_library() -> str:
    """Generate layout.h and compile libhenc (if not already built) into
    BUILD_DIR; returns the library's path. Raises when g++ fails."""
    from .native import gen_layout
    layout = gen_layout.render()
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + layout.encode()
                             + repr(GXX_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libhenc-{key}.so")
    if os.path.exists(so):
        return so
    inc = os.path.join(BUILD_DIR, f"layout-{key}")
    os.makedirs(inc, exist_ok=True)
    tmp_h = os.path.join(inc, f"layout.h.{os.getpid()}.tmp")
    with open(tmp_h, "w") as f:
        f.write(layout)
    os.replace(tmp_h, os.path.join(inc, "layout.h"))
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *GXX_FLAGS, "-I", inc, _SRC, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for henc_native.cc:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    """The library handle, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.henc_encode_slice.restype = ctypes.c_int
        _lib = lib
    return _lib


BIT_CATS = ("sao", "split_cu", "skip", "merge", "pred_part", "mvd", "mvp",
            "intra_mode", "tt_cbf", "last_xy", "sig", "level", "dqp", "term")


class bit_probe:
    """Context manager: accumulate exact fractional CABAC bits per syntax
    category across native encode calls. `.asdict()` -> {category: bits}."""

    def __init__(self):
        self.arr = np.zeros(len(BIT_CATS), np.float64)

    def __enter__(self):
        _load().henc_set_bit_probe(self.arr.ctypes.data_as(ctypes.c_void_p))
        return self

    def __exit__(self, *exc):
        _lib.henc_set_bit_probe(ctypes.c_void_p(None))

    def asdict(self):
        return {k: float(v) for k, v in zip(BIT_CATS, self.arr)}


def scatter_levels_native(idx: np.ndarray, vals16: np.ndarray, cnt: int,
                          H: int, W: int):
    """C++ twin of p_chunk.scatter_levels that additionally returns the
    per-4x4-unit any-nonzero map (saves the host-side dense-plane nz
    reduction). Returns (lev_y, lev_u, lev_v, nz_u)."""
    lib = _load()
    lev_y = np.empty((H, W), np.int32)
    lev_u = np.empty((H // 2, W // 2), np.int32)
    lev_v = np.empty((H // 2, W // 2), np.int32)
    nz = np.empty((H // 4, W // 4), np.uint8)
    idx = _i32(idx)
    vals16 = np.ascontiguousarray(vals16, dtype=np.int16)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.henc_scatter_levels(p(idx), p(vals16), ctypes.c_int(int(cnt)),
                            ctypes.c_int(H), ctypes.c_int(W),
                            p(lev_y), p(lev_u), p(lev_v), p(nz))
    return lev_y, lev_u, lev_v, nz.astype(bool)


def derive_tree_decisions_native(depth_u, mv_u, has_resid_u, ctu_log2: int,
                                 max_merge_cand: int = 5,
                                 pred_intra_u=None):
    """C++ twin of ops.inter_golden.derive_tree_decisions (same sequential
    decode-order walk, ~30x faster). Returns the decisions dict."""
    lib = _load()
    uh, uw = depth_u.shape
    depth = _i32(depth_u)
    mv = _i32(mv_u)
    resid = _u8(has_resid_u)
    skip = np.zeros((uh, uw), np.uint8)
    merge = np.zeros((uh, uw), np.uint8)
    midx = np.zeros((uh, uw), np.int8)
    mvp = np.zeros((uh, uw), np.int8)
    mvd = np.zeros((uh, uw, 2), np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    pi = (ctypes.c_void_p(None) if pred_intra_u is None
          else p(_u8(pred_intra_u)))
    lib.henc_derive_tree_decisions(
        p(depth), p(mv), p(resid), ctypes.c_int(uh), ctypes.c_int(uw),
        ctypes.c_int(ctu_log2), ctypes.c_int(max_merge_cand),
        p(skip), p(merge), p(midx), p(mvp), p(mvd), pi)
    return dict(skip=skip.astype(bool), merge=merge.astype(bool),
                merge_idx=midx, mvp_idx=mvp, mvd=mvd)


def _c8(a):
    return np.ascontiguousarray(a, dtype=np.int8)


def _u8(a):
    return np.ascontiguousarray(a, dtype=np.uint8)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def frame_maps_from_plans(plans, pic_w: int, pic_h: int, ctu_size: int):
    """Assemble frame-level unit maps + coefficient planes from CtuPlans."""
    uw, uh = pic_w // 4, pic_h // 4
    z8 = lambda: np.zeros((uh, uw), np.int8)
    zb = lambda: np.zeros((uh, uw), np.uint8)
    maps = dict(depth=z8(), luma_mode=z8(), chroma_mode=z8(), tr_depth=z8(),
                merge_idx=z8(), mvp_idx=z8(), part_nxn=zb(), pred_intra=zb(),
                skip=zb(), merge_flag=zb(),
                inter_dir=z8(), mvp_idx_l1=z8(),
                mvd_l1=np.zeros((uh, uw, 2), np.int32),
                mvd=np.zeros((uh, uw, 2), np.int32),
                coeff_y=np.zeros((pic_h, pic_w), np.int32),
                coeff_cb=np.zeros((pic_h // 2, pic_w // 2), np.int32),
                coeff_cr=np.zeros((pic_h // 2, pic_w // 2), np.int32))
    ny = -(-pic_h // ctu_size)
    nx = -(-pic_w // ctu_size)
    qp_ctu = np.zeros((ny, nx), np.int8)
    any_qp = False
    for p in plans:
        ux, uy = p.x0 // 4, p.y0 // 4
        un = ctu_size // 4
        sl = (slice(uy, uy + un), slice(ux, ux + un))
        if getattr(p, "qp_ctu", None) is not None:
            qp_ctu[p.y0 // ctu_size, p.x0 // ctu_size] = p.qp_ctu
            any_qp = True
        maps["depth"][sl] = p.depth_map
        maps["luma_mode"][sl] = p.luma_mode
        maps["chroma_mode"][sl] = p.chroma_mode
        maps["tr_depth"][sl] = p.tr_depth_map
        maps["part_nxn"][sl] = p.part_nxn
        if p.pred_intra is not None:
            maps["pred_intra"][sl] = p.pred_intra
            maps["skip"][sl] = p.skip
            maps["merge_flag"][sl] = p.merge_flag
            maps["merge_idx"][sl] = p.merge_idx
            maps["mvp_idx"][sl] = p.mvp_idx
            maps["mvd"][sl] = p.mvd
            if p.inter_dir is not None:
                maps["inter_dir"][sl] = p.inter_dir
                maps["mvd_l1"][sl] = p.mvd_l1
                maps["mvp_idx_l1"][sl] = p.mvp_idx_l1
        else:
            maps["pred_intra"][sl] = 1
        maps["coeff_y"][p.y0:p.y0 + ctu_size, p.x0:p.x0 + ctu_size] = p.coeff_y
        maps["coeff_cb"][p.y0 // 2:(p.y0 + ctu_size) // 2,
                         p.x0 // 2:(p.x0 + ctu_size) // 2] = p.coeff_cb
        maps["coeff_cr"][p.y0 // 2:(p.y0 + ctu_size) // 2,
                         p.x0 // 2:(p.x0 + ctu_size) // 2] = p.coeff_cr
    if any_qp:
        maps["qp_ctu"] = qp_ctu
    return maps


def _blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    if blocks.ndim == 2:                 # already a frame-level plane
        return np.ascontiguousarray(blocks)
    nby, nbx, b, _ = blocks.shape
    return np.ascontiguousarray(
        blocks.transpose(0, 2, 1, 3).reshape(nby * b, nbx * b))


def _rep_units(a: np.ndarray, un: int) -> np.ndarray:
    return np.repeat(np.repeat(a, un, axis=0), un, axis=1)


def maps_from_intra_units(mode_units, depth_units, lev_y, lev_u, lev_v,
                          depth_offset: int = 0, part_units=None,
                          tr_depth_units=None) -> dict:
    """Frame maps directly from the pipelines' unit-granular mode/depth
    maps (any quadtree depth). part_units marks 8x8 CUs coded PART_NxN
    (per-4x4-PU modes live in mode_units; chroma mode = PU0's, spec
    7.3.8.5). tr_depth_units marks split_transform_flag CUs (intra
    residual quadtree depth 1, hmr_motion_intra.c:1229-1632)."""
    m8 = np.ascontiguousarray(np.asarray(mode_units), dtype=np.int8)
    d8 = np.ascontiguousarray(
        np.asarray(depth_units) + depth_offset).astype(np.int8)
    uh, uw = m8.shape
    z8 = np.zeros((uh, uw), np.int8)
    trd = (z8 if tr_depth_units is None else
           np.ascontiguousarray(np.asarray(tr_depth_units)).astype(np.int8))
    if part_units is None:
        part = np.zeros((uh, uw), np.uint8)
        chroma = m8
    else:
        part = np.ascontiguousarray(np.asarray(part_units)).astype(np.uint8)
        # chroma DM follows luma PU0 of each 8x8 CU (2x2 units)
        pu0 = m8[::2, ::2]
        chroma = np.repeat(np.repeat(pu0, 2, 0), 2, 1)[:uh, :uw]
        chroma = np.where(part.astype(bool), chroma, m8).astype(np.int8)
    return dict(depth=d8, luma_mode=m8, chroma_mode=chroma, tr_depth=trd,
                merge_idx=z8, mvp_idx=z8,
                part_nxn=part,
                pred_intra=np.ones((uh, uw), np.uint8),
                skip=np.zeros((uh, uw), np.uint8),
                merge_flag=np.zeros((uh, uw), np.uint8),
                mvd=np.zeros((uh, uw, 2), np.int32),
                coeff_y=_blocks_to_plane(np.asarray(lev_y)),
                coeff_cb=_blocks_to_plane(np.asarray(lev_u)),
                coeff_cr=_blocks_to_plane(np.asarray(lev_v)))


def maps_from_p_units(depth_u, dec: dict, coeff_y, coeff_cb,
                      coeff_cr, tr_depth=None, pred_intra=None,
                      intra_mode=None) -> dict:
    """Frame maps for a quadtree-coded P slice: depth_u and the per-unit
    decision arrays from ops.inter_golden.derive_tree_decisions; coeff
    planes are already frame-level."""
    uh, uw = depth_u.shape
    z8 = np.zeros((uh, uw), np.int8)
    trd = (z8 if tr_depth is None
           else np.ascontiguousarray(tr_depth, np.int8))
    if pred_intra is None:
        pi = np.zeros((uh, uw), np.uint8)
        lm = np.ones((uh, uw), np.int8)
    else:
        pi = np.ascontiguousarray(pred_intra).astype(np.uint8)
        lm = np.where(pi.astype(bool),
                      np.asarray(intra_mode), 1).astype(np.int8)
    return dict(depth=np.ascontiguousarray(depth_u, np.int8),
                luma_mode=lm,
                chroma_mode=lm,
                tr_depth=trd,
                part_nxn=np.zeros((uh, uw), np.uint8),
                pred_intra=pi,
                skip=dec["skip"].astype(np.uint8),
                merge_flag=dec["merge"].astype(np.uint8),
                merge_idx=dec["merge_idx"].astype(np.int8),
                mvp_idx=dec["mvp_idx"].astype(np.int8),
                mvd=np.ascontiguousarray(dec["mvd"], np.int32),
                coeff_y=np.ascontiguousarray(coeff_y, np.int32),
                coeff_cb=np.ascontiguousarray(coeff_cb, np.int32),
                coeff_cr=np.ascontiguousarray(coeff_cr, np.int32))


def maps_from_p_arrays(mvs: np.ndarray, dec: dict, lev_y, lev_u, lev_v,
                       B: int) -> dict:
    """Vectorized frame maps for the all-inter CU-grid P pipeline."""
    un = B // 4
    nby, nbx = dec["skip"].shape
    uh, uw = nby * un, nbx * un
    z8 = np.zeros((uh, uw), np.int8)
    one8 = np.full((uh, uw), 1, np.int8)
    return dict(depth=z8, luma_mode=one8, chroma_mode=one8, tr_depth=z8,
                merge_idx=_rep_units(dec["merge_idx"].astype(np.int8), un),
                mvp_idx=_rep_units(dec["mvp_idx"].astype(np.int8), un),
                part_nxn=np.zeros((uh, uw), np.uint8),
                pred_intra=np.zeros((uh, uw), np.uint8),
                skip=_rep_units(dec["skip"].astype(np.uint8), un),
                merge_flag=_rep_units(dec["merge"].astype(np.uint8), un),
                mvd=np.repeat(np.repeat(dec["mvd"].astype(np.int32),
                                        un, 0), un, 1),
                coeff_y=_blocks_to_plane(np.asarray(lev_y)),
                coeff_cb=_blocks_to_plane(np.asarray(lev_u)),
                coeff_cr=_blocks_to_plane(np.asarray(lev_v)))


def encode_slice_from_maps(params, maps: dict, *, slice_qp: int,
                           slice_type: int, max_merge_cand: int = 5,
                           wpp: bool = False, sao_info: dict | None = None):
    """Encode slice_data() from frame-level unit maps via the C++ walker.

    Returns bytes, or (bytes, substream_sizes) when wpp is set.
    """
    from .cabac import ContextSet
    from .headers import SLICE_B, SLICE_I, SLICE_P

    lib = _load()
    pic_w = params.width + params.pad_right
    pic_h = params.height + params.pad_bottom
    init_type = {SLICE_I: 0, SLICE_P: 1, SLICE_B: 2}[slice_type]
    ctxs = ContextSet(init_type, slice_qp)
    state = _u8(ctxs.state)
    mps = _u8(ctxs.mps)

    sao_on = sao_info is not None
    qp_ctu = maps.get("qp_ctu")
    sp = _SliceParams(pic_w, pic_h, params.ctu_log2, params.min_cu_log2,
                      params.max_tr_depth_intra, params.max_tr_depth_inter,
                      int(params.sign_hiding), slice_type, max_merge_cand,
                      int(wpp),
                      int(sao_on and sao_info.get("sao_luma", True)),
                      int(sao_on and sao_info.get("sao_chroma", True)),
                      int(params.cu_qp_delta_enabled), int(slice_qp))
    cap = pic_w * pic_h * 4 + 4096
    out = np.zeros(cap, np.uint8)
    ctu = 1 << params.ctu_log2
    ny = -(-pic_h // ctu)
    nx = -(-pic_w // ctu)
    sizes = np.zeros(ny, np.int32)
    sao_rec = (pack_sao(sao_info, ny, nx) if sao_on
               else np.zeros((1, 1, 21), np.int8))

    # Keep converted arrays alive for the duration of the call.
    uh = pic_h // 4
    uw = pic_w // 4
    arrs = [_c8(maps["depth"]), _c8(maps["luma_mode"]), _c8(maps["chroma_mode"]),
            _u8(maps["part_nxn"]), _c8(maps["tr_depth"]),
            _u8(maps["pred_intra"]), _u8(maps["skip"]), _u8(maps["merge_flag"]),
            _c8(maps["merge_idx"]), _i32(maps["mvd"]), _c8(maps["mvp_idx"]),
            _i32(maps["coeff_y"]), _i32(maps["coeff_cb"]), _i32(maps["coeff_cr"]),
            _c8(sao_rec) if sao_on else np.zeros(1, np.int8),
            _c8(maps.get("inter_dir", np.zeros((uh, uw), np.int8))),
            _i32(maps.get("mvd_l1", np.zeros((uh, uw, 2), np.int32))),
            _c8(maps.get("mvp_idx_l1", np.zeros((uh, uw), np.int8))),
            state, mps, out]
    ptrs = [a.ctypes.data_as(ctypes.c_void_p) for a in arrs]
    if not sao_on:
        ptrs[14] = ctypes.c_void_p(None)     # sao pointer slot
    qparr = (_c8(qp_ctu) if qp_ctu is not None else None)
    qptr = (qparr.ctypes.data_as(ctypes.c_void_p) if qparr is not None
            else ctypes.c_void_p(None))
    args = ([ctypes.byref(sp)] + ptrs
            + [ctypes.c_int(cap), sizes.ctypes.data_as(ctypes.c_void_p),
               qptr])
    n = lib.henc_encode_slice(*args)
    if n < 0:
        raise RuntimeError("native slice encoder overflow")
    data = bytes(out[:n].tobytes())
    if wpp:
        return data, [int(s) for s in sizes]
    return data


def encode_slice_data_native(params, plans, *, slice_qp: int, slice_type: int,
                             max_merge_cand: int = 5) -> bytes:
    """Drop-in replacement for assemble.encode_slice_data (plans path)."""
    pic_w = params.width + params.pad_right
    pic_h = params.height + params.pad_bottom
    maps = frame_maps_from_plans(plans, pic_w, pic_h, 1 << params.ctu_log2)
    return encode_slice_from_maps(params, maps, slice_qp=slice_qp,
                                  slice_type=slice_type,
                                  max_merge_cand=max_merge_cand)
