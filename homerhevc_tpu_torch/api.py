"""Public encoder session of the PyTorch/CUDA port.

    enc = HomerEncoder(cfg)                    # on the card; raises without one
    au = enc.encode_frame(y, u, v)             # one frame, one AU
    aus = enc.encode_frames(frames, chunk=8)   # Annex-B bytes, one per AU
    aus = enc.push_frame(y, u, v)              # streaming, display order:
    aus += enc.flush()                         # 0+ AUs each, decode order
    enc.close()

Port of homerhevc_tpu/api.py for the configurations this package supports
(check_slice: every performance mode at cu_size 32 and 64, FASTEST and
FASTER at cu_size 16, fixed QP or CBR / VBR rate control with
per-CTU-row QPs on the quadtree path, WPP, every rd_mode, all-intra, and
B frames at cu_size 16 and 32): IDR frames through the all-intra
wavefront (CU = TU = min(CTU, 32) in FASTEST, the split-RDO quadtree with
NxN and intra TU split otherwise; a 64-CTU codes its four 32-blocks in
z-order; rd_mode sets the mode search), P frames through the fixed-CU
device stage (FASTEST, FASTER) or the inter CU quadtree with hierarchical
ME and inter TU split (FAST; FULL descends to 8x8 CUs; intra-in-P at CTU
32), chunked K frames per dispatch with the reference planes kept on the
device, and host CABAC (this package's own libhenc, built with g++ at
first use) overlapping device work on the next chunk. With gop_size >= 2,
push_frame codes the reference's IBP GOP: anchors per frame as above, each
B frame between its two anchors (pipeline/b_torch.py), explicit P frames
before a scheduled IDR and at flush, in the reference's call order
(encode_frames, like the reference's, codes IPPP chunks). Every AU equals,
byte for byte, what `homerhevc_tpu.api.HomerEncoder(cfg, backend="jax")`
writes. Configurations outside the slice raise NotImplementedError naming
the setting. Nothing of the JAX package is imported: config, tables,
entropy coding and AU assembly are this package's own copies, and a
configuration object of another package raises TypeError.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import tables
from .config import BitrateMode, EncoderConfig, PerformanceMode
from .device import require_cuda
from .entropy import headers, native_backend
from .ops.inter_golden import derive_block_decisions_fast
from .ops.sao import sao_stage_device
from .parallel import intra_bands, sharded
from .pipeline import (assemble, b_golden, b_torch, intra_torch, p_chunk,
                       p_graph, p_torch)
from .rate_control import RateControl
from .utils.profiler import NULL

SCENE_SAD_PER_PIXEL = 25.0     # mean best-ME-cost per pixel => scene cut


def _pad_to(a: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = h - a.shape[0], w - a.shape[1]
    if ph == 0 and pw == 0:
        return a
    return np.pad(a, ((0, ph), (0, pw)), mode="edge")


def _tree_decisions(depth_u, mv_u, nz_u, ctu_log2: int, n_cand: int = 5,
                    pred_intra_u=None):
    """Merge/skip/AMVP decision walk in libhenc (bit-identical to the
    Python walk ops.inter_golden.derive_tree_decisions;
    tests/test_torch_host.py)."""
    return native_backend.derive_tree_decisions_native(
        depth_u, mv_u, nz_u, ctu_log2, n_cand, pred_intra_u=pred_intra_u)


def _fixed_p_step(y, u, v, ref_y, ref_u, ref_v, qp, *, deblock: bool, **kw):
    """p_torch.p_frame_device as a tuple: the wire, then the reference
    planes it leaves (loop-filtered with `deblock`, else the
    reconstruction)."""
    out = p_torch.p_frame_device(y, u, v, ref_y, ref_u, ref_v, qp=qp,
                                 deblock=deblock, **kw)
    key = "ref" if deblock else "recon"
    return out["wire"], out[key + "_y"], out[key + "_u"], out[key + "_v"]


def _nz_units(lev_y, lev_u, lev_v) -> np.ndarray:
    """Per 4x4 luma unit, whether its luma 4x4 block or either chroma 2x2
    block holds a nonzero level: each unit row's 4 (2) flags are read as
    one 32-bit (16-bit) word, which numpy ORs whole, where a reduction over
    the short block axes takes many times longer."""
    uh, uw = lev_y.shape[0] // 4, lev_y.shape[1] // 4
    y = (lev_y != 0).view(np.uint32).reshape(uh, 4, uw)
    nz = (y[:, 0] | y[:, 1] | y[:, 2] | y[:, 3]) != 0
    for lev in (lev_u, lev_v):
        c = (lev != 0).view(np.uint16).reshape(uh, 2, uw)
        nz |= (c[:, 0] | c[:, 1]) != 0
    return nz


def _device(d) -> torch.device:
    """A torch.device with the current CUDA device's index where a CUDA
    device names none."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _band_mesh(mesh, wpp_shards: int, device: torch.device):
    """The session's band axis: `mesh` as devices, or for wpp_shards > 1 on
    a CUDA session with that many CUDA devices, that many from the
    session's own on; None for one device."""
    if mesh is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 0
        if wpp_shards <= 1 or n < wpp_shards:
            return None
        return [torch.device("cuda", (device.index + i) % n)
                for i in range(wpp_shards)]
    devs = [_device(d) for d in mesh]
    if not devs:
        raise ValueError("mesh: no device")
    if any(d.type != device.type for d in devs):
        raise ValueError(f"mesh {[str(d) for d in devs]} names a device of "
                         f"another type than the session's {device}")
    if devs[0] != device:
        raise ValueError(f"mesh starts at {devs[0]}, not at the session's "
                         f"device {device}")
    return devs if len(devs) > 1 else None


def check_slice(c: EncoderConfig) -> None:
    """Raise NotImplementedError for any setting outside the ported slice:
    cu_size 32 and 64 in every performance mode, cu_size 16 in FASTEST and
    FASTER, any bitrate_mode, WPP or not, every rd_mode, IPPP, and B frames
    (gop_size >= 2) at cu_size 16 and 32; any wpp_shards (a band mesh, see
    HomerEncoder); 8-bit. (The JAX package has no quadtree P stage at
    cu_size 16: FAST and FULL fail there, fault 1 of the reference in
    ROADMAP.md; its B stage codes TU = CU, and at cu_size 64 asks for a
    64-point DCT, which HEVC does not have.)"""
    checks = (
        (c.cu_size == 16 and c.performance_mode
         <= PerformanceMode.FAST_COMPUTATION,
         f"cu_size=16 with {c.performance_mode.name} (fault 1 of the "
         "reference: the JAX package has no quadtree P stage at CTU 16 and "
         "raises KeyError: 32)"),
        (c.gop_size >= 2 and c.cu_size == 64,
         f"gop_size={c.gop_size} at cu_size=64 (B frames: the reference's "
         "B stage codes TU = CU and asks for a 64-point DCT)"),
        (c.bit_depth != 8, f"bit_depth={c.bit_depth}"),
    )
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"homerhevc_tpu_torch: {what} is not "
                                      "ported")


class HomerEncoder:
    """Streaming HEVC encoder session (IDR + P low-delay, or IBP through
    push_frame) on one device, or with its P frames in bands on a mesh of
    devices.

    `device=None` (the default) is the CUDA device, and raises RuntimeError
    when there is none; a caller that wants the CPU says `device="cpu"`.
    `mesh` is a sequence of devices, the band axis (a device may be named
    several times); without it, `cfg.wpp_shards > 1` on a CUDA session
    builds one over that many CUDA devices from the session's own when the
    machine has them, and none otherwise (as the JAX package does). With a
    mesh, every P frame runs in bands of whole CTU rows
    (parallel/sharded.py), per frame and in chunks: the fixed-CU stage
    (FASTEST, FASTER, and the explicit P frames of IBP) and the CU
    quadtree (FAST, FULL), each with its deblocking and SAO; within a chunk
    each band keeps its reference rows. So does every IDR, scene-cut
    re-encodes included (parallel/intra_bands.py: pass A of the split-RDO
    IDR, the wavefront of pass B or of the fixed-CU IDR, deblocking and
    SAO), and every B frame (sharded.b_frame_bands). The host's work runs
    on the mesh's first device, which is the session's device (`device`,
    when not given) and holds the joined reference. The AUs are the same
    with or without a mesh. A mesh whose devices are of
    another type than the session's, or whose first device is not the
    session's, raises ValueError.
    `cfg` must be this package's `EncoderConfig` (TypeError otherwise: the
    enums of another package compare unequal to these).
    `kernels=False` runs the plain PyTorch versions of the hand-written
    CUDA kernels on a CUDA device (for comparison runs only); on a CPU
    device the plain versions always run.
    `profiler` (utils.profiler.Profiler) times the session's stages under
    the JAX session's names; by default the disabled NULL, which reads no
    clock and waits for nothing."""

    def __init__(self, cfg: EncoderConfig, *, device=None, mesh=None,
                 kernels: bool = True, fetch_recon: bool = True,
                 profiler=None):
        if not isinstance(cfg, EncoderConfig):
            raise TypeError(
                "HomerEncoder needs a homerhevc_tpu_torch.config."
                f"EncoderConfig, not {type(cfg).__module__}."
                f"{type(cfg).__qualname__}")
        self.cfg = cfg.validate()
        check_slice(self.cfg)
        c = self.cfg
        if device is None and mesh:
            device = mesh[0]
        self.device = _device(require_cuda() if device is None else device)
        self._mesh = _band_mesh(mesh, c.wpp_shards, self.device)
        self.kernels = kernels
        self.fetch_recon = fetch_recon
        self.prof = profiler if profiler is not None else NULL
        self.ctu = c.ctu_size
        self.ctu_log2 = self.ctu.bit_length() - 1
        # intra codes at most 32x32 CUs: a 64-CTU IDR holds four 32-blocks
        # in z-order
        self.intra_b = min(self.ctu, 32)
        self.ctu64 = self.ctu == 64
        # FULL / FAST / FASTER: the IDR RD-searches the intra CU quadtree
        self.intra_split = (c.performance_mode
                            != PerformanceMode.FASTEST_COMPUTATION)
        # FULL / FAST: P frames RD-search the inter CU quadtree (CTU -> 16);
        # FASTER / FASTEST: fixed CU = CTU grid
        self.inter_split = (c.performance_mode
                            <= PerformanceMode.FAST_COMPUTATION)
        # FULL: the inter quadtree descends to 8x8 CUs
        self.inter_cu8 = (c.performance_mode
                          == PerformanceMode.FULL_COMPUTATION)
        self.pw = c.padded_width
        self.ph = c.padded_height
        self.params = headers.StreamParams(
            width=c.width, height=c.height,
            pad_right=self.pw - c.width, pad_bottom=self.ph - c.height,
            ctu_log2=self.ctu_log2,
            min_cu_log2=(3 if self.intra_split
                         else self.intra_b.bit_length() - 1),
            max_tu_log2=min(5, self.ctu_log2),
            # one residual-quadtree level, RD-searched on the device
            max_tr_depth_intra=int(self.intra_split
                                   and c.max_intra_tr_depth >= 1),
            max_tr_depth_inter=int(self.inter_split
                                   and c.max_inter_tr_depth >= 1),
            init_qp=c.qp, sign_hiding=c.sign_hiding,
            deblocking_disabled=not c.deblocking,
            num_ref_frames=(2 if c.gop_size >= 2 else 1),
            wpp_enabled=c.wpp, sao_enabled=c.sample_adaptive_offset,
            cb_qp_offset=c.chroma_qp_offset,
            cr_qp_offset=c.chroma_qp_offset,
            # with B frames: the anchor P two pictures back (0), the B
            # between its anchors (1), the explicit P one picture back (2)
            **({} if c.gop_size < 2 else dict(
                num_reorder_pics=1,
                rps_list=(headers.StRefPicSet(delta_pocs=(2,), used=(True,)),
                          headers.StRefPicSet(delta_pocs=(1,), used=(True,),
                                              pos_delta_pocs=(1,),
                                              pos_used=(True,)),
                          headers.StRefPicSet(delta_pocs=(1,),
                                              used=(True,))))))
        # rate control: host-side scalar state, queried in the reference's
        # order (the QP trajectory depends on it)
        self._rc = (None if c.bitrate_mode == BitrateMode.FIXED_QP
                    else RateControl(c))
        # per-CTU-row QPs (cu_qp_delta, one quantisation group per CTB)
        # whenever rate control runs on the quadtree path; each row's plan
        # comes from the previous frame's bits per row
        self._row_qp_on = self._rc is not None and self.inter_split
        self._prev_row_load = None
        self._prev_row_bits = None
        if self._row_qp_on:
            self.params = dataclasses.replace(
                self.params, cu_qp_delta_enabled=True, cu_qp_delta_depth=0)
        self.poc = 0
        self.last_idr = 0
        self._ref = None           # decoded reference planes, on the device
        self._cur_dev = None
        self.last_recon = None
        self.last_qp = c.qp
        self.frame_bytes = []
        self.chunk_overflows = 0
        self._disp = 0               # display index of the next push_frame
        self._b_pend = None          # (display index, frame) of a waiting B
        # side stream for the device-to-host wire copy of each chunk, so the
        # copy of chunk k overlaps compute of chunk k+1 on the main stream
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # the fixed-CU P step on one CUDA device replays from CUDA graphs
        self._graphs = (p_graph.StepGraphs()
                        if p_graph.engaged(self.device) and self._mesh is None
                        else None)

    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _pad_frame(self, y, u, v):
        return (_pad_to(np.asarray(y, np.uint8), self.ph, self.pw),
                _pad_to(np.asarray(u, np.uint8), self.ph // 2, self.pw // 2),
                _pad_to(np.asarray(v, np.uint8), self.ph // 2, self.pw // 2))

    def seed_reference(self, ref_planes, *, poc: int,
                       last_idr: int | None = None) -> None:
        """Continue a P chain started elsewhere: install reconstructed
        reference planes (padded Y/U/V uint8 numpy) on the session's device
        and the next POC, exactly as the reference session does."""
        ry, ru, rv = (np.asarray(p, np.uint8) for p in ref_planes)
        if ry.shape != (self.ph, self.pw):
            raise ValueError("seed ref must be padded to (ph, pw)")
        if ru.shape != (self.ph // 2, self.pw // 2) or rv.shape != ru.shape:
            raise ValueError("seed ref chroma planes must be padded to "
                             "(ph/2, pw/2)")
        self._ref = tuple(self._upload(p) for p in (ry, ru, rv))
        self.poc = int(poc)
        if last_idr is not None:
            self.last_idr = int(last_idr)
        elif self.cfg.intra_period > 0 and self.poc % self.cfg.intra_period:
            raise ValueError("seed_reference needs last_idr when poc is not "
                             "a multiple of intra_period")

    # ------------------------------------------------------------------
    def encode_frame(self, y, u, v, *, force_idr: bool = False) -> bytes:
        c = self.cfg
        if np.shape(y) != (c.height, c.width):
            raise ValueError("frame size mismatch")
        yp, up, vp = self._pad_frame(y, u, v)
        is_idr = (self.poc == 0 or force_idr
                  or (c.intra_period > 0
                      and (self.poc - self.last_idr) % c.intra_period == 0))
        qp = int(np.clip(self._rc.frame_qp(is_idr) if self._rc else c.qp,
                         0, 51))
        self.last_qp = qp
        self._scene_idr = False
        au, recon_padded = self._encode(yp, up, vp, is_idr, qp)
        if self._scene_idr:
            is_idr = True
        if is_idr:
            self.last_idr = self.poc
        self.poc += 1
        self.frame_bytes.append(len(au))
        if self._rc:
            self._rc.end_frame(len(au) * 8, is_idr)
        self.last_recon = self._crop(recon_padded)
        return au

    def _crop(self, recon_padded):
        """The decoder's output picture from padded planes (None stays
        None)."""
        if recon_padded is None:
            return None
        c = self.cfg
        return tuple(p[:h, :w] for p, (h, w) in zip(
            recon_padded, ((c.height, c.width), (c.height // 2, c.width // 2),
                           (c.height // 2, c.width // 2))))

    def _scene_cut(self, qp: int) -> int:
        """A P frame turned out to be a scene cut: mark it, re-target rate
        control and ask it again, for an I frame, for the QP of the IDR
        re-encode (`qp` at a fixed QP)."""
        self._scene_idr = True
        if self._rc is None:
            return qp
        self._rc.on_scene_change()
        qp = int(np.clip(self._rc.frame_qp(True), 0, 51))
        self.last_qp = qp
        return qp

    def _encode(self, yp, up, vp, is_idr, qp):
        c = self.cfg
        size = self.ctu
        prof = self.prof
        with prof.probe("upload"):
            self._cur_dev = tuple(self._upload(p) for p in (yp, up, vp))
        ydev, udev, vdev = self._cur_dev
        if is_idr:
            # the row-QP history does not survive an IDR
            self._prev_row_load = self._prev_row_bits = None
            tu_depth = self.params.max_tr_depth_intra
            kw = dict(B=size, qp=qp, sign_hiding=c.sign_hiding,
                      split_rdo=self.intra_split, rd_mode=int(c.rd_mode),
                      tu_depth=tu_depth)
            with prof.probe("intra.device"):
                if self._mesh is None:
                    out = intra_torch.encode_frame_intra(ydev, udev, vdev,
                                                         **kw)
                else:                  # the loop filter in bands as well
                    out = intra_bands.intra_frame_bands(
                        self._mesh, ydev, udev, vdev, deblock=c.deblocking,
                        sao=c.sample_adaptive_offset, **kw)
            with prof.probe("intra.fetch+maps"):
                wire_h = out["wire"].cpu().numpy()      # one compact fetch
                (cnt_i, mode_u8, depth_u8, part_u8, trd_u8, idx_i,
                 vals_i) = intra_torch.unpack_intra_wire(wire_h, self.ph,
                                                         self.pw)
                cap_i = intra_torch.intra_wire_cap(self.ph, self.pw)
                if cnt_i <= cap_i:
                    lev = native_backend.scatter_levels_native(
                        idx_i, vals_i, cnt_i, self.ph, self.pw)[:3]
                else:                              # capacity overflow
                    self.chunk_overflows += 1
                    lev = tuple(out[k].cpu().numpy()
                                for k in ("lev_y", "lev_u", "lev_v"))
                # a 64-CTU's unit depths count from its 32-blocks
                maps = native_backend.maps_from_intra_units(
                    mode_u8, depth_u8, *lev, depth_offset=int(self.ctu64),
                    part_units=(part_u8.astype(bool) if self.intra_split
                                else None),
                    tr_depth_units=(trd_u8 if tu_depth else None))
            if self._mesh is not None:
                with prof.probe("sao"):
                    sao_info = self._p_ref_and_sao(out, qp)
            else:
                if c.deblocking:
                    self._ref = p_torch.deblock_intra_device(
                        out["recon_y"], out["recon_u"], out["recon_v"],
                        qp=qp, depth_units=out["depth_units"],
                        trd_units=(out["trd_units"] if tu_depth else None))
                else:
                    self._ref = (out["recon_y"], out["recon_u"],
                                 out["recon_v"])
                with prof.probe("sao"):
                    sao_info = self._maybe_sao(qp)
            with prof.probe("entropy"):
                au = assemble.assemble_idr_au_from_maps(
                    self.params, maps, slice_qp=qp,
                    include_parameter_sets=True, sao_info=sao_info)
        elif self.inter_split:
            au = self._encode_p_tree(qp)
            if au is None:               # scene cut: re-encode as IDR
                return self._encode(yp, up, vp, True, self._scene_cut(qp))
        else:
            with prof.probe("p.device"):
                out = self._fixed_p_device(
                    self._cur_dev, self._ref, qp, deblock=c.deblocking,
                    sao=c.sample_adaptive_offset)
            mvs, sad, lev = self._fixed_p_fetch(out["wire"], size, "p")
            if c.reinit_gop_on_scene_change:
                ms = float(sad.astype(np.int64).mean())
                if ms / (size * size) > SCENE_SAD_PER_PIXEL:
                    return self._encode(yp, up, vp, True,
                                        self._scene_cut(qp))
            maps = self._fixed_p_maps(mvs, lev, size, "p")
            with prof.probe("sao"):
                sao_info = self._p_ref_and_sao(out, qp)
            with prof.probe("entropy"):
                au = assemble.assemble_p_au_from_maps(
                    self.params, maps, poc=self.poc - self.last_idr,
                    slice_qp=qp, sao_info=sao_info)
        recon = None
        if self.fetch_recon:
            with prof.probe("ref.fetch"):
                recon = tuple(p.cpu().numpy() for p in self._ref)
        return au, recon

    def _fixed_p_device(self, cur, ref, qp, *, deblock: bool,
                        sao: bool = False) -> dict:
        """The fixed-CU P stage of one frame against `ref` (p_torch.
        p_frame_device's result); with a mesh in bands, the loop filter too,
        SAO as well when `sao` is on (sharded.p_frame_bands). Through the
        session's graphs the result holds the wire, which the next replay
        overwrites (the caller fetches it first), and copies of the
        reference planes."""
        c = self.cfg
        kw = dict(B=self.ctu, search=c.me_search_range,
                  me_precision=int(c.motion_estimation_precision),
                  deblock=deblock, sign_hiding=c.sign_hiding,
                  kernels=self.kernels)
        if self._mesh is not None:
            return sharded.p_frame_bands(self._mesh, *cur, *ref, qp=qp,
                                         sao=sao, **kw)
        if self._graphs is None:
            return p_torch.p_frame_device(*cur, *ref, qp=qp, **kw)
        wire, *planes = self._graphs.run(
            functools.partial(_fixed_p_step, **kw), (*cur, *ref, qp))
        key = "ref" if deblock else "recon"
        return dict(wire=wire, **{f"{key}_{comp}": p.clone()
                                  for comp, p in zip("yuv", planes)})

    def _p_ref_and_sao(self, out, qp):
        """A P frame's (or, on the mesh, an IDR's) loop-filtered reference
        from its device stage's result `out`, SAO included (on the mesh the
        bands ran it already); returns the SAO parameters or None."""
        c = self.cfg
        key = "ref" if c.deblocking or "sao_info" in out else "recon"
        self._ref = (out[key + "_y"], out[key + "_u"], out[key + "_v"])
        if self._mesh is not None:
            return out.get("sao_info")
        return self._maybe_sao(qp, slice_p=True)

    def _fixed_p_fetch(self, wire, size: int, stage: str):
        """One fetch of a fixed-CU P frame's device wire (probe
        `stage`.fetch). Returns the block MVs, each block's best ME cost and
        the luma, Cb and Cr levels per block."""
        nby, nbx = self.ph // size, self.pw // size
        B2 = size // 2
        ny = nby * nbx * size * size
        nc = nby * nbx * B2 * B2
        with self.prof.probe(stage + ".fetch"):
            wire = wire.cpu().numpy()                   # one fetch
            meta = np.ascontiguousarray(wire[ny + 2 * nc:]).view(np.int32)
            mvs = meta[:nby * nbx * 2].reshape(nby, nbx, 2)
            sad = meta[nby * nbx * 2:].reshape(nby, nbx)
        lev = (wire[:ny].reshape(nby, nbx, size, size),
               wire[ny:ny + nc].reshape(nby, nbx, B2, B2),
               wire[ny + nc:ny + 2 * nc].reshape(nby, nbx, B2, B2))
        return mvs, sad, lev

    def _fixed_p_maps(self, mvs, lev, size: int, stage: str):
        """Host half of a fixed-CU P frame after its fetch: the merge/skip/
        AMVP decisions and the syntax maps (probe `stage`.decisions+maps)."""
        with self.prof.probe(stage + ".decisions+maps"):
            has_resid = np.any(lev[0], axis=(-1, -2))
            for lv in lev[1:]:
                has_resid |= np.any(lv, axis=(-1, -2))
            dec, _ = derive_block_decisions_fast(mvs, has_resid, size, 5)
            return native_backend.maps_from_p_arrays(mvs, dec, *lev, size)

    def _tree_kwargs(self) -> dict:
        """Static settings of the tree P stage, per frame and per chunk."""
        c = self.cfg
        return dict(ctu=self.ctu, search=c.me_search_range,
                    me_precision=int(c.motion_estimation_precision),
                    sign_hiding=c.sign_hiding,
                    tr_split=self.params.max_tr_depth_inter > 0,
                    intra_in_p=self.ctu == 32, cu8=self.inter_cu8,
                    wpp=c.wpp, vis=(c.height, c.width), kernels=self.kernels)

    def _tree_maps(self, depth_u, mv_u, nz_u, trd_u, intra_u, lev,
                   qp_rows=None):
        """Host decisions and syntax maps of one tree P frame from its unit
        maps (intra units carry the luma mode in the MV's x slot). With row
        QPs, each CTU's cu_qp_delta target is its row's QP, and the frame's
        luma nonzeros per CTU row become the load of the next plan."""
        is_intra = intra_u.astype(bool)
        imode_u = np.where(is_intra, mv_u[..., 0], 1)
        dec = _tree_decisions(depth_u, mv_u, nz_u, self.ctu_log2, 5,
                              pred_intra_u=intra_u)
        # intra-in-P CUs code TU = CU: the inter TU-split flag must not
        # leak into their transform tree
        trd_p = np.where(is_intra, 0, trd_u)
        maps = native_backend.maps_from_p_units(
            depth_u, dec, *lev, tr_depth=trd_p, pred_intra=intra_u,
            intra_mode=imode_u)
        if qp_rows is not None:
            nby, nbx = self.ph // self.ctu, self.pw // self.ctu
            maps["qp_ctu"] = np.repeat(np.asarray(qp_rows)[:, None], nbx,
                                       1).astype(np.int8)
            self._prev_row_load = (lev[0] != 0).reshape(nby, self.ctu,
                                                        -1).sum((1, 2))
        return maps

    def _plan_rows(self, qp: int):
        """This frame's per-CTU-row QPs from the last finished frame's bits
        per row (None without row QPs)."""
        if not self._row_qp_on:
            return None
        return self._rc.plan_rows(qp, self.ph // self.ctu,
                                  self._prev_row_load, self._prev_row_bits)

    def _row_bits_from(self, au: bytes, qp_rows) -> None:
        """A frame's real bits, spread over its CTU rows by their load."""
        if qp_rows is not None and self._prev_row_load is not None:
            load = self._prev_row_load.astype(np.float64)
            self._prev_row_bits = len(au) * 8 * load / max(load.sum(), 1.0)

    def _encode_p_tree(self, qp):
        """P frame through the inter CU quadtree device stage. Returns the
        AU, or None on a detected scene cut (the caller re-encodes as
        IDR)."""
        c = self.cfg
        ctu = self.ctu
        prof = self.prof
        qp_rows = self._plan_rows(qp)
        with prof.probe("p.device"):
            kw = dict(qp=qp, deblock=c.deblocking,
                      qp_rows=(None if qp_rows is None
                               else self._upload(qp_rows.astype(np.int32))),
                      **self._tree_kwargs())
            if self._mesh is None:
                out = p_torch.p_frame_tree_device(*self._cur_dev, *self._ref,
                                                  **kw)
            else:
                out = sharded.p_frame_tree_bands(
                    self._mesh, *self._cur_dev, *self._ref,
                    sao=c.sample_adaptive_offset, **kw)
        uh, uw = self.ph // 4, self.pw // 4
        nu = uh * uw
        npix = self.ph * self.pw
        with prof.probe("p.fetch"):
            wire = out["wire"].cpu().numpy()            # one fetch
            meta = np.ascontiguousarray(
                wire[npix + npix // 2:]).view(np.int32)
            depth_u, mv_u, nz_u, trd_u, intra_u = (
                m.reshape(shape) for m, shape in zip(
                    np.split(meta[:6 * nu], np.cumsum([nu, 2 * nu, nu, nu])),
                    ((uh, uw), (uh, uw, 2), (uh, uw), (uh, uw), (uh, uw))))
            sad = meta[6 * nu:].reshape(self.ph // ctu, self.pw // ctu)
        if c.reinit_gop_on_scene_change:
            ms = float(sad.astype(np.int64).mean())
            if ms / (ctu * ctu) > SCENE_SAD_PER_PIXEL:
                return None
        lev = (wire[:npix].reshape(self.ph, self.pw),
               wire[npix:npix + npix // 4].reshape(self.ph // 2,
                                                   self.pw // 2),
               wire[npix + npix // 4:npix + npix // 2].reshape(
                   self.ph // 2, self.pw // 2))
        with prof.probe("p.decisions+maps"):
            maps = self._tree_maps(depth_u, mv_u, nz_u.astype(bool), trd_u,
                                   intra_u, lev, qp_rows)
        with prof.probe("sao"):
            sao_info = self._p_ref_and_sao(out, qp)
        with prof.probe("entropy"):
            au = assemble.assemble_p_au_from_maps(
                self.params, maps, poc=self.poc - self.last_idr,
                slice_qp=qp, sao_info=sao_info)
            self._row_bits_from(au, qp_rows)
        return au

    def _maybe_sao(self, qp, slice_p=False):
        """SAO on the loop-filtered reference: device stats, host numpy
        derivation, device application; updates the reference planes."""
        if not self.cfg.sample_adaptive_offset:
            return None
        qp_c = int(tables.chroma_qp_from_luma(qp))
        info, self._ref = sao_stage_device(self._cur_dev, self._ref,
                                           self.ctu, qp, qp_c,
                                           slice_p=slice_p)
        return info

    # ------------------------------------------------------------------
    def push_frame(self, y, u, v) -> list:
        """Streaming input in display order; returns 0 or more Annex-B AUs
        in decode order. With gop_size >= 2 each B frame waits for its
        future anchor (I0, P2, B1, P4, B3, ...: the reference's default IBP
        GOP); otherwise this is encode_frame. A B whose next anchor is an
        IDR is coded as an explicit P before the IDR. `last_recon` is the
        last anchor's decoded picture (the session keeps none of a B)."""
        c = self.cfg
        if c.gop_size < 2:
            return [self.encode_frame(y, u, v)]
        if np.shape(y) != (c.height, c.width):
            raise ValueError("frame size mismatch")
        d = self._disp
        self._disp += 1
        if d % 2 == 1:                       # B position: wait for the anchor
            self._b_pend = (d, (y, u, v))
            return []
        out = []
        prev_ref = self._ref                 # the previous anchor
        is_idr = (d == 0 or (c.intra_period > 0
                             and (d - self.last_idr) % c.intra_period == 0))
        if is_idr and self._b_pend is not None:
            out.append(self._encode_p_explicit(self._b_pend, prev_ref))
            self._b_pend = None
        qp = int(np.clip(self._rc.frame_qp(is_idr) if self._rc else c.qp,
                         0, 51))
        self.poc = d
        self._scene_idr = False
        au, recon = self._encode(*self._pad_frame(y, u, v), is_idr, qp)
        if self._scene_idr:
            is_idr = True
        if is_idr:
            # a scene-cut IDR moves the anchor before a waiting B is coded,
            # so that frame's POC is -1 (as the reference writes it)
            self.last_idr = d
        out.append(au)
        self.frame_bytes.append(len(au))
        if self._rc:
            self._rc.end_frame(len(au) * 8, is_idr)
        self.last_recon = self._crop(recon)
        if self._b_pend is not None:
            pend, self._b_pend = self._b_pend, None
            if is_idr:                       # scene-cut IDR: no B across it
                out.insert(len(out) - 1,
                           self._encode_p_explicit(pend, prev_ref))
            else:
                out.append(self._encode_b(pend, prev_ref, self._ref))
        return out

    def flush(self) -> list:
        """The waiting B frame of an even-length input, as an explicit P
        against the last anchor (no AU when nothing waits)."""
        if self._b_pend is None:
            return []
        pend, self._b_pend = self._b_pend, None
        return [self._encode_p_explicit(pend, self._ref)]

    def _encode_p_explicit(self, pend, ref) -> bytes:
        """A fixed-CU P frame against the given reference planes, one
        picture back (a trailing frame, or one before an IDR): rps 2, no
        loop filter on its reconstruction, which nothing references."""
        c = self.cfg
        size = self.ctu
        prof = self.prof
        d, frame = pend
        qp = int(np.clip(self._rc.frame_qp(False) if self._rc else c.qp,
                         0, 51))
        with prof.probe("p_expl.upload"):
            cur = tuple(self._upload(p) for p in self._pad_frame(*frame))
        with prof.probe("p_expl.device"):
            out = self._fixed_p_device(cur, ref, qp, deblock=False)
        mvs, _, lev = self._fixed_p_fetch(out["wire"], size, "p_expl")
        maps = self._fixed_p_maps(mvs, lev, size, "p_expl")
        with prof.probe("p_expl.entropy"):
            au = assemble.assemble_p_au_from_maps(
                self.params, maps, poc=d - self.last_idr, slice_qp=qp,
                rps_idx=2)
        self.frame_bytes.append(len(au))
        if self._rc:
            self._rc.end_frame(len(au) * 8, False)
        return au

    def _encode_b(self, pend, ref0, ref1) -> bytes:
        """One B frame between its two anchors' decoded planes (a
        non-reference picture: its reconstruction is not kept)."""
        c = self.cfg
        prof = self.prof
        d, frame = pend
        qp = int(np.clip(self._rc.frame_qp(False, is_b=True) if self._rc
                         else c.qp + 2, 0, 51))
        with prof.probe("b.upload"):
            cur = tuple(self._upload(p) for p in self._pad_frame(*frame))
        with prof.probe("b.device"):
            kw = dict(B=self.ctu, qp=qp, search=c.me_search_range,
                      me_precision=int(c.motion_estimation_precision),
                      sign_hiding=c.sign_hiding, vis=(c.height, c.width),
                      kernels=self.kernels)
            if self._mesh is None:
                out = b_torch.b_frame_device(*cur, *ref0, *ref1, **kw)
            else:
                out = sharded.b_frame_bands(self._mesh, *cur, *ref0, *ref1,
                                            **kw)
        with prof.probe("b.fetch"):
            w = b_torch.unpack_b_wire(out["wire"].cpu().numpy(), self.ph,
                                      self.pw, self.ctu)    # one fetch
        with prof.probe("b.plans"):
            plan = b_golden.build_b_plans(
                w["idc"], w["mv0"], w["mv1"],
                *(w[k].astype(np.int32) for k in ("lev_y", "lev_u", "lev_v")),
                (None, None, None), size=self.ctu, poc=d - self.last_idr,
                poc_refs=(d - 1 - self.last_idr, d + 1 - self.last_idr))
        with prof.probe("b.entropy"):
            au = assemble.assemble_p_au(self.params, plan.ctu_plans,
                                        poc=d - self.last_idr, slice_qp=qp,
                                        slice_type=headers.SLICE_B,
                                        rps_idx=1)
        self.frame_bytes.append(len(au))
        if self._rc:
            self._rc.end_frame(len(au) * 8, False, is_b=True)
        return au

    # ------------------------------------------------------------------
    def encode_frames(self, frames, *, chunk: int = 8) -> list:
        """Batched streaming encode: [(y, u, v), ...] -> [Annex-B AU, ...].

        Runs of P frames go through the chunked device pipeline, one
        dispatch and one wire copy per `chunk` frames; up to
        `frame_pipeline_depth` chunks are in flight, so the host CABAC of
        chunk k overlaps device work on chunk k+1. Rate control issues each
        frame's QP, and plans its CTU rows, when its chunk is dispatched,
        from the bits of the chunks finished by then. IDR frames (POC 0,
        intra_period boundaries, scene cuts) use the per-frame path. The
        reference's encode_frames does not read gop_size: with B frames
        configured it still codes IPPP, under the two-reference parameter
        sets, and so does this one (push_frame codes the IBP GOP)."""
        c = self.cfg
        n = len(frames)
        poc0 = self.poc
        aus: list = [None] * n
        i = 0

        def is_idr_at(k):
            poc = poc0 + k
            return (poc == 0
                    or (c.intra_period > 0
                        and (poc - self.last_idr) % c.intra_period == 0))

        depth = max(1, int(c.frame_pipeline_depth))
        pend_q = []
        while i < n or pend_q:
            while i < n and not is_idr_at(i) and len(pend_q) < depth:
                if c.intra_period > 0:
                    poc = poc0 + i
                    run_end = min(n, i + c.intra_period
                                  - (poc - self.last_idr) % c.intra_period)
                else:
                    run_end = n
                j = min(run_end, i + chunk)
                idxs = list(range(i, j))
                qps = [int(np.clip(self._rc.frame_qp(False) if self._rc
                                   else c.qp, 0, 51)) for _ in idxs]
                pend_q.append(self._dispatch_chunk(
                    [frames[k] for k in idxs], idxs, qps))
                i = j
            if pend_q:
                if self._finish_chunk(pend_q.pop(0), aus, frames) == "scene":
                    # the re-encode changed the reference chain: every
                    # dispatched-but-unprocessed chunk is invalid
                    pend_q.clear()
                    i = next((k for k in range(n) if aus[k] is None), n)
            if not pend_q and i < n and is_idr_at(i):
                aus[i] = self.encode_frame(*frames[i])
                i += 1
        return aus

    @property
    def _chunk_cap(self):
        # compacted coded-sub-block capacity: 1/64 of all 4x4 sub-blocks
        L4 = (self.ph // 4) * (self.pw // 4) * 3 // 2
        return max(1024, L4 // 64)

    @property
    def _chunk_cap2(self):
        return max(64, self._chunk_cap // 8)

    def _dispatch_chunk(self, fr, idxs, qps):
        c = self.cfg
        padded = [self._pad_frame(*f) for f in fr]
        planes = [np.stack([p[k] for p in padded]) for k in range(3)]
        with self.prof.probe("chunk.upload"):
            ys, us, vs = (self._upload(p) for p in planes)
        # every frame of the chunk is planned from the same (stale) history
        row_plans = (np.stack([self._plan_rows(q) for q in qps])
                     if self._row_qp_on else None)
        with self.prof.probe("chunk.dispatch"):
            wires, denses, fy, fu, fv = p_chunk.p_chunk_device(
                ys, us, vs, *self._ref,
                self._upload(np.asarray(qps, np.int32)),
                deblock=c.deblocking, sao=c.sample_adaptive_offset,
                cap=self._chunk_cap, tree=self.inter_split,
                qp_rows=(None if row_plans is None
                         else self._upload(row_plans.astype(np.int32))),
                mesh=self._mesh, graphs=self._graphs,
                **self._tree_kwargs())
        self._ref = (fy, fu, fv)
        host, dense_h, done = wires, denses, None
        if self._copy_stream is not None:
            # start the device-to-host copies now, on the side stream,
            # ordered after this chunk's work only: the wires, and the dense
            # levels a frame over the wire's capacity reads (fetched when it
            # is found, they would wait for the chunks queued behind)
            self._copy_stream.wait_stream(torch.cuda.current_stream(
                self.device))
            with torch.cuda.stream(self._copy_stream):
                host, dense_h = (torch.empty(t.shape, dtype=t.dtype,
                                             pin_memory=True)
                                 for t in (wires, denses))
                host.copy_(wires, non_blocking=True)
                dense_h.copy_(denses, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            wires.record_stream(self._copy_stream)
            denses.record_stream(self._copy_stream)
        return idxs, qps, host, done, dense_h, row_plans

    def _finish_chunk(self, pending, aus, frames):
        """Host side of one dispatched chunk: unpack, decisions, CABAC.
        Returns None, or 'scene' after a scene-cut re-encode."""
        c = self.cfg
        ctu = self.ctu
        prof = self.prof
        idxs, qps, host, done, denses, row_plans = pending
        with prof.probe("chunk.fetch"):
            if done is not None:
                done.synchronize()
            wires_h = host.numpy()
        cap = self._chunk_cap
        for row_i, (fi, qp) in enumerate(zip(idxs, qps)):
            w = p_chunk.unpack_wire(wires_h[row_i], self.ph, self.pw, ctu,
                                    cap, fine=self.inter_cu8)
            if c.reinit_gop_on_scene_change:
                ms = float(w["sad"].astype(np.int64).mean())
                if ms / (ctu * ctu) > SCENE_SAD_PER_PIXEL:
                    # scene cut: this frame and the rest of the chunk are
                    # re-encoded per frame, IDR first (the QPs issued for
                    # the chunks in flight stay counted by rate control)
                    if self._rc:
                        self._rc.on_scene_change()
                    for k in idxs[row_i:]:
                        aus[k] = self.encode_frame(*frames[k],
                                                   force_idr=(k == fi))
                    return "scene"
            cnt = int(w["cnt"][0])
            with prof.probe("chunk.scatter"):
                if cnt <= cap and int(w["cnt2"][0]) <= self._chunk_cap2:
                    lev_y, lev_u, lev_v, nz = (
                        native_backend.scatter_levels_native(
                            w["idx"], w["vals"], min(cnt, cap), self.ph,
                            self.pw))
                else:                               # capacity overflow
                    self.chunk_overflows += 1
                    d = denses[row_i].numpy()
                    npix = self.ph * self.pw
                    lev_y = (d[:npix].reshape(self.ph, self.pw)
                             .astype(np.int32))
                    lev_u = (d[npix:npix + npix // 4]
                             .reshape(self.ph // 2, self.pw // 2)
                             .astype(np.int32))
                    lev_v = (d[npix + npix // 4:npix + npix // 2]
                             .reshape(self.ph // 2, self.pw // 2)
                             .astype(np.int32))
                    nz = None
            g = w["gran"]
            depth_u = np.repeat(np.repeat(w["depth16"], g, 0), g, 1)
            trd_u = np.repeat(np.repeat(w["trd16"], g, 0), g, 1)
            intra_u = np.repeat(np.repeat(w["intra16"], g, 0), g, 1)
            mv_u = np.repeat(np.repeat(w["mv16"], g, 0), g, 1)
            if nz is None:
                nz = _nz_units(lev_y, lev_u, lev_v)
            qp_rows = None if row_plans is None else row_plans[row_i]
            with prof.probe("chunk.decisions"):
                maps = self._tree_maps(depth_u, mv_u, nz, trd_u, intra_u,
                                       (lev_y, lev_u, lev_v), qp_rows)
            sao_info = None
            if c.sample_adaptive_offset:
                pp = w["sao_pp"]
                luma, ml, mu = p_chunk.unpk_params(pp[0])
                cb, _, _ = p_chunk.unpk_params(pp[1])
                cr, _, _ = p_chunk.unpk_params(pp[2])
                sao_info = dict(luma=luma, cb=cb, cr=cr, merge_left=ml,
                                merge_up=mu, sao_luma=True, sao_chroma=True)
            with prof.probe("chunk.entropy"):
                au = assemble.assemble_p_au_from_maps(
                    self.params, maps, poc=self.poc - self.last_idr,
                    slice_qp=qp, sao_info=sao_info)
            aus[fi] = au
            self.last_qp = qp
            self.poc += 1
            self.frame_bytes.append(len(au))
            self._row_bits_from(au, qp_rows)
            if self._rc:
                self._rc.end_frame(len(au) * 8, False)
        return None

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._ref = None
        self._cur_dev = None
        self._graphs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_annex_b(path: str, aus: list[bytes]) -> None:
    """Role of HOMER_enc_write_annex_b_output (hmr_encoder_lib.c:2196):
    AUs already carry start codes; this just concatenates to a file."""
    with open(path, "wb") as f:
        for au in aus:
            f.write(au)
