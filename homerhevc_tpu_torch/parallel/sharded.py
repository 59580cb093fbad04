"""Band sharding of the fixed-CU P stage over several devices.

Port of homerhevc_tpu/parallel/sharded.py. Two axes, as there:
  * 'gop'  — lanes: each encodes its own frame (the reference's
             `num_enc_engines` engine threads, hmr_encoder_lib.c:3132);
  * 'band' — horizontal bands of one frame, each computed on its own device.
             A band's reference plane is extended by the rows the motion
             search and the 8-tap filter can reach (the halo), copied from
             the devices of the bands above and below (the reference's WPP
             row threads and their reference-progress semaphores,
             hmr_encoder_lib.c:2849-2987, :2393-2403).

A mesh is a (G, nb) nested sequence of torch devices that one process
drives, as JAX's single-controller mesh is; a device may be named several
times, so a mesh also runs on one card or on the CPU. Band outputs equal the
single-device stage `p_torch.p_frame_device` element for element: the halo
carries exactly the rows the whole-frame computation reads, and a band at the
picture's top or bottom repeats the picture's edge row, as the whole-frame
edge padding does.

The session (api.HomerEncoder with `mesh=` or `wpp_shards`) runs every
fixed-CU P stage through `band_p_stage` / `p_frame_bands`: one lane, bands
of whole CTU rows, as even as the picture's height allows.
"""

from __future__ import annotations

import torch

from ..device import edge_pad
from ..pipeline import p_torch

PAD = p_torch.PAD

# the seven outputs of the sharded step, in the reference's order
OUTPUTS = ("mvs", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u", "recon_v")


def halo_rows(search: int) -> int:
    """Rows above and below a band that the fixed-CU stage can read: the
    search range plus the 8-tap filter support, rounded up to 4, at most
    PAD. Beyond them the band is edge-padded up to PAD, so the in-band
    indexing is the whole frame's; that outer ring is never read."""
    return min(PAD, ((search + 8 + 3) // 4) * 4)


def _halo_extend(bands, pad: int) -> list:
    """Every band (rows, W), each on its own device, extended by `pad` rows
    above and below: the rows of the picture's edge-padded plane there. A
    band taller than `pad` takes them from its two neighbours; a shorter
    neighbour passes on what it has and the next band beyond gives the rest;
    past the picture's top or bottom the edge row is repeated.

    Rows go device to device with `.to(device, non_blocking=True)`, never
    through the host. A copy between two CUDA devices runs on the source's
    current stream after an event of the destination's current stream, and
    the destination's current stream waits for it in turn (PyTorch's
    cross-device copy), so each band's work is ordered after its halo."""
    top_edge, bottom_edge = bands[0][:1], bands[-1][-1:]
    out = []
    for i, band in enumerate(bands):
        dev = band.device

        def take(order, last: bool):
            parts, need = [], pad
            for j in order:
                if need == 0:
                    break
                k = min(need, bands[j].shape[0])
                rows = bands[j][-k:] if last else bands[j][:k]
                parts.append(rows.to(dev, non_blocking=True))
                need -= k
            return parts, need

        above, miss_top = take(range(i - 1, -1, -1), last=True)
        below, miss_bottom = take(range(i + 1, len(bands)), last=False)
        top = top_edge.to(dev, non_blocking=True).expand(miss_top, -1)
        bottom = bottom_edge.to(dev, non_blocking=True).expand(miss_bottom, -1)
        out.append(torch.cat([top, *above[::-1], band, *below, bottom]))
    return out


def _band_stage(cur, ref, qp, *, B: int, search: int, me_precision: int,
                sign_hiding: bool, kernels: bool) -> list:
    """The fixed-CU P stage on the bands of one frame. `cur` and `ref` hold
    per band its (y, u, v) uint8 planes on the band's device. Returns the
    per-band results of p_torch._p_stage (each on its band's device).

    Besides the reference rows, a band reads one thing of the band above:
    the refined MVs of its last block row, the merge candidate `top` of the
    band's first row. The bands run top to bottom and each passes that row
    on (device to device), so the merge decisions are the whole frame's.
    (The reference's band function gives the first row no top candidate,
    and so differs from its single-device stage where a block there would
    merge with the block above: ROADMAP, faults of the reference.)"""
    halo = halo_rows(search)
    e = PAD - halo
    ext = [_halo_extend([r[k].to(torch.int16) for r in ref],
                        halo if k == 0 else halo // 2) for k in range(3)]
    outs, top = [], None
    for b, (y, u, v) in enumerate(cur):
        ry = edge_pad(ext[0][b], e, PAD)
        ru = edge_pad(ext[1][b], e // 2, PAD // 2)
        rv = edge_pad(ext[2][b], e // 2, PAD // 2)
        out = p_torch._p_stage(
            y, u, v, ry, ru, rv, B=B, qp=qp, search=search,
            me_precision=me_precision, sign_hiding=sign_hiding,
            kernels=kernels,
            top_mv=None if top is None else top.to(y.device,
                                                   non_blocking=True))
        top = out["amvp"][-1]
        outs.append(out)
    return outs


def _cut(plane, rows, devs) -> list:
    """A plane cut into consecutive bands of `rows` rows, band b put on
    devs[b]."""
    out, r0 = [], 0
    for n, dev in zip(rows, devs):
        out.append(plane[r0:r0 + n].to(dev, non_blocking=True))
        r0 += n
    return out


def band_heights(ctu_rows: int, nb: int) -> list:
    """CTU rows per band when `ctu_rows` are cut into at most `nb` bands as
    evenly as possible, the first bands taking the extra rows (no empty
    band: fewer rows than bands gives one band per row)."""
    return [ctu_rows // nb + (b < ctu_rows % nb)
            for b in range(min(nb, ctu_rows))]


def band_p_stage(devs, y, u, v, ref_y, ref_u, ref_v, *, B: int, qp,
                 search: int, me_precision: int, sign_hiding: bool = False,
                 kernels: bool = True) -> dict:
    """p_torch._p_stage's result for one frame whose fixed-CU stage runs in
    bands on `devs` (the band axis of a mesh; its first device holds the
    planes and the result). Frame and reference are uint8 planes, not
    padded; bands are whole B-rows, cut by band_heights."""
    rows = [n * B for n in band_heights(y.shape[0] // B, len(devs))]
    devs = devs[:len(rows)]
    cur = list(zip(*(_cut(p, [n >> (k > 0) for n in rows], devs)
                     for k, p in enumerate((y, u, v)))))
    ref = list(zip(*(_cut(p, [n >> (k > 0) for n in rows], devs)
                     for k, p in enumerate((ref_y, ref_u, ref_v)))))
    outs = _band_stage(cur, ref, qp, B=B, search=search,
                       me_precision=me_precision, sign_hiding=sign_hiding,
                       kernels=kernels)
    dst = y.device

    def cat(key):
        return torch.cat([o[key].to(dst, non_blocking=True) for o in outs])

    return p_torch.fixed_result(*(cat(k) for k in (
        "mvs", "sad", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u",
        "recon_v")))


def p_frame_bands(devs, y, u, v, ref_y, ref_u, ref_v, *, B: int, qp,
                  search: int, me_precision: int, deblock: bool = False,
                  sign_hiding: bool = False, kernels: bool = True) -> dict:
    """p_torch.p_frame_device with the stage in bands on `devs`; the loop
    filter runs on the first device, which holds the planes."""
    result = band_p_stage(devs, y, u, v, ref_y, ref_u, ref_v, B=B, qp=qp,
                          search=search, me_precision=me_precision,
                          sign_hiding=sign_hiding, kernels=kernels)
    return p_torch.with_loop_filter(result, qp, B) if deblock else result


def make_p_frame_sharded(mesh, *, B: int, search: int, me_precision: int,
                         sign_hiding: bool = False, kernels: bool = True):
    """The band- and lane-sharded P stage on a (G, nb) mesh of devices.

    The returned step takes (G, H, W) uint8 frames and references (chroma
    (G, H/2, W/2)) and one QP per lane, and returns the reference's seven
    outputs (mvs, lev_y, lev_u, lev_v, recon_y, recon_u, recon_v), lane
    axis first and block rows next, on the mesh's first device. Lane g's
    frame is cut into nb equal bands, band b computed on mesh[g][b]. Raises
    ValueError where the reference's shard_map asserts: H not divisible by
    nb, a band height that is not a multiple of B, a band shorter than the
    halo."""
    mesh = [[torch.device(d) for d in row] for row in mesh]
    nb = len(mesh[0])
    if not nb or any(len(row) != nb for row in mesh):
        raise ValueError(f"mesh rows must hold one device per band: "
                         f"{[len(row) for row in mesh]}")
    halo = halo_rows(search)

    def step(y, u, v, ry, ru, rv, qp):
        G, H, _ = y.shape
        if G != len(mesh):
            raise ValueError(f"{G} lanes on a mesh of {len(mesh)} rows")
        if H % nb:
            raise ValueError(f"height {H} is not divisible by {nb} bands")
        hb = H // nb
        if hb % B:
            raise ValueError(f"band height {hb} is not a multiple of B={B}")
        if hb < halo:
            raise ValueError(f"band height {hb} < halo {halo}; use fewer "
                             "bands")
        lanes = []
        for g, devs in enumerate(mesh):
            cur = list(zip(*(_cut(p[g], [hb >> (k > 0)] * nb, devs)
                             for k, p in enumerate((y, u, v)))))
            ref = list(zip(*(_cut(p[g], [hb >> (k > 0)] * nb, devs)
                             for k, p in enumerate((ry, ru, rv)))))
            lanes.append(_band_stage(cur, ref, qp[g], B=B, search=search,
                                     me_precision=me_precision,
                                     sign_hiding=sign_hiding,
                                     kernels=kernels))
        dst = mesh[0][0]
        return tuple(
            torch.stack([torch.cat([o[k].to(dst, non_blocking=True)
                                    for o in outs]) for outs in lanes])
            for k in OUTPUTS)

    return step


def dryrun(mesh, *, B: int = 16, frames_hw=(128, 64), search: int = 8):
    """One sharded P step on small shapes (synth_clip frames, one clip per
    lane, QP 32), held against the single-device stage on every lane and
    every output; True, or AssertionError."""
    import numpy as np

    from ..utils.synth import synth_clip

    mesh = [[torch.device(d) for d in row] for row in mesh]
    G = len(mesh)
    h, w = frames_hw
    fs = [list(synth_clip(w, h, 2, seed=g)) for g in range(G)]
    dev = mesh[0][0]
    refs = [torch.as_tensor(np.stack([fs[g][0][i] for g in range(G)]),
                            device=dev) for i in range(3)]
    curs = [torch.as_tensor(np.stack([fs[g][1][i] for g in range(G)]),
                            device=dev) for i in range(3)]
    step = make_p_frame_sharded(mesh, B=B, search=search, me_precision=2)
    got = step(*curs, *refs, [32] * G)
    for g in range(G):
        single = p_torch.p_frame_device(
            *(p[g] for p in curs), *(p[g] for p in refs), B=B, qp=32,
            search=search, me_precision=2)
        for k, out in zip(OUTPUTS, got):
            if not torch.equal(out[g], single[k]):
                raise AssertionError(f"sharded {k} diverges from "
                                     f"single-device on lane {g}")
    return True
