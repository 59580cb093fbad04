"""Stage B of a B frame: the sequential decision walk over decoder-exact
B merge/AMVP lists (ops/inter_b.py), run on the host after the batched
device stage (pipeline/b_torch.py).

The port's own copy of `BFramePlan` and `build_b_plans` from
homerhevc_tpu/pipeline/b_golden.py (numpy only). The golden numpy B
encoder beside them there is not copied: the JAX package keeps it as the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..entropy.syntax import CtuPlan
from ..ops.inter_b import (BMotion, BMotionField, amvp_candidates_b,
                           merge_candidates_b)
from ..ops.inter_golden import mv_bits_fx


@dataclass
class BFramePlan:
    ctu_plans: list
    recon: tuple
    field: BMotionField
    cbf_y_unit: np.ndarray


def build_b_plans(idc_a, mv0_a, mv1_a, lev_y_a, lev_u_a, lev_v_a, recon, *,
                  size: int, poc: int, poc_refs, max_merge_cand: int = 5):
    """Stage B: sequential decode-order merge/AMVP walk over the per-block
    arrays of the device stage (b_torch.b_frame_device)."""
    nby, nbx = idc_a.shape
    h, w = nby * size, nbx * size
    uh, uw = h // 4, w // 4
    units = size // 4
    fld = BMotionField(uh, uw)
    cbf_y_unit = np.zeros((uh, uw), bool)
    plans = []
    rec_y, rec_u, rec_v = recon
    for r in range(nby):
        for c in range(nbx):
            y0, x0 = r * size, c * size
            idc = int(idc_a[r, c])
            mv0 = (int(mv0_a[r, c, 0]), int(mv0_a[r, c, 1]))
            mv1 = (int(mv1_a[r, c, 0]), int(mv1_a[r, c, 1]))
            motion = BMotion(idc != 1, idc != 0, mv0, mv1)
            lev_y = np.asarray(lev_y_a[r, c])
            lev_u = np.asarray(lev_u_a[r, c])
            lev_v = np.asarray(lev_v_a[r, c])
            has_resid = bool(np.any(lev_y) or np.any(lev_u) or np.any(lev_v))

            # decisions against decoder-exact candidate lists
            mcands = merge_candidates_b(fld, x0, y0, size, max_merge_cand)
            mi = next((i for i, cd in enumerate(mcands)
                       if cd.key() == motion.key()), -1)
            merge = mi >= 0
            skip = merge and not has_resid
            mvd0 = mvd1 = (0, 0)
            mvp0 = mvp1 = 0
            if not merge:
                if motion.pf0:
                    am = amvp_candidates_b(fld, x0, y0, size, 0, poc, poc_refs)
                    b0 = mv_bits_fx(motion.mv0[0] - am[0][0],
                                    motion.mv0[1] - am[0][1])
                    b1 = mv_bits_fx(motion.mv0[0] - am[1][0],
                                    motion.mv0[1] - am[1][1])
                    mvp0 = 0 if b0 <= b1 else 1
                    mvd0 = (motion.mv0[0] - am[mvp0][0],
                            motion.mv0[1] - am[mvp0][1])
                if motion.pf1:
                    am = amvp_candidates_b(fld, x0, y0, size, 1, poc, poc_refs)
                    b0 = mv_bits_fx(motion.mv1[0] - am[0][0],
                                    motion.mv1[1] - am[0][1])
                    b1 = mv_bits_fx(motion.mv1[0] - am[1][0],
                                    motion.mv1[1] - am[1][1])
                    mvp1 = 0 if b0 <= b1 else 1
                    mvd1 = (motion.mv1[0] - am[mvp1][0],
                            motion.mv1[1] - am[mvp1][1])

            if merge:
                # decoder uses the merge candidate's full motion
                motion = mcands[mi]
            fld.set_cu(x0, y0, size, motion)
            cbf_y_unit[y0 // 4:(y0 + size) // 4,
                       x0 // 4:(x0 + size) // 4] = bool(np.any(lev_y))

            full = lambda val, dt: np.full((units, units), val, dt)
            plans.append(CtuPlan(
                x0=x0, y0=y0,
                depth_map=full(0, np.int8),
                luma_mode=full(1, np.int8), chroma_mode=full(1, np.int8),
                part_nxn=full(False, bool), tr_depth_map=full(0, np.int8),
                coeff_y=lev_y, coeff_cb=lev_u, coeff_cr=lev_v,
                pred_intra=full(False, bool),
                skip=full(skip, bool),
                merge_flag=full(merge, bool),
                merge_idx=full(max(mi, 0), np.int8),
                mvd=np.broadcast_to(np.array(mvd0, np.int32),
                                    (units, units, 2)).copy(),
                mvp_idx=full(mvp0, np.int8),
                inter_dir=full(idc, np.int8),
                mvd_l1=np.broadcast_to(np.array(mvd1, np.int32),
                                       (units, units, 2)).copy(),
                mvp_idx_l1=full(mvp1, np.int8),
            ))

    return BFramePlan(plans, (rec_y, rec_u, rec_v), fld, cbf_y_unit)
