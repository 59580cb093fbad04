"""Rate control: VBV buffer model with per-frame QP adaptation and
per-CTU-row QP plans (the port's own copy of homerhevc_tpu/rate_control.py:
the same state, the same arithmetic and the same call order give the same
QP trajectory in either package).

Role of the reference's hmr_rate_control.c (:30 init, :89 init_pic, :152
end_pic, :266 per-CTU QP): a VBV-fullness model with I-frame cost
amortization, re-shaped to per-frame QP decisions and per-CTU-row plans,
since the device pipeline is frame-batched and the QP of a frame (and of
each CTU row) is a host-side value fed to the device step.

All state is tiny scalar math on the host, exactly like the reference.
"""

from __future__ import annotations

import math

from .config import BitrateMode, EncoderConfig


class RateControl:
    def __init__(self, cfg: EncoderConfig):
        self.gop_size = cfg.gop_size
        self.cfg = cfg
        self.mode = cfg.bitrate_mode
        self.fps = cfg.frame_rate
        self.avg = cfg.bitrate * 1000.0 / cfg.frame_rate   # bits/frame
        self.vbv_size = cfg.vbv_size * 1000.0              # bits
        self.fullness = cfg.vbv_init * 1000.0
        self.qp = float(cfg.qp)
        self.intra_period = max(cfg.intra_period, 1)
        # I-frame cost amortization (acc_rate/acc_avg, hmr_rate_control.c:152)
        self._i_excess = 0.0
        self._target_last = self.avg
        self._is_idr_last = False
        self._repay_last = 0.0
        self._anchor_qp = None
        self._last_i = None            # (bits, qp) of the last coded I
        self._issued_qp = self.qp
        self._inflight = 0             # QPs issued, bits not yet seen

    # ---------------------------------------------------------- per frame
    def frame_target(self, is_idr: bool, is_b: bool = False) -> float:
        """Target bits for the next frame (hmr_rc_init_pic :89-140; the B
        rule — non-reference B frames get ~avg/2 and anchors 1.5x avg so a
        (P, B) pair still sums to 2x avg — is hmr_rate_control.c:89-140)."""
        if is_idr:
            t = 2.25 * self.avg * math.sqrt(self.intra_period)
            # never ask for more than the buffer can deliver
            t = min(t, self.fullness + self.avg * 0.9)
            return max(t, self.avg)
        if is_b:
            return max(self.avg * 0.5, self.avg * 0.1)
        # P frames repay the I-frame excess over the GOP; with no periodic
        # I (intra_period<=1, e.g. scene-cut IDRs only) amortize over ~1 s
        # of frames instead of dumping it all on the next frame
        n_amort = (self.intra_period - 1 if self.intra_period > 1
                   else max(int(round(self.fps)), 1))
        repay = min(self._i_excess / n_amort, 0.75 * self.avg)
        self._repay_last = repay
        t = (self.avg * 1.5 if self.gop_size >= 2 else self.avg) - repay
        return max(t, self.avg * 0.1)

    def frame_qp(self, is_idr: bool, is_b: bool = False) -> int:
        target = self.frame_target(is_idr, is_b)
        self._target_last = target
        self._is_idr_last = is_idr
        qp = self.qp
        # VBV guardrails: low fullness -> raise QP, high fullness -> lower.
        frac = self.fullness / self.vbv_size if self.vbv_size else 0.5
        if self.mode == BitrateMode.CBR:
            if frac < 0.15:
                qp += 3
            elif frac < 0.3:
                qp += 1
            elif frac > 0.85:
                qp -= 2
            elif frac > 0.7:
                qp -= 1
        else:  # VBR: softer correction
            if frac < 0.1:
                qp += 2
            elif frac > 0.9:
                qp -= 1
        if is_idr:
            # I frames aim at THEIR target, not the P-adapted base: predict
            # this IDR's cost from the last one's (bits, qp) via the
            # 3-QP-per-doubling rule (role of the reference's I/P QP
            # compensation + VBV-clamped I target, hmr_rate_control.c:
            # 89-150). Without this, a scene-cut IDR inherits a base QP
            # the P loop adapted far below the I budget and blows the VBV
            # (measured 2.4x CBR overshoot at 1080p).
            if self._last_i is not None:
                b0, q0 = self._last_i
                qp_i = q0 + 3.0 * math.log2(max(b0, 1.0) / target)
                # VBV pressure applies to I frames too: a scene-cut IDR
                # into a drained buffer must come in coarse
                if frac < 0.15:
                    qp_i += 3
                elif frac < 0.3:
                    qp_i += 1
                qp = max(min(qp_i, qp + 12), qp - 6)
            else:
                qp -= 2
        if is_b:
            # non-reference B: +2 relative to the ANCHOR it references (the
            # base QP may have moved since the anchor was coded; pinning to
            # the anchor keeps the hierarchy ordering even mid-adaptation)
            qp = self._anchor_qp + 2 if self._anchor_qp is not None \
                else qp + 2
        out = int(round(max(0, min(51, qp))))
        if not is_b:
            self._anchor_qp = out
        self._issued_qp = out
        self._inflight += 1
        return out

    def end_frame(self, bits_used: int, is_idr: bool,
                  is_b: bool = False) -> None:
        """VBV update + QP adaptation (hmr_rc_end_pic :152-263)."""
        target = self._target_last
        # adapt the base QP from the log bit-rate error (3 QP ~= 2x bits).
        # The step is capped at +-1 per frame: the chunked device pipeline
        # feeds bits back 8-16 frames late, and a +-3 step under that lag
        # oscillates (measured +-24 QP swings -> alternating near-lossless
        # and starved chunks); the VBV-fullness guardrails in frame_qp are
        # the fast actuator, this integrator only trims.
        # scale by the number of in-flight frames (QPs issued before this
        # feedback arrived): with the chunk pipeline pre-querying 8-16 QPs,
        # an unscaled step applies the same correction that many times
        # over before the next real feedback — the classic lag-oscillation
        err = math.log2(max(bits_used, 1) / max(target, 1))
        gain = 1.0 if self.mode == BitrateMode.CBR else 0.75
        step = max(-1.0, min(1.0, gain * err)) / max(self._inflight, 1)
        self._inflight = max(0, self._inflight - 1)
        # I frames are intentionally over target; adapt on P frames only
        # (B mismatches must not yank the base QP).
        if not is_idr and not is_b:
            self.qp = max(0.0, min(51.0, self.qp + step))
            # the repay budgeted into this frame's target is now spent
            self._i_excess = max(0.0, self._i_excess - self._repay_last)
            self._repay_last = 0.0
        elif is_idr:
            self._i_excess = max(0.0, bits_used - self.avg)
            self._last_i = (float(bits_used), self._issued_qp)
        self.fullness += self.avg - bits_used
        # clamp to the buffer (overflow/underflow handling :246-261)
        self.fullness = max(0.0, min(self.vbv_size, self.fullness))

    def plan_rows(self, base_qp: int, n_rows: int, prev_row_load=None,
                  prev_row_bits=None):
        """Per-CTU-row QP plan (role of hmr_rc_calc_cu_qp,
        hmr_rate_control.c:266-347): row QP from CONSUMED bits vs the
        row's share of the frame target, plus a VBV-fullness corrector —
        re-shaped to the frame-batched pipeline, so "consumed" is the
        previous frame's measured per-row bits (its coefficient-load
        distribution scaled to its real AU size) and the correction feeds
        forward into the next frame's plan.

        Falls back to the load-only +-1 shaping when no bit history
        exists (first P frame after an IDR)."""
        import numpy as np
        qps = np.full(n_rows, float(base_qp))
        if (prev_row_bits is not None and len(prev_row_bits) == n_rows
                and np.sum(prev_row_bits) > 0):
            bits = np.asarray(prev_row_bits, np.float64)
            # expected consumption per row = the uniform share of the
            # frame's actual spend (the frame-level target error is the
            # base-QP loop's job); rows above their share get +QP, below
            # get -QP, with log2 magnitude (3 QP ~= 2x bits)
            expected = max(bits.sum() / n_rows, 1.0)
            err = np.log2(np.maximum(bits, 0.5) / expected)
            qps += np.clip(np.round(1.5 * err), -2, 2)
        elif prev_row_load is not None and len(prev_row_load) == n_rows:
            load = np.asarray(prev_row_load, np.float64)
            mean = max(load.mean(), 1e-9)
            qps += np.where(load > 1.5 * mean, 1,
                            np.where(load < 0.5 * mean, -1, 0))
        # VBV corrector (hmr_rate_control.c:310-340 role): low fullness
        # coarsens every row, high fullness refines
        frac = self.fullness / self.vbv_size if self.vbv_size else 0.5
        if frac < 0.15:
            qps += 1
        elif frac > 0.85:
            qps -= 1
        return np.clip(np.round(qps), 0, 51).astype(np.int32)

    # ------------------------------------------------------- scene change
    def on_scene_change(self) -> None:
        """hmr_rc_change_pic_mode (:49-87): re-target mid-GOP after a scene
        change turned a P into an effectively-intra frame."""
        self._i_excess = max(self._i_excess, self.avg)
