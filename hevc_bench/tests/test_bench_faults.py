"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card is skipped, the rest of a run is driven on
the CPU at a small size, once for each fault a one-chip encoder cell can
have (a step that returns its state unchanged, half of the frames left
out, an AU altered where it is produced) and for the decision fault (the
integer motion search handing back the zero vector: a legal stream that
decodes to the program's own planes). A sound run passes every check."""

import time

import pytest

from hevc_bench import check, control, harness

SMALL = {"ldp_1080p_fastest": dict(width=384, height=256)}
CELLS = ["ldp_1080p_fastest.batch", "ldp_1080p_fastest.live"]
EXACT = ("frames_missing", "aus_undecodable", "stream_mismatches",
         "recon_mismatch", "idr_unexpected")


def run_cell(root, cell, seed=2 ** 31 + 77):
    m = harness.Manifest(root)
    conf = m.cell(cell)["config"]
    run = harness.drive(m, cell, seed, 0.5, False,
                        t_start=time.perf_counter(), device="cpu",
                        overrides=SMALL[conf])
    checks, failed = check.verify(run, harness.check_unit(run, seed))
    return run, checks, failed


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(root, cell):
    run, checks, failed = run_cell(root, cell)
    assert failed == 0
    for k in EXACT:
        if k in checks:
            assert checks[k]["value"] == 0, (k, checks, run.check_notes)
    assert "idr_unexpected" in checks
    assert harness.is_correct(checks), checks


def _state_unchanged(monkeypatch):
    """The P stage hands back the reference it was given."""
    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.pipeline import p_chunk
    orig = p_chunk.p_chunk_device

    def chunk(ys, us, vs, ref_y, ref_u, ref_v, *a, **k):
        wires, denses, *_ = orig(ys, us, vs, ref_y, ref_u, ref_v, *a, **k)
        return wires, denses, ref_y, ref_u, ref_v
    monkeypatch.setattr(p_chunk, "p_chunk_device", chunk)
    orig_ref = HomerEncoder._p_ref_and_sao

    def keep(self, out, qp):
        old = self._ref
        info = orig_ref(self, out, qp)
        self._ref = old
        return info
    monkeypatch.setattr(HomerEncoder, "_p_ref_and_sao", keep)


def _half_left_out(monkeypatch):
    """Half of the frames of every call come back without an AU."""
    from homerhevc_tpu_torch.api import HomerEncoder
    orig_frames = HomerEncoder.encode_frames
    orig_frame = HomerEncoder.encode_frame
    calls = [0]

    def frames(self, fr, **k):
        aus = orig_frames(self, fr, **k)
        return aus[:len(aus) // 2] + [None] * (len(aus) - len(aus) // 2)

    def frame(self, *a, **k):
        au = orig_frame(self, *a, **k)
        calls[0] += 1
        return au if calls[0] % 2 else b""
    monkeypatch.setattr(HomerEncoder, "encode_frames", frames)
    monkeypatch.setattr(HomerEncoder, "encode_frame", frame)


def _au_altered(monkeypatch):
    """One byte of every P AU altered where the AU is assembled."""
    from homerhevc_tpu_torch.pipeline import assemble
    orig = assemble.assemble_p_au_from_maps

    def altered(*a, **k):
        au = bytearray(orig(*a, **k))
        au[len(au) * 2 // 3] ^= 0x24
        return bytes(au)
    monkeypatch.setattr(assemble, "assemble_p_au_from_maps", altered)


def _zero_vectors(monkeypatch):
    """The integer motion search hands back the zero vector."""
    control.plant_zero_vectors(monkeypatch.setattr)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out, "au_altered": _au_altered,
          "zero_vectors": _zero_vectors}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    run, checks, failed = run_cell(root, cell)
    assert not harness.is_correct(checks), checks
    if fault == "zero_vectors":
        # only the decision numbers see it
        over = {k for k, v in checks.items() if v["value"] > v["limit"]}
        assert "p_pred_excess" in over and over <= {
            "p_pred_excess", "p_pred_mae", "p_bits_per_pixel"}, checks
