"""Device primitives of the torch port against the JAX package, on the CPU:
integer transforms, quantisation and sign-bit hiding, intra prediction,
deblocking and SAO (statistics, torch derivation, application).

Inputs are made from a seed with numpy and handed to both. Tolerance: exact
equality everywhere (all of this is integer arithmetic).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_tpu import tables as np_tables
from homerhevc_tpu.ops import deblock as jdbk
from homerhevc_tpu.ops import intra as jintra
from homerhevc_tpu.ops import quant as jquant
from homerhevc_tpu.ops import sao as jsao
from homerhevc_tpu.ops import transforms as jtx
from homerhevc_tpu_torch.ops import deblock as tdbk
from homerhevc_tpu_torch.ops import intra as tintra
from homerhevc_tpu_torch.ops import quant as tquant
from homerhevc_tpu_torch.ops import sao as tsao
from homerhevc_tpu_torch.ops import transforms as ttx
from test_torch_ctu64 import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def _jit(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


def J(fn, **static):
    """The JAX reference function jitted with its static arguments bound,
    cached: one compile per call shape instead of op-by-op dispatch."""
    return _jit(fn, tuple(sorted(static.items())))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _smooth(rng, h, w):
    b = np.cumsum(np.cumsum(rng.integers(-3, 4, (h, w)), 0), 1)
    return np.clip(128 + b // 4, 0, 255).astype(np.int32)


@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
def test_transforms(n, dst):
    rng = np.random.default_rng(n + dst)
    res = rng.integers(-255, 256, (6, n, n)).astype(np.int32)
    coeff = rng.integers(-32768, 32768, (6, n, n)).astype(np.int32)
    _eq(J(jtx.forward_transform, is_dst=dst)(jnp.asarray(res)),
        ttx.forward_transform(torch.as_tensor(res), is_dst=dst))
    _eq(J(jtx.inverse_transform, is_dst=dst)(jnp.asarray(coeff)),
        ttx.inverse_transform(torch.as_tensor(coeff), is_dst=dst))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_intra", [True, False])
def test_quantize_dequantize(n, is_intra):
    rng = np.random.default_rng(n)
    log2 = n.bit_length() - 1
    coeff = rng.integers(-32767, 32768, (5, n, n)).astype(np.int32)
    qps = rng.integers(0, 52, (5,)).astype(np.int32)     # per-block QP
    for qp in (0, 32, 51, qps):
        lj = J(jquant.quantize, log2_size=log2, is_intra=is_intra)(
            jnp.asarray(coeff), jnp.asarray(qp))
        lt = tquant.quantize(torch.as_tensor(coeff),
                             qp if isinstance(qp, int)
                             else torch.as_tensor(qp), log2,
                             is_intra=is_intra)
        _eq(lj, lt)
        qt = qp if isinstance(qp, int) else torch.as_tensor(qp)
        _eq(J(jquant.dequantize, log2_size=log2)(lj, jnp.asarray(qp)),
            tquant.dequantize(lt, qt, log2))


@pytest.mark.parametrize("n,scan_idx", [(4, 0), (4, 1), (4, 2), (8, 0),
                                        (8, 1), (8, 2), (16, 0), (32, 0)])
def test_sign_bit_hiding(n, scan_idx):
    rng = np.random.default_rng(100 + n + scan_idx)
    log2 = n.bit_length() - 1
    coeff = rng.integers(-2000, 2001, (12, n, n)).astype(np.int32)
    # a per-block QP (rate control's row QPs), also over blocks split in
    # two TBs each, as the quadtree P stage codes them
    row_qps = rng.integers(20, 40, (6,)).astype(np.int32)
    for qp, shape in ((22, (12,)), (37, (12,)), (row_qps, (6, 2))):
        c = coeff.reshape(shape + (n, n))
        qj = qp if isinstance(qp, int) else jnp.asarray(qp)
        lev = np.asarray(J(jquant.quantize, log2_size=log2, is_intra=True)(
            jnp.asarray(c), qj))
        want = J(jquant.sign_bit_hiding, log2_size=log2, scan_idx=scan_idx)(
            jnp.asarray(lev), jnp.asarray(c), qj)
        got = tquant.sign_bit_hiding(
            torch.as_tensor(lev.copy()), torch.as_tensor(c),
            qp if isinstance(qp, int) else torch.as_tensor(qp), log2,
            scan_idx=scan_idx)
        _eq(want, got)
        assert (np.asarray(want) != lev).any()   # SBH changed something


def _refs(rng, n, N, smooth):
    if smooth:                                     # strong smoothing fires
        base = rng.integers(60, 200, (N, 1))
        top = np.clip(base + np.arange(2 * n) // 8, 0, 255)
        left = np.clip(base + np.arange(2 * n) // 9, 0, 255)
        cor = base[:, 0]
    else:
        top = rng.integers(0, 256, (N, 2 * n))
        left = rng.integers(0, 256, (N, 2 * n))
        cor = rng.integers(0, 256, (N,))
    hl = np.array([True, False, True, False] * (N // 4))
    ht = np.array([True, True, False, False] * (N // 4))
    return [a.astype(np.int32) for a in (top, left, cor)] + [hl, ht]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("c_idx", [0, 1])
def test_intra_prediction(n, c_idx):
    rng = np.random.default_rng(n * 10 + c_idx)
    N = 8
    m = rng.integers(0, 35, (N,)).astype(np.int32)
    prep = jax.jit(jax.vmap(lambda t, l, c, a, b: jintra.prepare_refs(
        t, l, c, a, b, size=n, c_idx=c_idx, strong_smoothing=True)))
    all_modes = jax.jit(jax.vmap(lambda *r: jintra.predict_all_modes(
        *r, size=n, c_idx=c_idx)))
    one_mode = jax.jit(jax.vmap(lambda *r: jintra.predict_one_mode(
        *r[:6], r[6], size=n, c_idx=c_idx)))
    for smooth in (False, True):
        raw = _refs(rng, n, N, smooth)
        rj = prep(*map(jnp.asarray, raw))
        rt = tintra.prepare_refs(*map(torch.as_tensor, raw), size=n,
                                 c_idx=c_idx, strong_smoothing=True)
        for a, b in zip(rj, rt):
            _eq(a, b)
        _eq(all_modes(*rj),
            tintra.predict_all_modes(*rt, size=n, c_idx=c_idx))
        _eq(one_mode(*rj, jnp.asarray(m)),
            tintra.predict_one_mode(*rt, torch.as_tensor(m), size=n,
                                    c_idx=c_idx))


@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_deblock(kind):
    rng = np.random.default_rng(5)
    H, W = 96, 128
    y, u, v = (_smooth(rng, H, W), _smooth(rng, H // 2, W // 2),
               _smooth(rng, H // 2, W // 2))
    if kind == "inter":
        mvs = rng.integers(-20, 20, (3, 4, 2)).astype(np.int32)
        cbf = rng.integers(0, 2, (3, 4)).astype(bool)
        bj = J(jdbk.inter_bs_from_blocks, B=32, xp=jnp)(jnp.asarray(mvs),
                                                        jnp.asarray(cbf))
        bt = tdbk.inter_bs_from_blocks(torch.as_tensor(mvs),
                                       torch.as_tensor(cbf), 32)
    else:
        du = rng.integers(0, 3, (H // 4, W // 4)).astype(np.int32)
        bj = J(jdbk.intra_bs_from_depth_units, xp=jnp)(jnp.asarray(du))
        bt = tdbk.intra_bs_from_depth_units(torch.as_tensor(du))
    for a, b in zip(bj, bt):
        _eq(a, b)
    qpm = rng.integers(20, 45, (H // 4, W // 4)).astype(np.int32)
    fj = J(jdbk.deblock_frame, xp=jnp)(*map(jnp.asarray, (y, u, v)),
                                       bs_v=bj[0], bs_h=bj[1],
                                       qp_map=jnp.asarray(qpm))
    ft = tdbk.deblock_frame(*map(torch.as_tensor, (y, u, v)), bs_v=bt[0],
                            bs_h=bt[1], qp_map=torch.as_tensor(qpm))
    for a, b, x in zip(fj, ft, (y, u, v)):
        _eq(a, b)
    assert (np.asarray(fj[0]) != y).any()        # the filter did something


@pytest.fixture(scope="module")
def sao_case():
    rng = np.random.default_rng(9)
    H, W = 96, 128
    shapes = ((H, W, 32), (H // 2, W // 2, 16), (H // 2, W // 2, 16))
    orig = [_smooth(rng, h, w) for h, w, _ in shapes]
    rec = [np.clip(o + rng.integers(-6, 7, o.shape), 0, 255)
           for o in orig]
    sj = [J(jsao._stats_device_one, ctu=c, xp=jnp)(jnp.asarray(o),
                                                   jnp.asarray(r))
          for o, r, (_, _, c) in zip(orig, rec, shapes)]
    st = [tsao.stats_one(torch.as_tensor(o), torch.as_tensor(r), c)
          for o, r, (_, _, c) in zip(orig, rec, shapes)]
    return rec, [c for _, _, c in shapes], sj, st


def test_sao_stats(sao_case):
    _, _, sj, st = sao_case
    for a, b in zip(sj, st):
        for x, y in zip(a, b):
            _eq(x, y)


@pytest.mark.parametrize("qp", [22, 32, 40])
def test_sao_derive_and_apply(sao_case, qp):
    rec, ctus, sj, st = sao_case
    qpc = np_tables.chroma_qp_from_luma(qp)
    dj = J(jsao.derive_all_from_stats, xp=jnp, slice_p=True)(
        *sj, jnp.int32(qp), jnp.int32(qpc))
    dt = tsao.derive_all_from_stats(
        *st, torch.tensor(qp, dtype=torch.int32),
        torch.tensor(qpc, dtype=torch.int32), slice_p=True)
    for i in range(3):
        assert set(dj[i]) == set(dt[i])
        for k in dj[i]:
            _eq(dj[i][k], dt[i][k])
    _eq(dj[3], dt[3])
    _eq(dj[4], dt[4])
    for r, par_j, par_t, c in zip(rec, dj[:3], dt[:3], ctus):
        _eq(J(jsao.apply_sao, ctu=c, xp=jnp)(jnp.asarray(r), par_j),
            tsao.apply_sao(torch.as_tensor(r), par_t, c))
