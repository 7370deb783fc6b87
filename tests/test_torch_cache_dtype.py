"""Compressed distance fields (match.cache_dtype bf16/u16/u8) of the port
against the JAX package on the CPU.

Tiers: codes bit-equal (bf16 by bit pattern, including the at-cap round
up for z = 0.7); dequantized values and at-cap predicates bit-equal;
coarse field on codes bit-equal; scores on the same candidates with the
same finite pattern, f64 within rtol 1e-12 and f32 within rtol/atol 2e-6
(summation order), the pruned scorer on its accepted candidates; a u16
rollout with identical decisions, poses within 1e-6 px (the f64 rollout
tier of test_torch_loop.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu.match import associate as jas
from lsdtpu.runtime import loop as jloop
from lsdtpu.scan.featurize import featurize as jfeat
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.match import associate as tas
from lsdtpu_torch.runtime import loop as tloop

from torch_parity import frames, np_, port_candidates, scene

MODES = ("bf16", "u16", "u8")
TORCH_DT = {np.float32: torch.float32, np.float64: torch.float64}


def _bits(x):
    """Integer view of a code array (bf16 by its bit pattern)."""
    x = np_(x) if not torch.is_tensor(x) else x
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().astype(np.int64)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.astype(np.int64)


def _field(seed=3, shape=(61, 77)):
    rng = np.random.default_rng(seed)
    cache = np.minimum(rng.uniform(0.0, 1.4, shape), 1.0)
    # values at and around the caps the tests use
    cache[0, :8] = [0.0, 0.35, 0.69921875, 0.7, 0.7000001, 0.999999, 1.0,
                    1.0 - 0.5 / 65535]
    return cache


@pytest.mark.parametrize("z", [1.0, 0.7, 2.0])
@pytest.mark.parametrize("mode", MODES)
def test_codes_and_dequant_bit_equal(mode, z):
    cache = _field()
    want = jas.quantize_cache(cache, mode, z)
    got = tas.quantize_cache(torch.as_tensor(cache), mode, z)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))
    for dt in (np.float32, np.float64):
        jv, jc = jas._dequant(jnp.asarray(want).reshape(-1), dt, z)
        tv, tc = tas.dequant(got.reshape(-1), TORCH_DT[dt], z)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        # every at/above-cap cell keeps the predicate
        assert np.asarray(jc)[cache.reshape(-1) >= np.float32(z)].all()


def test_bf16_cap_rounds_up_for_unrepresentable_cap():
    """bf16(0.7) = 0.69921875 < 0.7: at-cap cells take the next bf16 up,
    so the predicate v >= z holds (test_cache_dtype.py's counterpart)."""
    z = 0.7
    q = tas.quantize_cache(torch.tensor([[0.0, 0.35, z, z + 0.01]]), "bf16", z)
    assert q.dtype == torch.bfloat16
    vals, at_cap = tas.dequant(q.reshape(-1), torch.float32, z)
    assert at_cap.tolist() == [False, False, True, True]
    assert float(q[0, 2]) == 0.703125


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", [16, 8])
def test_coarse_field_on_codes_bit_equal(mode, block):
    codes = jas.quantize_cache(_field(block, (200, 260)), mode, 1.0)
    want = jas.coarse_field(codes, block)
    got = tas.coarse_field(tas.quantize_cache(
        torch.as_tensor(_field(block, (200, 260))), mode, 1.0), block)
    assert got.dtype == tas.quantize_cache(torch.zeros(1, 1), mode).dtype
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


def _frame_case(seed, f, dtype, last):
    """One frame's candidates and pixels of the fuzz scene ``seed`` (JAX
    features, the same values handed to the port)."""
    ds, art = scene(seed)
    fr = frames(seed, dtype)
    p = ds.param
    fs = jfeat(*(jnp.asarray(fr[k][f]) for k in ("ranges", "angles", "valid",
                                                   "n")),
               jnp.asarray(p.resol, dtype), jnp.asarray(p.ori_x, dtype),
               jnp.asarray(p.ori_y, dtype))
    ml = np.zeros((64, 10), dtype)
    ml[:len(art.lines_info)] = art.lines_info
    mm = np.arange(64) < len(art.lines_info)
    jc = jas.generate_candidates(
        fs.lines, fs.lines_mask, jnp.asarray(ml), jnp.asarray(mm),
        jnp.floor(fs.lidar_pos + 0.5), jnp.asarray(last, dtype),
        max_candidates=512)
    return jc, fs, art.map_cache


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-12, 1e-12),
                                             (np.float32, 2e-6, 2e-6)])
@pytest.mark.parametrize("mode", MODES)
def test_scores_match_jax(mode, dtype, rtol, atol):
    """The plain scorer (all live candidates) and the pruned scorer on
    a compressed field."""
    jc, fs, cache = _frame_case(1, 0, dtype, (-1.0, -1.0, 0.0))
    jcodes = jas.quantize_cache(cache, mode, 1.0)
    tcodes = tas.quantize_cache(torch.as_tensor(cache), mode, 1.0)
    cand = port_candidates(jc)
    pix = torch.as_tensor(np_(fs.pixels))
    pm = torch.as_tensor(np_(fs.pixels_mask))
    want = np_(jas.score_candidates(jc, fs.pixels, fs.pixels_mask, jcodes))
    got = np_(tas.score_candidates(cand, pix, pm, tcodes))
    assert got.dtype == dtype
    fin = np.isfinite(want)
    assert fin.sum() > 10
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)
    # pruned: the same accepted candidates and scores
    wp = np_(jas.score_candidates_pruned(jc, fs.pixels, fs.pixels_mask,
                                         jcodes, jas.coarse_field(jcodes)))
    gp = np_(tas.score_candidates(cand, pix, pm, tcodes,
                                  coarse=tas.coarse_field(tcodes),
                                  prune_accept=3.0))
    acc = wp < 3.0
    assert acc.any()
    np.testing.assert_array_equal(gp < 3.0, acc)
    np.testing.assert_allclose(gp[acc], wp[acc], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(gp[acc], got[acc])


@pytest.mark.parametrize("mode", ["u16", "u8"])
def test_compressed_rollout_matches_jax(mode):
    ds, art = scene(0)
    p = ds.param
    args = (art.lines_info, art.map_cache, p.resol, p.ori_x, p.ori_y)
    jctx = jloop.make_map_context(*args, dtype=np.float64, cache_dtype=mode)
    tctx = tloop.make_map_context(*args, dtype=np.float64, cache_dtype=mode,
                                  device="cpu")
    assert tctx.cache.dtype == {"u16": torch.uint16,
                                "u8": torch.uint8}[mode]
    np.testing.assert_array_equal(_bits(tctx.cache), _bits(np.asarray(
        jctx.cache)))
    fr = frames(0)
    jcfg = dataclasses.replace(jloop.DEFAULT, match=dataclasses.replace(
        jloop.DEFAULT.match, cache_dtype=mode))
    tcfg = dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, cache_dtype=mode))
    want = jax.tree.map(np.asarray, jloop.run_sequence(fr, jctx, jcfg))
    got = {k: np_(v) for k, v in
           tloop.run_sequence(fr, tctx, tcfg, device="cpu").items()}
    for k in ("n_candidates", "candidate_overflow", "relock_deferred"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    assert fin.all()
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0, atol=1e-6)


def test_storage_types_the_kernel_lacks_raise():
    """The scorer takes the working float type, bf16 and u16/u8 codes;
    any other field type raises (a float16 field, an f32 field under
    f64 scoring, int16 codes)."""
    from lsdtpu_torch.ops import score as sc
    feats = torch.zeros((6, 4), dtype=torch.float64)
    v = torch.zeros(8, dtype=torch.float64)
    n = torch.tensor(0, dtype=torch.int32)
    for bad in (torch.float16, torch.float32, torch.int16):
        with pytest.raises(TypeError, match="field"):
            sc.score_partials(feats, None, n, v, v, n,
                              torch.zeros((4, 4), dtype=bad), 0, 4, 4, 1.0,
                              10.0, 1.0)
