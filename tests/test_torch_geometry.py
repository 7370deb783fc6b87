"""lsdtpu_torch.geometry against lsdtpu.geometry (f64, CPU).

Tier: bitwise, except the transcendental functions - XLA's and torch's
CPU sin/cos/arctan differ by 1 ulp on ~0.1-0.2% of f64 inputs, so those
are held to 2 ulp; c_round is bitwise on exact halves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsdtpu import geometry as jgeo
from lsdtpu_torch import geometry as tgeo

from torch_parity import np_


def _rand(seed, n=4096, scale=400.0):
    return np.random.default_rng(seed).uniform(-scale, scale, n)


@pytest.mark.parametrize("name", ["sind", "cosd", "atand"])
def test_trig_within_two_ulp(name):
    x = _rand(0)
    want = np_(getattr(jgeo, name)(jnp.asarray(x)))
    got = np_(getattr(tgeo, name)(torch.as_tensor(x)))
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= 2 * ulp)


def test_c_round_bitwise_on_halves():
    halves = np.arange(-50, 50) + 0.5
    x = np.concatenate([halves, np.nextafter(halves, 0),
                        np.nextafter(halves, np.inf), _rand(1), [0.0, -0.0,
                                                                0.49999999999999994]])
    want = np_(jgeo.c_round(jnp.asarray(x)))
    got = np_(tgeo.c_round(torch.as_tensor(x)))
    np.testing.assert_array_equal(got, want)
    # half away from zero, unlike torch.round's half to even
    np.testing.assert_array_equal(np_(tgeo.c_round(torch.tensor(
        [0.5, 1.5, 2.5, -0.5, -2.5]))), [1.0, 2.0, 3.0, -1.0, -3.0])


def test_c_round_f32_just_below_half():
    # roundf-style rounding differs here: v + 0.5 rounds up to 1.0
    v = np.float32(0.49999997)
    got = np_(tgeo.c_round(torch.tensor([v, -v])))
    want = np_(jgeo.c_round(jnp.asarray(np.array([v, -v]))))
    np.testing.assert_array_equal(got, want)


def test_sqrt_correctly_rounded():
    x = np.abs(_rand(2, scale=1e4))
    np.testing.assert_array_equal(np_(tgeo.sqrt(torch.as_tensor(x))),
                                  np.sqrt(x))
    np.testing.assert_array_equal(np_(tgeo.sqrt(torch.tensor(32.0,
                                                             dtype=torch.float64))),
                                  np.sqrt(32.0))


def test_wrap_deg_bitwise():
    x = np.concatenate([_rand(3, scale=1000.0),
                        [-540.0, -180.0, 0.0, 180.0, 360.0, 540.0]])
    np.testing.assert_array_equal(np_(tgeo.wrap_deg(torch.as_tensor(x))),
                                  np_(jgeo.wrap_deg(jnp.asarray(x))))


def test_normalized_line_direction_and_lines_info():
    rng = np.random.default_rng(4)
    e = rng.integers(-20, 20, (512, 4)).astype(np.float64)  # hits dx/dy == 0
    jt = [jnp.asarray(e[:, i]) for i in range(4)]
    tt = [torch.as_tensor(e[:, i]) for i in range(4)]
    want = np_(jgeo.normalized_line_direction(*jt))
    got = np_(tgeo.normalized_line_direction(*tt))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-12)
    want = np_(jgeo.lines_info_from_endpoints(*jt))
    got = np_(tgeo.lines_info_from_endpoints(*tt))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-15, atol=1e-12)


@pytest.mark.parametrize("out_size", [7, 40, 64])
def test_masked_compact_contract(out_size):
    rng = np.random.default_rng(out_size)
    vals = rng.normal(size=(48, 3))
    mask = rng.random(48) < 0.5
    jv, jm, jc = jgeo.masked_compact(jnp.asarray(vals), jnp.asarray(mask),
                                     out_size)
    tv, tm, tc = tgeo.masked_compact(torch.as_tensor(vals),
                                     torch.as_tensor(mask), out_size)
    np.testing.assert_array_equal(np_(tv), np_(jv))
    np.testing.assert_array_equal(np_(tm), np_(jm))
    assert int(tc) == int(jc)
    # rows form: same output as the flattened grid
    rv, rm, rc = tgeo.masked_compact_rows(
        torch.as_tensor(vals).reshape(6, 8, 3),
        torch.as_tensor(mask).reshape(6, 8), out_size)
    np.testing.assert_array_equal(np_(rv), np_(tv))
    np.testing.assert_array_equal(np_(rm), np_(tm))
    assert int(rc) == int(tc)
