"""Wave region growth of the port's map prep on the CPU: the plain
version of the grow_wave kernel (ops/grow.py:grow_wave_reference) and
the seed walk's use of it (mapprep/lsd.py:_grow).

Tiers: grow_wave_reference is the loop map prep ran before the kernel,
bit for bit (mask, pixel count, angle, waves) on every growth call of
the seed walk on test_fuzz_parity's synthetic maps, first growths and
the refiner's regrowths; a seed walk at one rank makes one grow_wave
call and one device read a growth call, counted as
``MapPrepStats.wave_calls``; the wrapper checks its inputs as grow_fifo's
does.  The kernel itself is held against this plain version on the card
(tests/test_torch_cuda.py), its decomposition in tests/
test_torch_kernel_plan.py."""

import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lsdtpu_torch.mapprep import lsd as tlsd
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.ops import grow as ogrow
from lsdtpu_torch.runtime import trace

from test_fuzz_parity import synth_map
from torch_parity import port_field

PI = math.pi
GROW_READS = "host_reads.mapprep.grow"


def _grow_before(seed_y, seed_x, seed_deg, deg_thre, free, deg_map, sin_map,
                 cos_map):
    """mapprep/lsd.py:_grow at one rank as it was before the kernel (its
    device reads through MapPrepStats.to_host aside): (cur, reg_deg, n,
    waves)."""
    cur = torch.zeros(deg_map.shape, dtype=torch.bool, device=deg_map.device)
    cur[seed_y, seed_x] = True
    sin = torch.sin(seed_deg)
    cos = torch.cos(seed_deg)
    deg = torch.atan2(sin, cos)
    n, waves = 1, 0
    while True:
        waves += 1
        m = cur.to(torch.float32)
        cand = (F.max_pool2d(m[None, None], 3, 1, 1)[0, 0] > 0.0) & ~cur \
            & free
        dif = torch.abs(deg - deg_map)
        dif = torch.where(dif > PI * 1.5, torch.abs(dif - 2 * PI), dif)
        acc = cand & (dif < deg_thre)
        n_acc = acc.sum()
        s_sin = torch.where(acc, sin_map, 0.0).sum()
        s_cos = torch.where(acc, cos_map, 0.0).sum()
        sin = sin + s_sin
        cos = cos + s_cos
        cur = cur | acc
        deg = torch.atan2(sin, cos)
        k = int(n_acc)
        if k == 0:
            return cur, deg, n, waves
        n += k


def _recorded_walk(seed, monkeypatch, den_thre=0.7):
    """The f64 seed walk on synth map ``seed``'s port field with every
    grow_wave call recorded: (stats, calls, line count, the walk's
    host_reads.mapprep.grow); a call is (args, result)."""
    field = port_field(synth_map(seed))
    H, W = field[0].shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    calls = []

    def grow_wave(*args, **kw):
        out = ogrow.grow_wave(*args, **kw)
        calls.append((args, out))
        return out

    monkeypatch.setattr(tlsd, "ogrow", types.SimpleNamespace(
        fifo_queue=ogrow.fifo_queue, grow_wave=grow_wave))
    st = MapPrepStats()
    before = trace.counters().get(GROW_READS, 0)
    _ends, n = tlsd._seed_walk(*field, log_nt, 0.3, 22.5, den_thre, 1024,
                               256, st)
    return st, calls, n, trace.counters().get(GROW_READS, 0) - before


@pytest.mark.parametrize("seed", [0, 1])
def test_grow_wave_reference_is_the_loop_before_the_kernel(seed, monkeypatch):
    """Every growth call of the seed walk - the seeds' first growths at
    the angle tolerance and the refiner's regrowths at a tensor
    tolerance - through the loop map prep ran before: the same mask,
    pixel count, angle and waves, bit for bit (a density threshold of 1.5
    sends regions through the refiner)."""
    st, calls, n, _reads = _recorded_walk(seed, monkeypatch, den_thre=1.5)
    assert n > 0 and len(calls) > st.seeds
    regrowths = 0
    for (sy, sx, seed_deg, thre, free, deg, sn, cs, _queue), got in calls:
        cur, reg_deg, size, waves = _grow_before(sy, sx, seed_deg, thre,
                                                 free, deg, sn, cs)
        assert torch.equal(got.cur, cur)
        assert torch.equal(got.reg_deg, reg_deg)
        assert got.counts.tolist()[:2] == [size, waves]
        regrowths += torch.is_tensor(thre)
    assert regrowths > 0


@pytest.mark.parametrize("seed", [0, 2])
def test_wave_calls_count_the_growth_calls(seed, monkeypatch):
    """At one rank a growth call is one grow_wave call and one device
    read (the tracer's host_reads.mapprep.grow): MapPrepStats counts the
    calls (wave_calls) and the waves the calls report."""
    st, calls, _n, reads = _recorded_walk(seed, monkeypatch)
    assert st.wave_calls == len(calls) >= st.seeds > 0
    assert st.waves == sum(int(g.counts[1]) for _a, g in calls) \
        > st.wave_calls
    # every candidate tested is a free neighbour of the region, at least
    # once a wave but the last when the region has one
    assert all(int(g.counts[2]) >= int(g.counts[1]) - 1 for _a, g in calls)
    assert reads == st.wave_calls and st.fifo_calls == 0


def _field(H=20, W=24, seed=3, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    deg = torch.from_numpy(rng.uniform(-PI, PI, (H, W))).to(dtype)
    free = torch.from_numpy(rng.random((H, W)) > 0.05)
    return deg, torch.sin(deg), torch.cos(deg), free


def test_grow_wave_on_the_cpu_is_the_plain_version():
    """For CPU tensors the wrapper returns the plain version's growth and
    launches nothing; the candidate tests are the free neighbours of the
    region summed over the waves."""
    deg, sn, cs, free = _field()
    deg[5:15, 5:15] = 0.2
    sn, cs = torch.sin(deg), torch.cos(deg)
    free[10, 10] = True
    before = ogrow.grow_wave.launches
    g = ogrow.grow_wave(10, 10, deg[10, 10], 0.4, free, deg, sn, cs)
    want = ogrow.grow_wave_reference(10, 10, deg[10, 10], 0.4, free, deg, sn,
                                     cs)
    assert ogrow.grow_wave.launches == before
    assert torch.equal(g.cur, want.cur) and torch.equal(g.reg_deg,
                                                        want.reg_deg)
    assert g.counts.tolist() == want.counts.tolist()
    n, waves, tests = g.counts.tolist()
    assert n == int(g.cur.sum()) >= int(free[5:15, 5:15].sum())
    assert waves >= 6 and tests > n


def test_grow_wave_rejects_bad_inputs():
    deg, sn, cs, free = _field()
    a = deg[3, 4]
    ok = (3, 4, a, 0.4, free, deg, sn, cs)
    ogrow.grow_wave(*ok)
    bad = [
        ((3, 4, 0.5, 0.4, free, deg, sn, cs), TypeError),       # float angle
        ((3, 4, a.float(), 0.4, free, deg, sn, cs), TypeError),
        ((3, 4, deg[:2, 0], 0.4, free, deg, sn, cs), TypeError),
        ((3, 4, a, torch.tensor([0.4, 0.5], dtype=torch.float64), free, deg,
          sn, cs), TypeError),
        ((3, 4, a, 0.4, free.to(torch.uint8), deg, sn, cs), TypeError),
        ((3, 4, a, 0.4, free, deg.int(), sn, cs), TypeError),
        ((3, 4, a, 0.4, free, deg, sn.float(), cs), TypeError),
        ((3, 4, a, 0.4, free.t(), deg, sn, cs), TypeError),
        ((20, 4, a, 0.4, free, deg, sn, cs), ValueError),
        ((3, 4, a, 0.4, free, deg, sn, cs.t().contiguous().t()), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            ogrow.grow_wave(*args)
    with pytest.raises(ValueError):
        ogrow.grow_wave(*ok, queue=ogrow.fifo_queue(4, 4, "cpu"))
