"""``correct`` at a size a test run holds, on the CPU: sound runs of the
program come out correct; the control (the reference in bfloat16 in
the program's place), the program with its field in bfloat16, and the
program with its timed path broken underneath come out not correct.

Every run judges as many sessions as the cells' traffic files say, out
of more than that: the faults that break part of a batch break the part
the judged sample leaves out, so that only the check of every session
against its walk can see them.

The faults, each planted underneath the run with the harness's look
for a card skipped: a step that returns its state unchanged; half of
the batch left out (its lanes' states never advance, or their answers
copied from the other half); an answer altered where it is produced (a
pose moved 4 px, 0.1 m on the cells' grid; a candidate count off by one;
a field cell moved 1 mm).  The fault in the exchange between cards
comes with the first four-card cell, whose kind runs over ranks."""

import types

import numpy as np
import pytest

import run as runner

KINDS = ("fleet", "mapswitch", "replay")
ALTER_PX = 4.0       # an answer moved 0.1 m on the cells' 0.025 m grid
SECONDS = {"fleet": 2.0, "mapswitch": 0.5, "replay": 0.5}
SEED = 2**31 + 5


def correct(cell, mode="program", seed=SEED):
    res, _lines, checks = runner.execute(cell, seed, SECONDS[cell.kind], 0,
                                         mode, "cpu")
    return res["correct"], {c["name"]: c["value"] for c in checks}, \
        {c["name"] for c in checks if not c["ok"]}


def judged(cell, n, seed=SEED, **state):
    """The sessions (fleet: robot indices; replay: lanes) the judge of a
    run of ``cell`` with ``n`` of them samples."""
    run = types.SimpleNamespace(seed=seed, wl=cell.workload, mode="program",
                                robots=list(range(n)), outs=[None], **state)
    picks = cell.traffic_module().Run.judged(run)
    return sorted({p if cell.kind == "fleet" else p[1] for p in picks})


@pytest.mark.parametrize("kind", KINDS)
def test_sound_program_is_correct(tiny, kind):
    ok, vals, _bad = correct(tiny(kind))
    assert ok, vals


@pytest.mark.parametrize("kind", KINDS)
def test_control_is_not_correct(tiny, kind):
    ok, vals, _bad = correct(tiny(kind), "control")
    assert not ok, vals


@pytest.mark.parametrize("kind", KINDS)
def test_program_with_bf16_field_is_not_correct(tiny, kind):
    ok, vals, _bad = correct(tiny(kind), "cache-bf16")
    assert not ok, vals


@pytest.mark.parametrize("kind", ("fleet", "replay"))
def test_state_unchanged_is_caught(tiny, kind, monkeypatch):
    from lsdtpu_torch.runtime import loop
    real = loop.match_stage

    def frozen(state, *a, **k):
        _new, out = real(state, *a, **k)
        return state, out

    monkeypatch.setattr(loop, "match_stage", frozen)
    ok, vals, _bad = correct(tiny(kind))
    assert not ok, vals


def test_map_left_unchanged_is_caught(tiny, monkeypatch):
    from lsdtpu_torch.runtime import online
    real = online.prepare_map
    first = {}

    def stale(grid, *a, **k):
        return first.setdefault("art", real(grid, *a, **k))

    monkeypatch.setattr(online, "prepare_map", stale)
    ok, vals, _bad = correct(tiny("mapswitch"))
    assert not ok, vals


def test_half_the_pool_left_out_is_caught(tiny, monkeypatch):
    """The odd robots (half the pool) never advance: each of their scans
    is matched from the state they opened with."""
    from lsdtpu_torch.runtime import serving
    real = serving._pool_step

    def half(states, inputs, ctxs, active, *a, **k):
        keep = active.clone()
        keep[1::2] = False
        return real(states, inputs, ctxs, keep, *a, **k)

    monkeypatch.setattr(serving, "_pool_step", half)
    ok, vals, _bad = correct(tiny("fleet"))
    assert not ok, vals


def test_half_the_pool_copied_is_caught(tiny, monkeypatch):
    """Half the robots, all of them robots the judge does not sample,
    are answered with other robots' answers."""
    from lsdtpu_torch.runtime import serving
    cell = tiny("fleet")
    n = cell.workload["robots"]
    seen = judged(cell, n)
    out = [i for i in range(n) if i not in seen][:n // 2]
    assert len(out) == n // 2
    src = [i for i in range(n) if i not in out]
    real = serving.to_host

    def copied(res):
        host = real(res)
        idx = np.arange(n)
        idx[out] = [src[i % len(src)] for i in range(len(out))]
        return {k: v[idx] for k, v in host.items()}

    monkeypatch.setattr(serving, "to_host", copied)
    ok, vals, bad = correct(cell)
    assert not ok and bad == {"truth_gap_px"}, vals


def test_half_the_replay_batch_copied_is_caught(tiny, monkeypatch):
    """Half the lanes, all of them lanes the judge does not sample, take
    the answers of other lanes."""
    from lsdtpu_torch.runtime import batch
    cell = tiny("replay")
    B = cell.workload["lanes"]
    seen = judged(cell, B)
    out = [b for b in range(B) if b not in seen][:B // 2]
    assert len(out) == B // 2
    src = [b for b in range(B) if b not in out]
    real = batch.run_batch

    def half(frames, ctxs, *a, **k):
        res = real(frames, ctxs, *a, **k)
        idx = np.arange(B)
        idx[out] = [src[i % len(src)] for i in range(len(out))]
        return {key: v[idx] for key, v in res.items()}

    monkeypatch.setattr(batch, "run_batch", half)
    ok, vals, bad = correct(cell)
    assert not ok and bad == {"truth_gap_px"}, vals


def test_an_altered_tick_is_caught(tiny, monkeypatch):
    """Every answer of one tick after the warm-up moved 4 px."""
    from lsdtpu_torch.runtime import serving
    real = serving.to_host
    calls = {"n": 0}

    def altered(out):
        res = real(out)
        calls["n"] += 1
        if calls["n"] == 5:
            res["pose"] = res["pose"].copy()
            res["pose"][:, 0] += ALTER_PX
        return res

    monkeypatch.setattr(serving, "to_host", altered)
    ok, vals, bad = correct(tiny("fleet"))
    assert not ok and "pose_gap_max_px" in bad, vals


def test_an_altered_replay_frame_is_caught(tiny, monkeypatch):
    """Frame 5 of every lane of each timed call moved 4 px."""
    from lsdtpu_torch.runtime import batch
    real = batch.run_batch

    def altered(frames, ctxs, *a, **k):
        out = real(frames, ctxs, *a, **k)
        if out["pose"].shape[1] > 5:         # not the warm-up's call
            out["pose"] = out["pose"].clone()
            out["pose"][:, 5, 0] += ALTER_PX
        return out

    monkeypatch.setattr(batch, "run_batch", altered)
    ok, vals, bad = correct(tiny("replay"))
    assert not ok and "pose_gap_max_px" in bad, vals


@pytest.mark.parametrize("kind", ("fleet", "replay"))
def test_an_altered_candidate_count_is_caught(tiny, kind, monkeypatch):
    """Every answer's candidate count one higher than the step found."""
    from lsdtpu_torch.runtime import batch, serving
    if kind == "fleet":
        real = serving.to_host

        def altered(out):
            res = real(out)
            res["n_candidates"] = res["n_candidates"] + 1
            return res

        monkeypatch.setattr(serving, "to_host", altered)
    else:
        real_b = batch.run_batch

        def altered(frames, ctxs, *a, **k):
            out = real_b(frames, ctxs, *a, **k)
            out["n_candidates"] = out["n_candidates"] + 1
            return out

        monkeypatch.setattr(batch, "run_batch", altered)
    ok, vals, bad = correct(tiny(kind))
    assert not ok and bad == {"decision_flip_share"}, vals


def test_an_altered_first_pose_is_caught(tiny, monkeypatch):
    """The first pose on each new map moved 4 px."""
    from lsdtpu_torch.runtime import online
    real = online.to_host

    def altered(out):
        res = real(out)
        res["pose"] = res["pose"].copy()
        res["pose"][0] += ALTER_PX
        return res

    monkeypatch.setattr(online, "to_host", altered)
    ok, vals, bad = correct(tiny("mapswitch"))
    assert not ok and bad == {"first_pose_gap_median_px"}, vals


def test_an_altered_field_cell_is_caught(tiny, monkeypatch):
    from lsdtpu_torch.runtime import online
    real = online.prepare_map

    def altered(grid, *a, **k):
        art = real(grid, *a, **k)
        art.map_cache[50, 60] += 0.001
        return art

    monkeypatch.setattr(online, "prepare_map", altered)
    ok, vals, _bad = correct(tiny("mapswitch"))
    assert not ok, vals
