"""Observability: lsdtpu_torch.runtime.trace (the per-stage timing
harness, the torch.profiler scope, the per-frame JSONL log) on the CPU,
with FrameLog's records equal to lsdtpu.runtime.trace.FrameLog's on the
same outputs."""

import collections
import dataclasses
import gc
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from lsdtpu.runtime import trace as jtrace
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime import trace as ttrace

from torch_parity import contexts, frames, np_

KEYS = ["candidates_ms", "featurize_ms", "fuse_ms", "score_ms", "ukf_ms"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stage_timings_keys_and_values(dtype):
    _, ctx = contexts(0, dtype)
    fr = frames(0, dtype)
    fi = tuple(fr[k][3] for k in tloop._FRAME_KEYS)
    st = ttrace.stage_timings(fi, ctx, repeats=2, device="cpu")
    assert sorted(st) == KEYS
    assert all(np.isfinite(v) and v > 0 for v in st.values()), st


def test_stage_timings_default_device_is_the_card():
    _, ctx = contexts(0)
    fr = frames(0)
    fi = tuple(fr[k][0] for k in tloop._FRAME_KEYS)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU context would not match")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrace.stage_timings(fi, ctx, repeats=1)


def test_device_trace_none_is_a_noop(tmp_path):
    cwd = os.getcwd()
    with ttrace.device_trace(None):
        x = torch.ones(3) + 1
    assert float(x.sum()) == 6.0
    assert os.getcwd() == cwd and list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(tmp_path):
    _, ctx = contexts(0)
    fr = {k: v[:2] for k, v in frames(0).items()}
    d = str(tmp_path / "trace")
    with ttrace.device_trace(d):
        tloop.run_sequence(fr, ctx, device="cpu")
    path = os.path.join(d, ttrace.TRACE_FILE)
    with open(path) as f:
        tr = json.load(f)
    names = {e.get("name") for e in tr["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_frame_log_matches_jax():
    _, ctx = contexts(1)
    outs = tloop.run_sequence(frames(1), ctx, device="cpu")
    outs["score"][2] = torch.inf       # a lost frame logs score None
    host = {k: np_(v) for k, v in outs.items()}
    got, want = io.StringIO(), io.StringIO()
    assert ttrace.FrameLog(got).write_rollout(outs, seq="s1") == 10
    jlog = jtrace.FrameLog(want)
    assert jlog.write_rollout(host, seq="s1") == 10
    assert got.getvalue() == want.getvalue()
    log = ttrace.FrameLog(got)
    assert log.write_rollout(host, n_frames=4) == 4 and log.n == 4
    rec = json.loads(want.getvalue().splitlines()[2])
    assert rec["score"] is None and rec["tracking"] is False


# -- the stage tracer -------------------------------------------------------

POOL_SPANS = {"pool.step", "pool.pack", "step.featurize", "step.match",
              "match.candidates", "match.score", "match.fuse", "match.gate",
              "match.ukf", "pool.readback"}
ONLINE_SPANS = {"online.set_map", "mapprep.field", "mapprep.lsd",
                "mapprep.gradient", "mapprep.seed", "mapprep.grow",
                "mapprep.validate", "mapprep.context", "online.push",
                "online.pack", "step.featurize", "step.match",
                "online.readback"}
BATCH_SPANS = {"batch.run", "batch.upload", "batch.frame", "step.featurize",
               "step.match"}
# each span's parent, by name (host.gc may open anywhere)
PARENTS = {"pool.pack": "pool.step", "pool.readback": "pool.step",
           "step.featurize": ("pool.step", "online.push", "batch.frame",
                              "batch.run"),
           "step.match": ("pool.step", "online.push", "batch.frame"),
           "match.candidates": "step.match", "match.score": "step.match",
           "match.fuse": "step.match", "match.gate": "step.match",
           "match.ukf": "step.match", "mapprep.field": "online.set_map",
           "mapprep.lsd": "online.set_map",
           "mapprep.gradient": "mapprep.lsd", "mapprep.seed": "mapprep.lsd",
           "mapprep.grow": ("mapprep.lsd", "mapprep.validate"),
           "mapprep.validate": "mapprep.lsd",
           "mapprep.context": "online.set_map",
           "online.pack": "online.push", "online.readback": "online.push",
           "batch.upload": "batch.run", "batch.frame": "batch.run"}


def _scene(F=3):
    from lsdtpu_torch.io import synth
    return synth.synth_dataset(0, F=F).dataset


def _geometry(ds):
    return ds.param.resol, ds.param.ori_x, ds.param.ori_y


def _pool_tick(dtype=np.float64):
    """A two-robot pool (capacity 3) and its first two ticks' results."""
    from lsdtpu_torch.runtime.serving import SessionPool
    ds = _scene()
    _, ctx = contexts(0, dtype)
    pool = SessionPool(3, (200, 260), dtype=dtype, device="cpu")
    lines = ctx.lines[ctx.lines_mask]
    for sid in ("a", "b"):
        pool.open_session(sid, lines, ctx.cache, *_geometry(ds))
    res = []
    for f in range(2):
        for sid in ("a", "b"):
            fr = ds.frames[f]
            pool.submit_scan(sid, fr[:, 0], fr[:, 1], ds.odom[f + 1])
        res.append(pool.step())
    return pool, res


def _online(dtype=np.float64):
    """An OnlineLocalizer's map from the scene's grid and two pushes."""
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    ds = _scene()
    loc = OnlineLocalizer(dtype=dtype, device="cpu")
    n = loc.set_map(ds.map_value, *_geometry(ds))
    outs = [loc.push_scan(ds.frames[f][:, 0], ds.frames[f][:, 1],
                          ds.odom[f + 1]) for f in range(2)]
    return loc, n, outs


def _batch(dtype=np.float64, cfg=None):
    from lsdtpu_torch.config import DEFAULT
    from lsdtpu_torch.runtime import batch as tbatch
    from torch_parity import lane_scenes
    dss, arts = lane_scenes()
    cfg = cfg or DEFAULT
    fr, ctxs, _lens = tbatch.stack_batch(dss, arts, cfg, dtype=dtype,
                                         max_frames=3, device="cpu")
    return tbatch.run_batch(fr, ctxs, cfg, device="cpu")


def _traced(fn, how):
    """fn() with recording on (a CPU profile, or trace.recording()):
    (its result, the spans it recorded, the host clock around it)."""
    from torch.profiler import ProfilerActivity, profile
    ttrace.clear()
    scope = profile(activities=[ProfilerActivity.CPU]) \
        if how == "profiler" else ttrace.recording()
    with scope:
        t0 = time.perf_counter_ns()
        out = fn()
        t1 = time.perf_counter_ns()
    return out, ttrace.spans(), (t0, t1)


def _check_tree(spans, clock):
    """Each span inside the host clock around the call, inside its
    parent, named as PARENTS says, and of its parent's request (a batch
    frame's is its call's and its index)."""
    by_id = {s.id: s for s in spans}
    t0, t1 = clock
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
        if s.name == "host.gc" or s.parent is None:
            continue
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns, (s, up)
        want = PARENTS.get(s.name)
        if want is not None:
            assert up.name in (want if isinstance(want, tuple)
                               else (want,)), (s.name, up.name)
        if s.name == "batch.frame":       # (call, frame) of its call
            assert s.request[0] == up.request, (s, up)
        else:
            assert s.request == up.request, (s, up)
    return by_id


def test_off_records_nothing_and_counters_count():
    ttrace.clear()
    before = ttrace.counters()
    _pool_tick()
    after = ttrace.counters()
    assert ttrace.spans() == [] and ttrace.dropped() == 0
    assert ttrace.span("x") is ttrace.span("y")     # the shared no-op
    key = "host_reads.pool.readback"
    assert after[key] - before.get(key, 0) == 2
    rdp = "host_reads.featurize.rdp"
    assert after[rdp] > before.get(rdp, 0)


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_pool_step_spans(how):
    (pool, _res), spans, clock = _traced(_pool_tick, how)
    assert ttrace.span("x") is ttrace.span("y")     # off again
    names = {s.name for s in spans}
    assert POOL_SPANS <= names - {"host.gc"}, POOL_SPANS - names
    by_id = _check_tree(spans, clock)
    steps = [s for s in spans if s.name == "pool.step"]
    assert [s.request for s in steps] == [1, 2]
    assert all(s.parent is None for s in steps)
    # the first tick relocks both robots, the second tracks them
    assert steps[0].counts == {"slots_stepped": 3, "scans_carried": 2,
                               "relock_lanes": 2}
    assert steps[1].counts["relock_lanes"] == 0
    # every stage of a tick shares the tick's request
    for s in spans:
        if s.name in POOL_SPANS and s.name != "host.gc":
            assert s.request in (1, 2)
    assert all(by_id[s.parent].name == "step.match" for s in spans
               if s.name.startswith("match."))


def test_online_spans_and_mapprep_stats():
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    before = ttrace.counters()
    (loc, n, _outs), spans, clock = _traced(_online, "recording")
    after = ttrace.counters()
    names = {s.name for s in spans}
    assert ONLINE_SPANS <= names, ONLINE_SPANS - names
    _check_tree(spans, clock)
    sm = [s for s in spans if s.name == "online.set_map"]
    assert len(sm) == 1 and sm[0].request[0] == "map"
    pushes = [s for s in spans if s.name == "online.push"]
    assert [s.request[0] for s in pushes] == ["push", "push"]
    assert pushes[0].request != pushes[1].request
    st = loc.last_mapprep_stats
    assert isinstance(st, MapPrepStats) and st.seeds > 0 and n > 0
    lsd = [s for s in spans if s.name == "mapprep.lsd"]
    assert lsd[0].counts == dataclasses.asdict(st)
    assert len([s for s in spans if s.name == "mapprep.seed"]) == \
        st.seeds + 1                    # the last seed ends the walk

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)
    sites = {k: delta(k) for k in after if k.startswith("host_reads.mapprep.")}
    assert set(sites) >= {f"host_reads.mapprep.{s}" for s in
                          ("seed", "grow", "rect", "nfa", "field")}
    assert sum(v for k, v in sites.items()
               if k != "host_reads.mapprep.field") == st.syncs
    assert sites["host_reads.mapprep.field"] > 0
    assert delta("host_reads.online.readback") == 2
    # the default config's pruning gate reads the live count a push
    assert delta("host_reads.match.prune_gate") == 2


def test_oracle_set_map_keeps_no_stats():
    from lsdtpu_torch.runtime.online import OnlineLocalizer
    ds = _scene()
    loc = OnlineLocalizer(dtype=np.float64, device="cpu", mapprep="oracle")
    loc.set_map(ds.map_value, *_geometry(ds))
    assert loc.last_mapprep_stats is None


@pytest.mark.parametrize("prefeaturize", [False, True])
def test_batch_spans(prefeaturize):
    from lsdtpu_torch.config import DEFAULT
    cfg = dataclasses.replace(DEFAULT, prefeaturize=prefeaturize)
    _out, spans, clock = _traced(lambda: _batch(cfg=cfg), "profiler")
    names = {s.name for s in spans}
    assert BATCH_SPANS <= names, BATCH_SPANS - names
    _check_tree(spans, clock)
    run = [s for s in spans if s.name == "batch.run"]
    assert len(run) == 1
    frames = [s for s in spans if s.name == "batch.frame"]
    assert [s.request for s in frames] == [(run[0].request, f)
                                           for f in range(3)]
    by_id = {s.id: s for s in spans}
    feat = [by_id[s.parent].name for s in spans
            if s.name == "step.featurize"]
    assert feat == (["batch.run"] if prefeaturize else ["batch.frame"] * 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("path", ["pool", "online", "batch"])
def test_outputs_bitwise_with_recording_on_and_off(path, dtype):
    def run():
        if path == "pool":
            return [{k: v for sid in sorted(r) for k, v in r[sid].items()}
                    for r in _pool_tick(dtype)[1]]
        if path == "online":
            return _online(dtype)[2]
        return [{k: np_(v) for k, v in _batch(dtype).items()}]
    off = run()
    with ttrace.recording():
        on = run()
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def test_rdp_reads_are_the_rdp_rounds():
    from lsdtpu_torch.scan import featurize as tfeat
    r0 = tfeat._rdp_rounds.rounds
    c0 = ttrace.counters()["host_reads.featurize.rdp"]
    _pool_tick()
    dr = tfeat._rdp_rounds.rounds - r0
    assert dr > 0
    assert ttrace.counters()["host_reads.featurize.rdp"] - c0 == dr


def test_window_read_is_counted():
    from lsdtpu_torch.config import DEFAULT
    cfg = dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, score_window=128))
    _, ctx = contexts(0)
    fr = {k: v[:3] for k, v in frames(0).items()}
    c0 = ttrace.counters().get("host_reads.match.window", 0)
    tloop.run_sequence(fr, ctx, cfg, device="cpu")
    assert ttrace.counters()["host_reads.match.window"] - c0 == 3


def test_counters_and_host_read():
    c0 = ttrace.counters().get("test.count", 0)
    ttrace.count("test.count")
    ttrace.count("test.count", 4)
    assert ttrace.counters()["test.count"] - c0 == 5
    h0 = ttrace.counters().get("host_reads.test.site", 0)
    v = ttrace.host_read("test.site", torch.arange(3))
    assert isinstance(v, np.ndarray) and v.tolist() == [0, 1, 2]
    assert ttrace.counters()["host_reads.test.site"] - h0 == 1


def test_gc_pauses_are_spans():
    ttrace.clear()
    gc.collect()
    assert ttrace.spans() == []
    with ttrace.recording():
        with ttrace.span("outer", 11) as sp:
            gc.collect()
            sp.set(n=1)
    by_name = {s.name: s for s in ttrace.spans()}
    g, outer = by_name["host.gc"], by_name["outer"]
    assert g.parent == outer.id and g.request == 11
    assert g.counts["generation"] == 2
    assert outer.start_ns <= g.start_ns <= g.end_ns <= outer.end_ns
    assert outer.counts == {"n": 1}


def test_full_buffer_drops_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(ttrace, "_buffer", collections.deque(maxlen=3))
    ttrace.clear()
    with ttrace.recording():
        for i in range(5):
            with ttrace.span(f"s{i}"):
                pass
    assert [s.name for s in ttrace.spans()] == ["s2", "s3", "s4"]
    assert ttrace.dropped() == 2
    ttrace.clear()
    assert ttrace.spans() == [] and ttrace.dropped() == 0
