"""Observability: lsdtpu_torch.runtime.trace (the per-stage timing
harness, the torch.profiler scope, the per-frame JSONL log) on the CPU,
with FrameLog's records equal to lsdtpu.runtime.trace.FrameLog's on the
same outputs."""

import io
import json
import os

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
