"""scripts/torch_fuzz_campaign.py, the port's randomized parity campaign:
a clean run on the CPU at the reference campaign's first seeds, a
planted violation of each section (the port function the section calls
patched), the exit code without a card, the weak tier on hand-made
traces, and one seed per section on the card (marked ``cuda``)."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
NONE = ["--cache", "0", "--lsd", "0", "--fifo", "0", "--rollout", "0",
        "--shard", "0"]


@pytest.fixture(scope="module")
def fc():
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz_campaign", ROOT / "scripts" / "torch_fuzz_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fc, capsys, argv):
    rc = fc.main(argv)
    out = capsys.readouterr().out
    return rc, out, json.loads(out.strip().splitlines()[-1])


def _only(section, n=1, seed0=100, device="cpu"):
    argv = list(NONE) + ["--seed0", str(seed0), "--device", device]
    argv[argv.index(f"--{section}") + 1] = str(n)
    return argv


def test_cpu_clean_at_reference_seeds(fc, capsys):
    rc, out, res = _run(fc, capsys, [
        "--device", "cpu", "--cache", "2", "--lsd", "2", "--fifo", "2",
        "--rollout", "2", "--shard", "0", "--seed0", "100"])
    assert rc == 0, out
    assert "campaign done: 0 failures" in out
    sec = res["sections"]
    assert res["failures"] == 0
    assert sec["cache"]["seeds"] == 2
    # every line within 1e-9 px of the oracle's, with its count
    assert sec["lsd-wave"]["within_1e9"] == 2
    assert sec["lsd-fifo"]["within_1e9"] == 2
    assert (sec["rollout"]["strong"], sec["rollout"]["weak"]) == (2, 0)
    # no kernel runs on the CPU, so none is held
    assert set(res["launches_held"].values()) == {0}


def test_seed_101_runs_the_perfect_score_chain():
    """The clean run's seed 101 holds the oracle's perfect-score NaN
    chain (frames with a NaN pose), the case the decisions contract
    compares NaN for NaN."""
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.oracle import driver as odrv
    ds = synth.synth_dataset(101).dataset
    res = odrv.run_sequence(ds)
    assert np.isnan(res.poses).any(1).any()


def _flip_cell(real):
    def planted(*a, **kw):
        out = real(*a, **kw).clone()
        out[100, 100] += 0.125
        return out
    return planted


def _drop_lines(real, growth):
    """The fewest lines dropped that break the structural contract: the
    reference's contract lets 10% of the oracle's lines go unmatched, so
    one dropped line alone passes it."""
    def planted(*a, **kw):
        infos, mask, n, rm = real(*a, **kw)
        if kw.get("growth", "wave") != growth:
            return infos, mask, n, rm
        k = n - int(0.9 * n) + 1
        mask = mask.clone()
        mask[:k] = False
        return infos, mask, n, rm
    return planted


def _move_pose(real):
    def planted(*a, **kw):
        out = dict(real(*a, **kw))
        pose = out["pose"]
        pose = pose.clone() if torch.is_tensor(pose) else pose.copy()
        pose[5, 0] += 6.0
        out["pose"] = pose
        return out
    return planted


@pytest.mark.parametrize("section,fail_tag", [
    ("cache", "FAIL cache seed=100:"),
    ("lsd", "FAIL lsd-wave seed=100:"),
    ("fifo", "FAIL lsd-fifo seed=100:"),
    ("rollout", "FAIL rollout seed=100:"),
    ("shard", "FAIL shard-dp-tp seed=100:"),
])
def test_planted_violation_fails_its_section(fc, capsys, monkeypatch,
                                             section, fail_tag):
    from lsdtpu_torch.mapprep import distance, lsd
    from lsdtpu_torch.runtime import loop
    if section == "cache":
        monkeypatch.setattr(distance, "create_map_cache",
                            _flip_cell(distance.create_map_cache))
    elif section in ("lsd", "fifo"):
        monkeypatch.setattr(lsd, "line_segment_detector", _drop_lines(
            lsd.line_segment_detector, "wave" if section == "lsd" else
            "fifo"))
    elif section == "rollout":
        monkeypatch.setattr(loop, "run_sequence", _move_pose(
            loop.run_sequence))
    else:
        # the ranks run unpatched; the run_sequence they are held to moves
        monkeypatch.setattr(fc, "rollout", _move_pose(fc.rollout))
    rc, out, res = _run(fc, capsys, _only(section))
    assert rc == 1
    assert fail_tag in out, out
    assert "campaign done: 0 failures" not in out
    assert res["failures"] >= 1


def test_shard_one_seed_clean(fc, capsys):
    rc, out, res = _run(fc, capsys, _only("shard"))
    assert rc == 0, out
    sec = res["sections"]["shard"]
    assert (sec["seeds"], sec["meshes"]) == (1, 2)
    assert sec["max_px"] <= 1e-6


def test_cuda_without_card_exits_2(fc, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fc.main(NONE) == 2
    assert fc.main(NONE + ["--device", "cuda"]) == 2
    cap = capsys.readouterr()
    assert "campaign done" not in cap.out
    assert "torch.cuda.is_available() is False" in cap.err


def test_weak_tier_on_hand_made_traces(fc):
    oposes = np.zeros((8, 3))
    ok = np.ones(8, bool)
    # a 3 px excursion at a relock that re-converges to sub-cell
    conv = oposes.copy()
    conv[2:4, 0] = [0.8, 3.0]
    conv[4:, 0] = [0.4, 0.3, 0.1, 0.01]
    assert fc._weak_tier_ok(conv, oposes, ok)
    # the same excursion that stays a cell off at the end
    stuck = conv.copy()
    stuck[7, 1] = 0.6
    assert not fc._weak_tier_ok(stuck, oposes, ok)
    # re-converged, but once past 5 px
    far = conv.copy()
    far[3, 0] = 5.0
    assert not fc._weak_tier_ok(far, oposes, ok)
    # the stuck frame is lost in the oracle's run: only ok frames count
    ok[7] = False
    assert fc._weak_tier_ok(stuck, oposes, ok)
    assert fc._weak_tier_ok(stuck, oposes, np.zeros(8, bool))


@pytest.mark.cuda
def test_one_seed_per_section_on_the_card(fc, capsys):
    """Seed 118's FIFO map prep needs the radius reducer, so all four
    kernels launch; every launch is held against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    rc, out, res = _run(fc, capsys, [
        "--cache", "1", "--lsd", "1", "--fifo", "1", "--rollout", "1",
        "--shard", "1", "--seed0", "118"])
    assert rc == 0, out
    held = res["launches_held"]
    assert held["score_partials"] > 0 and held["score_partials_batched"] > 0
    for k in ("rect_counts", "grow_fifo", "radius_reducer_fifo"):
        assert held[k] > 0, (k, held)
    assert res["sections"]["rollout"]["card_cpu"] == 1
    assert res["sections"]["lsd-fifo"]["card_cpu"] == 1


def _oracle_field(grid):
    import math
    from lsdtpu_torch.oracle import lsd as olsd
    g = grid.copy()
    sub = g[1:, 1:]
    one, free = sub == 1, sub == 255
    sub[one], sub[free] = 255, 0
    gauss = olsd.gaussian_sampler(g, 0.3, 0.6)
    return olsd.gradient_field(gauss, 22.5 / 180.0 * math.pi)


@pytest.mark.parametrize("seed,growth", [(1004, "fifo"), (1004, "wave"),
                                         (1011, "wave")])
def test_campaign_seeds_off_the_oracle_follow_jax(seed, growth):
    """At --seed0 1000 the port's lines (card and CPU alike) part from
    the oracle's at 1e-9 px on seeds 1004 and 1011 (a region one pixel
    longer, or split in two), within the structural contract.  The
    blur, magnitude and pre-ban mask are the oracle's bit for bit; the
    level-line angle is within one ulp of the oracle's (numpy's atan2
    on the CPU, the oracle's glibc atan2), and a few cells differ.  On
    its own field the port's seed walk is the JAX package's row for
    row."""
    import math
    from lsdtpu_torch.io import synth
    from lsdtpu_torch.mapprep import lsd as tlsd
    from lsdtpu_torch.mapprep.stats import MapPrepStats
    from torch_parity import assert_lines_close, jax_lines_on_field, \
        port_field
    g, _walls = synth.synth_map(seed)
    field = port_field(g)
    mag, deg, ban, max_grad = (x.numpy() for x in field)
    omag, odeg, oused, omax = _oracle_field(g)
    np.testing.assert_array_equal(mag, omag)
    np.testing.assert_array_equal(ban, oused.astype(bool))
    assert float(max_grad) == omax
    ulps = np.abs(deg - odeg) / np.spacing(np.abs(odeg))
    assert 0 < int((deg != odeg).sum()) <= 20 and ulps.max() <= 1.0
    H, W = mag.shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    ends, n = tlsd._seed_walk(*field, log_nt, 0.3, 22.5, 0.7, 1024, 256,
                              MapPrepStats(), growth=growth)
    e = torch.from_numpy(np.stack(ends))
    got = tlsd.geo.lines_info_from_endpoints(e[:, 0], e[:, 1], e[:, 2],
                                             e[:, 3]).numpy()
    assert_lines_close(got, jax_lines_on_field(field, growth=growth))
