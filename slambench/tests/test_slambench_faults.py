"""A whole run on the CPU at a size a test can hold (the fr1_xyz cell's
configuration at 320x240, six-frame recordings, two frames a dispatch, the
port's plain versions in place of the kernels), with the card's look skipped:
sound it is correct; with the timed path broken underneath, or with the
control (the reference one precision below) in the program's place, it is
not."""

import copy

import torch

from slambench import run


def _small(name="fr1_xyz"):
    cfg = copy.deepcopy(run.read_json("configs", name))
    for k in ("camera_fx", "camera_fy", "camera_cx", "camera_cy"):
        cfg["slam"][k] /= 2
    cfg["slam"]["camera_width"], cfg["slam"]["camera_height"] = 320, 240
    cfg["recording_frames"] = 6
    return cfg


def _run():
    cfg = _small()
    cell = run.cell_spec(run.load_manifest(), "fr1_xyz.offline")
    traffic = {"mode": "offline", "chunk": 2}
    torch.set_num_threads(2)
    # 0.2 s of camera time at 30 Hz: one recording of six frames
    return run.measure(cell, cfg, traffic, 20231, 0.2, False, torch.device("cpu"), {})


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 6 and out["failed"] == 0
    assert list(out)[-1] == "checks" and set(out["metrics"]) == {"frames_per_s", "setup_s"}


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """One bit of every descriptor flipped as the extractor produces it."""
    from vo_slam_test_tpu_torch.ops import orb_cuda

    orig = orb_cuda.orb_angle_desc

    def flipped(*args):
        ang, desc = orig(*args)
        return ang, desc ^ 1

    monkeypatch.setattr(orb_cuda, "orb_angle_desc", flipped)
    out = _run()
    assert not out["correct"] and out["checks"]["orb_bad_pct"]["value"] == 100.0


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    """The pose solve returns the pose it was given."""
    from vo_slam_test_tpu_torch.solvers import pose_only

    def unchanged(T_init, obs, *a, **kw):
        return T_init, obs.valid, obs.valid.sum(dtype=torch.int32)

    monkeypatch.setattr(pose_only, "solve_pose_only", unchanged)
    out = _run()
    assert not out["correct"]
    assert (out["checks"]["ate_cm"]["value"] > out["checks"]["ate_cm"]["limit"]
            or out["failed"] > 0)


def test_half_of_the_batch_left_out(monkeypatch):
    """Each dispatch tracks the first half of its frames and drops the rest."""
    from vo_slam_test_tpu_torch.pipeline import system

    orig = system.track_chunk

    def half(state, m, frames, *a, **kw):
        return orig(state, m, frames[:max(1, len(frames) // 2)], *a, **kw)

    monkeypatch.setattr(system, "track_chunk", half)
    out = _run()
    assert not out["correct"] and out["failed"] >= 3


def test_the_control_fails():
    """The reference in bf16 in the program's place: its keypoints and a map
    rounded to bf16."""
    cfg = _small()
    inp = run.make_inputs(cfg, 20231, torch.device("cpu"))
    run.warm_up(inp, 2, torch.device("cpu"))
    win = run.run_window(inp, {"mode": "offline", "chunk": 2}, 1, torch.device("cpu"), False,
                         run.make_system)
    sound = run.check_readings(inp, cfg, win.trajectories, win.systems[0])
    ctl = run.check_readings(inp, cfg, win.trajectories, win.systems[0], control=torch.bfloat16)
    limits = cfg["limits"]
    assert all(sound[k] <= limits[k] for k in run.COMPARED)
    assert any(ctl[k] > limits[k] for k in run.COMPARED)
    assert ctl["orb_bad_pct"] > 50
