"""The port's drawer and web viewer against the JAX package's: the snapshot of
one map (the port's ``SlamSystem`` map over the room orbit at 320x240, moved
to the JAX package as numpy), the viewer HTML byte for byte, the metrics CSV,
the HUD arrays and the HUD files, all equal; the map and trajectory renders
write PNGs (matplotlib, present here)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from vo_slam_test_tpu.slam_map import map_state as jmap_state
from vo_slam_test_tpu.viz import drawer as jdrawer
from vo_slam_test_tpu.viz import webviewer as jwebviewer
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.viz import (MapSnapshot, plot_map, plot_trajectories,
                                        save_metrics_csv, snapshot_map)
from vo_slam_test_tpu_torch.viz import drawer, webviewer

from torch_slam_helpers import room_kw, room_sequence

N_FRAMES = 8


@pytest.fixture(scope="module")
def run():
    seq = room_sequence()
    s = SlamSystem(SlamConfig(**room_kw(seq)), caps=MapCaps(max_kf=16, max_pt=4096),
                   device="cpu")
    grays = []
    for i in range(N_FRAMES):
        g, d, t = seq[i]
        grays.append(g)
        s.track(g, d, t)
    traj, stats, _ = s.results()
    host = convert.map_state_to_numpy(s.map)
    # a loop edge, so all three edge kinds are drawn
    kfs = np.nonzero(host["kf_valid"])[0]
    host["loop_edges"][kfs[0], kfs[-1]] = host["loop_edges"][kfs[-1], kfs[0]] = True
    s.map = convert.map_state_from_numpy(host, "cpu")
    jm = jmap_state.MapState(**{k: jnp.asarray(v) for k, v in host.items()})
    return dict(s=s, jm=jm, traj=traj, stats=stats, grays=grays, seq=seq)


def assert_snap_equal(a: MapSnapshot, b) -> None:
    for f in dataclasses.fields(MapSnapshot):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_snapshot_equal_jax(run):
    snap = snapshot_map(run["s"].map)
    assert_snap_equal(snap, jdrawer.snapshot_map(run["jm"]))
    assert snap.kf_poses.shape[0] == run["s"].n_keyframes >= 2
    assert snap.points.shape[0] == run["s"].n_points
    assert len(snap.tree_edges) >= 1 and len(snap.covis_edges) >= 1 and len(snap.loop_edges) == 1


@pytest.mark.parametrize("opts", [
    dict(),
    dict(with_traj=True),
    dict(with_traj=True, local=True, autorefresh_s=2.0),
    dict(max_points=50),
])
def test_export_html_byte_equal(run, tmp_path, opts):
    snap = snapshot_map(run["s"].map)
    jsnap = jdrawer.snapshot_map(run["jm"])
    kw = {}
    if opts.get("with_traj"):
        kw["traj_T_w_c"] = run["traj"]
    if opts.get("local"):
        kw["local_mask"] = np.arange(len(snap.points)) % 3 == 0
    for k in ("autorefresh_s", "max_points"):
        if k in opts:
            kw[k] = opts[k]
    got, want = str(tmp_path / "port.html"), str(tmp_path / "jax.html")
    webviewer.export_html(snap, got, **kw)
    jwebviewer.export_html(jsnap, want, **kw)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert not os.path.exists(got + ".tmp")
    np.testing.assert_array_equal(webviewer.auto_target(snap), jwebviewer.auto_target(jsnap))


def test_metrics_csv_equal(run, tmp_path):
    got, want = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    save_metrics_csv(got, run["s"].timestamps, run["stats"])
    jdrawer.save_metrics_csv(want, run["s"].timestamps, run["stats"])
    assert open(got).read() == open(want).read()
    lines = open(got).read().strip().splitlines()
    assert len(lines) == N_FRAMES + 1 and lines[0].startswith("timestamp,ok")


def test_hud_frames_equal(run, tmp_path):
    s = run["s"]
    frames = [0, 3, N_FRAMES - 1]
    outs = s.hud_outputs(frames)
    assert [o.ok for o in outs] == [st.ok for st in (run["stats"][i] for i in frames)]
    assert s.hud_outputs([]) == []
    for i, o in zip(frames, outs):
        assert o.kp_uv.shape == (s.caps.n_feat, 2) and o.kp_state.dtype == np.int32
        got = drawer.draw_hud_frame(run["grays"][i], o.kp_uv, o.kp_state, o.ok, frame_id=i)
        want = jdrawer.draw_hud_frame(run["grays"][i], o.kp_uv, o.kp_state, o.ok, frame_id=i)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (run["grays"][i].shape[0] + 22, run["grays"][i].shape[1], 3)
    assert (outs[-1].kp_state == 1).sum() > 50  # map-tracked keypoints are drawn
    n = drawer.save_hud_frames(str(tmp_path / "hud"), [run["grays"][i] for i in frames], outs)
    m = jdrawer.save_hud_frames(str(tmp_path / "jhud"), [run["grays"][i] for i in frames], outs)
    assert n == m == 3
    for k in range(3):
        name = f"hud_{k:05d}.png"
        assert open(tmp_path / "hud" / name, "rb").read() == open(tmp_path / "jhud" / name,
                                                                   "rb").read()


def test_plots_write_pngs(run, tmp_path):
    pytest.importorskip("matplotlib")
    map_png, traj_png = str(tmp_path / "map.png"), str(tmp_path / "traj.png")
    plot_map(snapshot_map(run["s"].map), map_png)
    gt = np.stack([run["seq"].poses[i] for i in range(N_FRAMES)])
    plot_trajectories(traj_png, run["traj"], gt)
    for p in (map_png, traj_png):
        assert os.path.getsize(p) > 1000
        assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
