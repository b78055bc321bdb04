"""The port's CLI (``vo_slam_test_tpu_torch.run_slam.main``) against the JAX
package's over one TUM directory written here (6 frames of the JAX package's
``SyntheticRGBD(seed=11)`` at 320x240, gray written as R=G=B so luma decodes
it exactly, depth as round(d*5000) u16) with a config of
``configs/tum_fr1.yaml``'s keys (4 levels, 500 features, no distortion).

``--sync`` and the default mode: the camera trajectory files agree within
1e-4 (the tolerance of ``tests/test_torch_tracking.py``) and the printed
per-frame counts are equal. ``--chunk 2`` with every output flag (which
implies ``--slam``) runs in the port alone (its trajectory equals a direct ``SlamSystem`` run's; every
output reads back); its JAX twin, which compiles the whole system, is slow.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vo_slam_test_tpu import run_slam as jrun_slam  # noqa: E402
from vo_slam_test_tpu.datasets import SyntheticRGBD  # noqa: E402
from vo_slam_test_tpu_torch import run_slam  # noqa: E402
from vo_slam_test_tpu_torch.bow.vocabulary import Vocabulary  # noqa: E402
from vo_slam_test_tpu_torch.config import SlamConfig  # noqa: E402
from vo_slam_test_tpu_torch.datasets import TumDataset, write_trajectory_tum  # noqa: E402
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem  # noqa: E402

W, H, N = 320, 240, 6
COUNTS = re.compile(r"^frame +(\d+) .*ok=(\d) feats= *(\d+) matches= *(\d+) inliers= *(\d+)")


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum_cli")
    os.makedirs(d / "rgb")
    os.makedirs(d / "depth")
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    lines = []
    for i in range(N):
        g, dep, t = seq[i]
        cv2.imwrite(str(d / "rgb" / f"{t:.6f}.png"), cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))
        cv2.imwrite(str(d / "depth" / f"{t:.6f}.png"), np.round(dep * 5000).astype(np.uint16))
        lines.append(f"{t:.6f} rgb/{t:.6f}.png {t:.6f} depth/{t:.6f}.png")
    (d / "associate.txt").write_text("\n".join(lines) + "\n")
    keys = {"dataset_dir": str(d), "camera_fx": seq.fx, "camera_fy": seq.fy,
            "camera_cx": seq.cx, "camera_cy": seq.cy, "camera_k1": 0, "camera_k2": 0,
            "camera_p1": 0, "camera_p2": 0, "camera_k3": 0, "camera_depthScale": 5000,
            "camera_width": W, "camera_height": H, "num_of_features": 500, "level_pyramid": 4,
            "scale_factor": 1.2, "camera_fps": 30, "camera_bf": 40.0, "thDepth": 40.0}
    (d / "cfg.yaml").write_text("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in keys.items()))
    return d


def cli(main, argv, capsys, **kw):
    rc = main(argv, **kw)
    out = capsys.readouterr().out
    return rc, out


def counts(out):
    return [tuple(int(x) for x in m.groups()) for m in map(COUNTS.match, out.splitlines()) if m]


def read_traj(path):
    return np.loadtxt(path, ndmin=2)


@pytest.mark.parametrize("mode", [["--sync"], []])
def test_cli_equal_jax(tum_dir, tmp_path, capsys, mode):
    cfg = str(tum_dir / "cfg.yaml")
    got_path, want_path = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    rc, out = cli(run_slam.main, [cfg, *mode, "--camera-out", got_path], capsys, device="cpu")
    jrc, jout = cli(jrun_slam.main, [cfg, *mode, "--camera-out", want_path], capsys)
    assert rc == jrc == 0
    assert counts(out) == counts(jout) and len(counts(out)) == N
    assert all(c[1] == 1 for c in counts(out))
    got, want = read_traj(got_path), read_traj(want_path)
    assert got.shape == want.shape == (N, 8)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert f"tracked {N}/{N} frames" in out
    assert "kernel build: none (plain versions on the CPU)" in out
    # every line but the timings, the output path and the build line is the
    # JAX package's
    strip = re.compile(r" *[0-9.]+ ms|\(incl\. first-frame .*\)")
    assert [strip.sub("", x).replace(got_path, "OUT") for x in out.splitlines()
            if not x.startswith("kernel build")] == \
        [strip.sub("", x).replace(want_path, "OUT") for x in jout.splitlines()]


def test_help_lists_the_jax_flags(capsys):
    for main in (run_slam.main, jrun_slam.main):
        with pytest.raises(SystemExit) as e:
            main(["--help"])
        assert e.value.code == 0
    helps = capsys.readouterr().out
    port_help, jax_help = helps[:len(helps) // 2], helps[len(helps) // 2:]
    assert port_help == jax_help
    flags = set(re.findall(r"--[a-z-]+", port_help))
    assert {"--synthetic", "--sync", "--slam", "--chunk", "--vocabulary", "--viewer-out",
            "--viewer-live", "--hud-out", "--events-out", "--global-ba", "--reloc-parity"} <= flags


def test_config_singleton_equal_jax(tum_dir):
    """``config.set_parameter_file`` / ``get``, the reference's Config
    singleton, read the written YAML as the JAX package's do."""
    from vo_slam_test_tpu import config as jconfig
    from vo_slam_test_tpu_torch import config

    path = str(tum_dir / "cfg.yaml")
    cfg, jcfg = config.set_parameter_file(path), jconfig.set_parameter_file(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for key in ("camera_fx", "level_pyramid", "dataset_dir", "max_lost"):
        assert config.get(key) == jconfig.get(key)
    assert config.get("not_a_key", 7) == 7
    with pytest.raises(KeyError):
        config.get("not_a_key")


def test_missing_config_is_an_error(capsys):
    with pytest.raises(SystemExit) as e:
        run_slam.main([], device="cpu")
    assert e.value.code == 2
    assert "either a config yaml or --synthetic is required" in capsys.readouterr().err


@pytest.fixture(scope="module")
def slam_run(tum_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("slam_out")
    paths = {k: str(out / v) for k, v in dict(
        cam="cam.txt", kf="kf.txt", voc="voc.npz", metrics="m.csv", events="ev.json",
        viewer="v.html", hud="hud", map="map.png").items()}
    # no --slam: the output flags imply it
    argv = [str(tum_dir / "cfg.yaml"), "--chunk", "2",
            "--camera-out", paths["cam"], "--keyframe-out", paths["kf"],
            "--vocabulary-out", paths["voc"], "--metrics-out", paths["metrics"],
            "--events-out", paths["events"], "--viewer-out", paths["viewer"],
            "--viewer-live", "2", "--hud-out", paths["hud"], "--hud-every", "2",
            "--map-out", paths["map"]]
    return argv, paths


def test_slam_outputs_read_back(slam_run, tum_dir, tmp_path, capsys):
    argv, p = slam_run
    rc, out = cli(run_slam.main, argv, capsys, device="cpu")
    assert rc == 0
    # the trajectory equals a direct SlamSystem run's over the same files
    cfg = SlamConfig.from_yaml(str(tum_dir / "cfg.yaml"))
    s = SlamSystem(cfg, device="cpu", chunk=2)
    ds = TumDataset(cfg.dataset_dir, width=W, height=H)
    for i in range(len(ds)):
        s.track(*ds[i])
    traj, stats, kf_traj = s.results()
    direct = str(tmp_path / "direct.txt")
    write_trajectory_tum(direct, s.timestamps, traj)
    assert open(p["cam"]).read() == open(direct).read()

    ev = json.load(open(p["events"]))
    assert ev["n_frames"] == ev["n_tracked"] == N and ev["n_keyframes"] == s.n_keyframes
    assert ev["reloc_frames"] == [] and ev["loop_frames"] == [] and ev["ate_rmse_m"] is None
    assert ev["wall_ms_per_frame"] > 0
    kf = read_traj(p["kf"])
    assert kf.shape == (ev["n_keyframes"], 8) and ev["n_keyframes"] >= 2
    np.testing.assert_allclose(kf[:, 0], [t for t, _ in kf_traj], atol=1e-6)
    lines = open(p["metrics"]).read().strip().splitlines()
    assert lines[0] == "timestamp,ok,n_features,n_matches,n_inliers" and len(lines) == N + 1
    assert [int(x.split(",")[1]) for x in lines[1:]] == [int(st.ok) for st in stats]
    voc = Vocabulary.load(p["voc"], "cpu")
    assert voc.k == 10 and voc.levels == 4 and voc.n_words > 0
    html = open(p["viewer"]).read()
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html, re.S).group(1))
    assert len(data["kf"]) == ev["n_keyframes"] and len(data["traj"]) == N
    assert 'http-equiv="refresh"' not in html  # the final export is not the live one
    # numbered by their order among the rendered frames, as the JAX CLI numbers them
    assert sorted(os.listdir(p["hud"])) == [f"hud_{k:05d}.png" for k in range(len(range(0, N, 2)))]
    assert os.path.getsize(p["map"]) > 1000
    for line in ("keyframe trajectory saved to", "scene vocabulary saved to",
                 f"{len(range(0, N, 2))} HUD frames saved to", "map render saved to",
                 "interactive viewer saved to", "run events saved to", "metrics saved to",
                 f"keyframes: {s.n_keyframes}  map points: {s.n_points}"):
        assert line in out, line


@pytest.mark.slow
def test_slam_equal_jax(slam_run, tmp_path, capsys):
    """The JAX twin of the --slam run (compiles the whole JAX system): the
    same tracked frames and keyframe count, trajectories within 1e-4."""
    cfg = slam_run[0][0]
    got, want = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    ev, jev = str(tmp_path / "ev.json"), str(tmp_path / "jev.json")
    rc, out = cli(run_slam.main, [cfg, "--slam", "--chunk", "2", "--camera-out", got,
                                  "--events-out", ev], capsys, device="cpu")
    jrc, jout = cli(jrun_slam.main, [cfg, "--slam", "--chunk", "2", "--camera-out", want,
                                     "--events-out", jev], capsys)
    assert rc == jrc == 0
    e, je = json.load(open(ev)), json.load(open(jev))
    for k in ("n_frames", "n_tracked", "n_keyframes", "reloc_frames", "loop_frames"):
        assert e[k] == je[k], k
    np.testing.assert_allclose(read_traj(got), read_traj(want), atol=1e-4)
