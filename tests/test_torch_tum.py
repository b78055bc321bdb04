"""The port's TUM reader against the JAX package's: ``read_associate``, and
``TumDataset`` through the native loader and through the Python readers on a
4-frame dataset written with cv2 as ``tests/test_native_loader.py`` writes it
(coloured RGB, so the luma conversion is exercised). Frames must be
bit-equal to the JAX ``TumDataset``'s; depth leaves as f32 meters."""

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vo_slam_test_tpu.datasets import SyntheticRGBD  # noqa: E402
from vo_slam_test_tpu.datasets import tum as jtum  # noqa: E402
from vo_slam_test_tpu_torch.datasets import tum  # noqa: E402
from vo_slam_test_tpu_torch.native import loader  # noqa: E402
from vo_slam_test_tpu_torch.ops._build import BUILD_DIR  # noqa: E402

W, H = 160, 120


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    os.makedirs(d / "rgb")
    os.makedirs(d / "depth")
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.25, fy=516.5 * 0.25, cx=318.6 * 0.25,
                        cy=255.3 * 0.25, n_frames=4, seed=3)
    lines = ["# timestamp rgb timestamp depth", ""]
    for i in range(4):
        gray, depth, t = seq[i]
        rgb = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        rgb[..., 0] = np.clip(rgb[..., 0].astype(int) + 20, 0, 255).astype(np.uint8)
        cv2.imwrite(str(d / "rgb" / f"{i}.png"), rgb)
        cv2.imwrite(str(d / "depth" / f"{i}.png"), (depth * 5000.0).astype(np.uint16))
        lines.append(f"{1000 + t:.6f} rgb/{i}.png {1000 + t + 0.01:.6f} depth/{i}.png")
    lines.insert(3, "1000.5 rgb/short_line.png")  # fewer than four fields: skipped
    (d / "associate.txt").write_text("\n".join(lines) + "\n")
    return str(d)


@pytest.mark.parametrize("limit", [0, 1, 3, 9])
def test_read_associate_equal_jax(dataset, limit):
    got = tum.read_associate(dataset, limit=limit)
    want = jtum.read_associate(dataset, limit=limit)
    assert [vars(f) for f in got] == [vars(f) for f in want]
    assert len(got) == (min(limit, 4) if limit else 4)
    assert got[0].rgb_path == os.path.join(dataset, "rgb/0.png")


def assert_frames_equal(got, want, n=4):
    for i in range(n):
        (g, d, t), (jg, jd, jt) = got[i], want[i]
        assert g.dtype == jg.dtype == np.uint8 and d.dtype == jd.dtype == np.float32
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(d, jd)
        assert t == jt


def test_native_reader_equal_jax(dataset):
    got = tum.TumDataset(dataset, width=W, height=H)
    assert got.reader == "native" and got.native_error == ""
    want = jtum.TumDataset(dataset, width=W, height=H)
    assert want._native is not None
    assert_frames_equal(got, want)
    assert got.reader == "native"
    # the decoded gray is BT.601 luma with cv::cvtColor's fixed-point rounding
    rgb = cv2.cvtColor(cv2.imread(os.path.join(dataset, "rgb/0.png")), cv2.COLOR_BGR2RGB)
    r, g, b = (rgb[..., c].astype(int) for c in range(3))
    luma = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)
    np.testing.assert_array_equal(tum.TumDataset(dataset, width=W, height=H)[0][0], luma)


def test_python_reader_equal_jax(dataset):
    got = tum.TumDataset(dataset, use_native=False)
    assert got.reader == "cv2" and got.native_error == "use_native=False"
    assert_frames_equal(got, jtum.TumDataset(dataset, use_native=False))


def test_imageio_reader_equal_jax(dataset, monkeypatch):
    """Without cv2 both packages read through imageio (float BT.601 luma)."""
    pytest.importorskip("imageio")
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tum.TumDataset(dataset, use_native=False)
    assert got.reader == "imageio"
    assert_frames_equal(got, jtum.TumDataset(dataset, use_native=False))


def test_random_access_falls_back_to_python(dataset):
    ds = tum.TumDataset(dataset, width=W, height=H)
    want = jtum.TumDataset(dataset, use_native=False)
    g, d, t = ds[2]  # not the next frame in sequence: the Python reader serves
    assert ds.reader == "cv2"
    np.testing.assert_array_equal(g, want[2][0])
    np.testing.assert_array_equal(d, want[2][1])


def test_depth_in_meters(dataset):
    ds = tum.TumDataset(dataset, width=W, height=H)
    _, d, _ = ds[0]
    raw = cv2.imread(os.path.join(dataset, "depth/0.png"), cv2.IMREAD_UNCHANGED)
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(d, raw.astype(np.float32) * np.float32(1.0 / 5000.0))


def test_native_sequential_only(dataset):
    frames = tum.read_associate(dataset)
    ld = loader.NativeTumLoader([f.rgb_path for f in frames], [f.depth_path for f in frames],
                                [float(f.rgb_time) for f in frames], width=W, height=H)
    ld[0]
    with pytest.raises(ValueError, match="sequential"):
        ld[3]
    ld.close()
    ld.close()  # a second close is a no-op


def test_native_library_in_build_dir():
    assert loader.native_available(), loader.build_error()
    so = loader.library_path()
    assert so.parent == BUILD_DIR and so.exists()
    assert so.name.startswith("libvoio-") and so.suffix == ".so"
    assert BUILD_DIR.parent.name == "vo_slam_test_tpu_torch"
