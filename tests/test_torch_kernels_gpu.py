"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card (no JAX needed there):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Without a card every test skips (decided in a fixture, never at import).
"""

import os
import sys

import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, ate_rmse
from vo_slam_test_tpu_torch.frontend.extractor import select_keypoints
from vo_slam_test_tpu_torch.ops import brief, fast, fast_cuda, match_cuda, match_pallas, orb_cuda
from vo_slam_test_tpu_torch.ops import orientation
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior
from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (random_chi2_instance, random_epi_instance,  # noqa: E402
                        random_nb_instance, random_top2_instance)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frame_pyramid(cuda):
    seq = SyntheticRGBD(n_frames=2, seed=0, motion_scale=0.5)
    gray, _, _ = seq[0]
    spec = PyramidSpec(640, 480, 8, 1.2)
    return spec, build_pyramid(torch.as_tensor(gray).to(cuda), spec)


def test_fast_kernel_matches_plain(frame_pyramid):
    spec, pyr = frame_pyramid
    levels = interior(pyr.raw, spec)
    before = fast_cuda.KERNEL.launches
    got = fast_cuda.fast_score(levels)
    want = fast.fast_score(levels)
    torch.cuda.synchronize()
    assert fast_cuda.KERNEL.launches == before + 1
    assert torch.equal(got, want)
    a = fast.select_candidates(got, spec)
    b = fast.select_candidates(want, spec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_orb_kernel_matches_plain(frame_pyramid):
    spec, pyr = frame_pyramid
    sel = select_keypoints(pyr, spec, spec.budget(1000))
    ang, desc = orb_cuda.orb_angle_desc(pyr.raw, pyr.blur, sel.level, sel.ys, sel.xs)
    ang_ref = orientation.ic_angle(pyr.raw, sel.level, sel.ys, sel.xs)
    desc_ref = brief.compute_descriptors(pyr.blur, sel.level, sel.ys, sel.xs, ang_ref)
    torch.cuda.synchronize()
    d = (ang - ang_ref).abs().cpu().numpy()
    assert np.minimum(d, 360 - d).max() <= 1e-3
    x = (desc ^ desc_ref).cpu().numpy().view(np.uint8)
    assert np.unpackbits(x, axis=1).sum(1).max() == 0


@pytest.mark.parametrize("M,N", [(1024, 1024), (4096, 1024), (1000, 777)])
def test_match_kernel_matches_plain(cuda, M, N):
    args = random_top2_instance(np.random.default_rng(M + N), M, N, cuda)
    got = match_cuda.masked_top2(*args)
    want = match_pallas.masked_top2_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][:16] == match_pallas.BIG).all() and (got[0][:16] == 0).all()


def test_fused_tracker_runs_on_card(cuda):
    # the first 6 frames of the 30-frame sequence (the per-frame motion of
    # the synthetic trajectory scales with 1/n_frames)
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    tr = FusedTracker(cfg)
    counts = [k.KERNEL.launches for k in (fast_cuda, orb_cuda, match_cuda)]
    for i in range(6):
        tr.track(*seq[i])
    traj, stats = tr.results()
    assert all(s.ok for s in stats)
    after = [k.KERNEL.launches for k in (fast_cuda, orb_cuda, match_cuda)]
    assert after[0] - counts[0] == 6 and after[1] - counts[1] == 6 and after[2] - counts[2] >= 5
    gt = np.stack([seq.poses[i] for i in range(6)])
    assert ate_rmse(tr.timestamps, gt, tr.timestamps, traj) < 0.01


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("M,N", [(4096, 1024), (1000, 777)])
def test_chi2_kernel_matches_plain(cuda, M, N):
    x = random_chi2_instance(np.random.default_rng(M + N + 1), M, N, cuda)
    before = match_cuda.KERNEL_CHI2.launches
    got = match_cuda.masked_top2(*x[:15], col_isig2=x[15], chi2_gate=True)
    assert match_cuda.KERNEL_CHI2.launches == before + 1
    _equal(got, match_pallas.masked_top2_plain(*x[:15], col_isig2=x[15], chi2_gate=True))
    assert (got[1][:16] == match_pallas.BIG).all()


@pytest.mark.parametrize("B,M,N,shared", [(16, 1024, 1024, True), (3, 1000, 777, False)])
def test_nb_kernel_matches_plain(cuda, B, M, N, shared):
    x = random_nb_instance(np.random.default_rng(B + M + N), B, M, N, cuda)
    if not shared:
        x[0] = x[0].contiguous()
    before = match_cuda.KERNEL_NB.launches
    got = match_cuda.masked_top2_nb(*x[:15], col_isig2=x[15], chi2_gate=True)
    assert match_cuda.KERNEL_NB.launches == before + 1
    _equal(got, match_pallas.masked_top2_nb_plain(*x[:15], col_isig2=x[15], chi2_gate=True))


@pytest.mark.parametrize("M,N", [(1024, 1024), (1000, 777)])
def test_epi_kernel_matches_plain(cuda, M, N):
    x = random_epi_instance(np.random.default_rng(M + N + 2), M, N, cuda)
    before = match_cuda.KERNEL_EPI.launches
    got = match_cuda.masked_top1_epi(*x)
    assert match_cuda.KERNEL_EPI.launches == before + 1
    _equal(got, match_pallas.masked_top1_epi_plain(*x))
    assert (got[1][:16] == match_pallas.BIG).all() and (got[0][:16] == 0).all()


def test_slam_system_runs_on_card(cuda):
    """The first 6 frames of the 240-frame room orbit at 640x480: keyframe
    events at frames 0, 1 and 5, each launching the chi2 and the
    neighbour-batched kernel once; the local-map search on every frame after
    the first."""
    seq = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    s = SlamSystem(cfg)
    s._force_interrupt_ba = True
    kernels = (match_cuda.KERNEL_CHI2, match_cuda.KERNEL_NB, match_cuda.KERNEL_LOCAL)
    before = [k.launches for k in kernels]
    for i in range(6):
        s.track(*seq[i])
    traj, stats, _ = s.results()
    events = sum(o.made_kf for o in s._outs)
    assert all(st.ok for st in stats) and events >= 2
    assert match_cuda.KERNEL_CHI2.launches - before[0] == events
    assert match_cuda.KERNEL_NB.launches - before[1] == events
    assert match_cuda.KERNEL_LOCAL.launches - before[2] == 5
    gt = np.stack([seq.poses[i] for i in range(6)])
    assert ate_rmse(s.timestamps, gt, s.timestamps, traj) < 0.01


def test_slam_system_without_interrupt_raises(cuda):
    """Local BA is not ported: a keyframe event with interruptBA lowered
    raises instead of skipping BA silently."""
    seq = SyntheticRGBD(n_frames=2, seed=0)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    with pytest.raises(NotImplementedError, match="local BA"):
        SlamSystem(cfg).track(*seq[0])


def test_port_modules_import_no_jax(cuda):
    """On the card's machine: every module of the port, the mapping slice's
    included, imports without JAX or the JAX package."""
    import importlib
    import pkgutil

    import vo_slam_test_tpu_torch as pkg

    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    for name in ("slam_map.map_state", "slam_map.insert", "slam_map.local_map",
                 "slam_map.culling", "slam_map.fuse", "slam_map.triangulate",
                 "pipeline.system", "solvers.local_ba"):
        assert pkg.__name__ + "." + name in sys.modules
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vo_slam_test_tpu")]
    assert not bad, bad
