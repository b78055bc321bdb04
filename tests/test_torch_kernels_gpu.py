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
from vo_slam_test_tpu_torch.ops import (ba_cuda, ba_pallas, brief, fast, fast_cuda, match_cuda,
                                        match_pallas, orb_cuda)
from vo_slam_test_tpu_torch.ops import orientation
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior
from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (check_ba, random_ba_instance, random_chi2_instance,  # noqa: E402
                        random_epi_instance, random_nb_instance, random_top2_instance)

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


def test_slam_system_runs_local_ba_on_card(cuda):
    """interruptBA lowered (the default): the keyframe events at frames 0, 1
    and 5 of the room orbit run local BA, each BA kernel launching once per
    LM iteration the solver reports."""
    seq = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    s = SlamSystem(cfg)
    kernels = (ba_cuda.KERNEL_ACC, ba_cuda.KERNEL_COST, ba_cuda.KERNEL_BACKSUB)
    before = [k.launches for k in kernels]
    for i in range(6):
        s.track(*seq[i])
    traj, stats, _ = s.results()
    assert all(st.ok for st in stats)
    assert [f for f, _, _ in s.ba_iters] == [i for i, o in enumerate(s._outs) if o.made_kf]
    assert all(n1 > 0 for _, n1, _ in s.ba_iters)
    n_iter = sum(n1 + n2 for _, n1, n2 in s.ba_iters)
    assert [k.launches - b for k, b in zip(kernels, before)] == [n_iter] * 3
    gt = np.stack([seq.poses[i] for i in range(6)])
    assert ate_rmse(s.timestamps, gt, s.timestamps, traj) < 0.01


def _ba_instance(cuda, huber):
    inst = random_ba_instance(np.random.default_rng(11 + huber), 32, 16, 12, 4096, 900, cuda)
    inst["huber"] = huber
    return inst


def _acc_args(inst):
    return (inst["lam"], inst["posesT"], inst["X"], inst["slot"], inst["u"], inst["v"],
            inst["ur"], inst["isig2"], inst["act"], inst["povar"], inst["cam5"], inst["wk"],
            inst["huber"])


@pytest.mark.parametrize("huber", [True, False])
def test_ba_accumulate_kernel_matches_plain(cuda, huber):
    """Tolerances: chip_smoke.check_ba (the JAX package's kernel-test
    tolerances, tests/test_local_ba.py:201-209)."""
    inst = _ba_instance(cuda, huber)
    before = ba_cuda.KERNEL_ACC.launches
    got = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    assert ba_cuda.KERNEL_ACC.launches == before + 1
    want = ba_pallas.ba_accumulate_plain(*_acc_args(inst))
    torch.cuda.synchronize()
    check_ba("ba_accumulate", "acc", got, inst, want)
    # pads (past n_pts) contribute nothing and keep zero Wc rows
    assert (got[7][:, :, 900:] == 0).all() and (got[6][:, 900:] == 0).all()


@pytest.mark.parametrize("huber", [True, False])
def test_ba_cost_kernel_matches_plain(cuda, huber):
    inst = _ba_instance(cuda, huber)
    args = _acc_args(inst)[1:9] + (inst["cam5"], huber)
    before = ba_cuda.KERNEL_COST.launches
    got = ba_cuda.ba_cost(*args, n_pts=inst["n_pts"])
    assert ba_cuda.KERNEL_COST.launches == before + 1
    check_ba("ba_cost", "cost", got, inst, ba_pallas.ba_cost_plain(*args))
    # the accumulate kernel's cost on the same inputs is the same sum, bit for bit
    acc = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    torch.cuda.synchronize()
    assert torch.equal(acc[4], got)


def test_ba_backsub_kernel_matches_plain(cuda):
    inst = _ba_instance(cuda, True)
    acc = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    dxp = torch.as_tensor(np.random.default_rng(5).normal(0, 1e-3, (16, 6)),
                          dtype=torch.float32).to(cuda)
    sub = (acc[7], acc[5], acc[6], dxp)
    before = ba_cuda.KERNEL_BACKSUB.launches
    got = ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"])
    assert ba_cuda.KERNEL_BACKSUB.launches == before + 1
    want = ba_pallas.ba_backsub_plain(*sub)
    torch.cuda.synchronize()
    check_ba("ba_backsub", "backsub", got, sub, want)


def test_ba_kernels_deterministic(cuda):
    """Two launches on the same inputs give bit-equal outputs: no float sum
    depends on the order blocks run in."""
    inst = _ba_instance(cuda, True)
    a = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    b = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    args = _acc_args(inst)[1:9] + (inst["cam5"], True)
    c1, c2 = (ba_cuda.ba_cost(*args, n_pts=inst["n_pts"]) for _ in range(2))
    sub = (a[7], a[5], a[6], torch.full((16, 6), 1e-3, device=cuda))
    d1, d2 = (ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"]) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip((*a, c1, d1), (*b, c2, d2)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


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
                 "pipeline.system", "solvers.local_ba", "ops.ba_cuda", "ops.ba_pallas"):
        assert pkg.__name__ + "." + name in sys.modules
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vo_slam_test_tpu")]
    assert not bad, bad
