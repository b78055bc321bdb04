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
from vo_slam_test_tpu_torch.ops.epi_instances import EPI_EDGE_CASES
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior
from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
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


def test_fast_nms_kernel_matches_plain(frame_pyramid):
    spec, pyr = frame_pyramid
    levels = interior(pyr.raw, spec)
    before = (fast_cuda.KERNEL.launches, fast_cuda.KERNEL_NMS.launches)
    got = fast_cuda.fast_score(levels, with_nms=True)
    torch.cuda.synchronize()
    assert (fast_cuda.KERNEL.launches, fast_cuda.KERNEL_NMS.launches) == (before[0],
                                                                          before[1] + 1)
    assert torch.equal(got, fast.fast_score_nms(levels))
    assert bool((got > 0).any())


@pytest.mark.parametrize("shape", [(2, 480, 640), (1, 4, 4), (2, 17, 29), (1, 33, 65),
                                   (3, 5, 100)])
def test_fast_nms_kernel_random_integers(cuda, shape):
    """Integers in [0, 255] (many ties), tile-ragged shapes, both axes wrapping."""
    levels = torch.as_tensor(np.random.default_rng(sum(shape)).integers(
        0, 256, shape).astype(np.float32)).to(cuda)
    assert torch.equal(fast_cuda.fast_score(levels, with_nms=True), fast.fast_score_nms(levels))
    assert torch.equal(fast_cuda.fast_score(levels), fast.fast_score(levels))


@pytest.fixture(scope="module")
def fast_nms_v1(cuda):
    """The first design of the NMS mode (``perf/fast_nms_v1.cu``), built
    beside the current kernel."""
    from vo_slam_test_tpu_torch.ops import _build

    _build.build(extra=chip_smoke.V1_SOURCES)
    return chip_smoke.fast_nms_v1_launcher(_build)


def _nms_tile_input(kind, cuda):
    """Inputs at the edges of the NMS mode's 64x16 tile: integers in [0, 255]."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "w100":
        x = rng.integers(0, 256, (2, 40, 100))
    elif kind == "w33":
        x = rng.integers(0, 256, (1, 24, 33))
    elif kind == "h_ragged":  # H not a multiple of 16, one row past a tile and one short
        x = rng.integers(0, 256, (3, 17, 128))
        x[1:, 16] = 0
    elif kind == "h47":
        x = rng.integers(0, 256, (2, 47, 64))
    elif kind == "4x4":
        x = rng.integers(0, 256, (3, 4, 4))
    elif kind == "plateaus":  # flat squares and steps: runs of equal scores
        x = np.zeros((2, 48, 160))
        x[0, 8:30, 20:90] = 120
        x[0, 12:20, 40:70] = 200
        x[0, 30:40, 100:150] = rng.integers(0, 2, (10, 50)) * 255
        x[1] = np.repeat(np.repeat(rng.integers(0, 3, (6, 20)) * 100, 8, 0), 8, 1)
    elif kind == "one_live_block":  # every block dead but one, inside level 2
        x = np.zeros((4, 64, 192))
        x[2, 20:28, 72:120] = rng.integers(0, 256, (8, 48))
    else:  # "strided": the interior of a wider canvas, rows not 16-byte aligned
        canvas = rng.integers(0, 256, (3, 90, 230)).astype(np.float32)
        return torch.as_tensor(canvas).to(cuda)[:, 19:19 + 51, 19:19 + 173]
    return torch.as_tensor(x.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("kind", ["w100", "w33", "h_ragged", "h47", "4x4", "strided",
                                  "plateaus", "one_live_block"])
def test_fast_nms_kernel_tile_edges(cuda, fast_nms_v1, kind):
    """The NMS mode at the edges of its tile (W and H not multiples of it, the
    smallest legal level, a strided view, plateaus where ties suppress both
    pixels, one live block among dead ones): equal to the plain version on
    every pixel and to the first design bit for bit."""
    levels = _nms_tile_input(kind, cuda)
    before = fast_cuda.KERNEL_NMS.launches
    got = fast_cuda.fast_score(levels, with_nms=True)
    torch.cuda.synchronize()
    assert fast_cuda.KERNEL_NMS.launches == before + 1
    assert got.is_contiguous() and torch.equal(got, fast.fast_score_nms(levels))
    assert chip_smoke.bits_equal(got, chip_smoke.fast_call(fast_nms_v1, levels))
    score = fast.fast_score(levels)
    if kind == "plateaus":
        # a scored pixel with an equal neighbour is never kept
        tied = torch.zeros_like(score, dtype=torch.bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    tied |= score == torch.roll(score, (dy, dx), (-2, -1))
        assert bool((tied & (score > 0)).any()) and not bool((got[tied] > 0).any())
    if kind == "one_live_block":
        assert bool((got[2] > 0).any())
        assert not bool(got[[0, 1, 3]].any()) and not bool(got[2, :14].any())


def test_local_ba_mesh_on_card(cuda):
    """local_bundle_adjust_mesh with 8 shards of the card against
    local_bundle_adjust on the room orbit's map after frame 5 (tests/
    test_parallel.py's tolerances), each BA kernel launched once per LM
    iteration on each shard, and a dead shard's launches all zero."""
    from vo_slam_test_tpu_torch import parallel
    from vo_slam_test_tpu_torch.solvers import local_ba

    seq = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    s = SlamSystem(cfg)
    for i in range(6):
        s.track(*seq[i])
    m, caps, cam = s.map, s.caps, s.camera
    inv = 1.0 / (s.scale_factors * s.scale_factors)
    kf = int(torch.argmax(torch.where(m.kf_valid, m.kf_seq, -1)))
    mesh = parallel.make_obs_mesh(8)
    assert (mesh.n_shards, mesh.n_devices) == (8, 1)
    kernels = (ba_cuda.KERNEL_ACC, ba_cuda.KERNEL_COST, ba_cuda.KERNEL_BACKSUB)
    single, n1, n2 = local_ba.local_bundle_adjust_iters(chip_smoke.map_copy(m), kf, caps, cam,
                                                        inv)
    before = [k.launches for k in kernels]
    meshed, k1, k2 = local_ba.local_bundle_adjust_mesh_iters(chip_smoke.map_copy(m), kf, caps,
                                                             cam, mesh, inv)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [8 * (k1 + k2)] * 3
    assert torch.equal(meshed.pt_obs_cnt, single.pt_obs_cnt)
    assert float((meshed.kf_pose - single.kf_pose).abs().max()) <= 5e-4
    live = (meshed.pt_valid & single.pt_valid).cpu()
    assert float((meshed.pt_pos - single.pt_pos).abs().cpu()[live].max()) <= 5e-3
    prob = local_ba.build_problem_ol(m, kf, caps, inv)
    n_live = [int(x.sum()) for x in mesh.split(prob.pt_ids >= 0)]
    assert n_live[0] > 0 and n_live[-1] == 0
    chip_smoke.check_dead_shard(m, kf, caps, cam, inv, mesh, n_live)


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


def test_host_extractor_on_card_matches_cpu(cuda):
    """The host-path OrbExtractor (FAST and ORB kernels around one host read
    and the host quad-tree) on the card against the same class on the CPU,
    on frame 0 of the 30-frame corner sequence: every field equal, angles
    within 1e-3 deg."""
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.frontend.extractor import OrbExtractor

    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    gray, depth, _ = seq[0]
    before = [k.KERNEL.launches for k in (fast_cuda, orb_cuda)]
    got = OrbExtractor(Camera.from_config(cfg, cuda))(gray, depth)
    torch.cuda.synchronize()
    assert [k.KERNEL.launches for k in (fast_cuda, orb_cuda)] == [b + 1 for b in before]
    want = OrbExtractor(Camera.from_config(cfg, "cpu"))(gray, depth)
    for name in ("uv", "uv_und", "octave", "valid", "desc", "response", "depth", "u_right"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    d = (got.angle.cpu() - want.angle).abs()
    assert float(torch.minimum(d, 360 - d).max()) <= 1e-3
    assert int(got.valid.sum()) > 900


def test_frame_to_frame_tracker_runs_on_card(cuda):
    from vo_slam_test_tpu_torch.pipeline.tracking import FrameToFrameTracker

    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    tr = FrameToFrameTracker(cfg)
    stats = [tr.track(*seq[i]) for i in range(6)]
    assert all(s.ok for s in stats)
    assert all(s.n_matches >= 100 and s.n_inliers >= 50 for s in stats[1:])
    gt = np.stack([seq.poses[i] for i in range(6)])
    assert ate_rmse(tr.timestamps, gt, tr.timestamps, np.stack(tr.trajectory)) < 0.03


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


@pytest.fixture(scope="module")
def epi_v1(cuda):
    """The first design of the epipolar top-1 (``perf/epi_v1.cu``), built
    beside the current kernel."""
    from vo_slam_test_tpu_torch.ops import _build

    _build.build(extra=chip_smoke.V1_SOURCES)
    return chip_smoke.v1_launchers(_build)[2](0)


@pytest.mark.parametrize("kind,M,N", EPI_EDGE_CASES)
def test_epi_kernel_edges(cuda, epi_v1, kind, M, N):
    """NaN/inf lines, den = 0, thr = inf, pairs on the num^2 = den * thr
    boundary (some whose line value a contracted FMA would move), no live
    row, one live row at each position of a 16-row block, ties and odd N:
    the kernel equals the plain version and the first design bit for bit."""
    x = chip_smoke.epi_edge_instance(kind, M, N, cuda)
    before = match_cuda.KERNEL_EPI.launches
    got = match_cuda.masked_top1_epi(*x)
    assert match_cuda.KERNEL_EPI.launches == before + 1
    _equal(got, match_pallas.masked_top1_epi_plain(*x))
    _equal(got, chip_smoke.epi_call(epi_v1, x))
    if kind == "all_dead":
        assert (got[1] == match_pallas.BIG).all() and (got[0] == 0).all()


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
    mask = ba_cuda.ba_mask(4096, cuda)
    acc = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"], mask=mask)
    dxp = torch.as_tensor(np.random.default_rng(5).normal(0, 1e-3, (16, 6)),
                          dtype=torch.float32).to(cuda)
    sub = (acc[7], acc[5], acc[6], dxp)
    before = ba_cuda.KERNEL_BACKSUB.launches
    got = ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"], mask=mask)
    assert ba_cuda.KERNEL_BACKSUB.launches == before + 1
    want = ba_pallas.ba_backsub_plain(*sub)
    torch.cuda.synchronize()
    check_ba("ba_backsub", "backsub", got, sub, want)


def test_ba_kernels_deterministic(cuda):
    """Two launches on the same inputs give bit-equal outputs: no float sum
    depends on the order blocks run in."""
    inst = _ba_instance(cuda, True)
    mask = ba_cuda.ba_mask(4096, cuda)
    a = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"], mask=mask)
    b = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    args = _acc_args(inst)[1:9] + (inst["cam5"], True)
    c1, c2 = (ba_cuda.ba_cost(*args, n_pts=inst["n_pts"]) for _ in range(2))
    sub = (a[7], a[5], a[6], torch.full((16, 6), 1e-3, device=cuda))
    d1, d2 = (ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"], mask=mask) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip((*a, c1, d1), (*b, c2, d2)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


EDGE_KINDS = ["dup", "wk1", "wk32", "unseen", "all_seen", "n0", "nL", "o16"]


def _edge_instance(kind, cuda):
    """Observer structures at the accumulate kernel's edges: a point seen
    twice by one window slot, wk = 1 and wk = 32, a window slot no point
    observes (which also leaves holes in the observer columns), a slot every
    point observes, no live point and only live points."""
    rng = np.random.default_rng(len(kind) * 7 + 3)
    WF, wk, O, L, n_live = {"wk1": (8, 1, 12, 512, 200), "wk32": (40, 32, 12, 512, 300),
                            "n0": (32, 16, 12, 512, 0), "nL": (32, 16, 12, 512, 512),
                            "o16": (32, 16, 16, 512, 300)}.get(kind, (32, 16, 12, 512, 300))
    slot = np.full((O, L), -1, np.int32)
    for p in range(n_live):
        k = rng.integers(2, min(O, WF) + 1)
        slot[:k, p] = rng.choice(WF, k, replace=False)
    if kind == "dup":  # slots 1 and 3 are the fixed ones
        for p in range(0, n_live, 3):
            s = rng.choice([0, 2, 4, 5])
            slot[:, p][slot[:, p] == s] = -1
            slot[0, p] = slot[1, p] = s
            if p % 6 == 0:
                slot[3, p] = s
    elif kind == "unseen":
        slot[slot == 2] = -1
    elif kind == "all_seen":
        slot[slot == 0] = -1
        slot[0, :n_live] = 0
    return random_ba_instance(rng, WF, wk, O, L, n_live, cuda, slot=slot)


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_ba_accumulate_edge_structures(cuda, kind):
    """Against the plain version (chip_smoke.check_ba), two launches
    bit-equal, and the cost bit-equal to ba_cost's."""
    inst = _edge_instance(kind, cuda)
    args = _acc_args(inst)
    got = ba_cuda.ba_accumulate(*args, n_pts=inst["n_pts"])
    again = ba_cuda.ba_accumulate(*args, n_pts=inst["n_pts"],
                                  scratch=ba_cuda.ba_scratch(inst["wk"], 512, cuda))
    want = ba_pallas.ba_accumulate_plain(*args)
    cost = ba_cuda.ba_cost(*args[1:9], inst["cam5"], inst["huber"], n_pts=inst["n_pts"])
    torch.cuda.synchronize()
    check_ba(f"ba_accumulate ({kind})", "acc", got, inst, want)
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(got[4].view(torch.int32), cost.view(torch.int32))
    n = int(inst["n_pts"])
    assert (got[7][:, :, n:] == 0).all() and (got[6][:, n:] == 0).all()
    if kind == "unseen":
        assert (got[0][2] == 0).all() and (got[7][2] == 0).all()
        assert (got[2].reshape(16, 6, 16, 6)[2] == 0).all()


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_ba_backsub_edge_structures(cuda, kind):
    """On the edge structures of the accumulate test: the kernel's mask words
    equal the plain window_mask (0 past n_pts); the back-substitution with
    them is within tolerance of the plain version (chip_smoke.check_ba), two
    launches bit-equal, and bit-equal to the walk over every window slot (an
    all-ones mask), which is the kernel's walk before the mask."""
    inst = _edge_instance(kind, cuda)
    L, n, wk = inst["slot"].shape[1], int(inst["n_pts"]), inst["wk"]
    mask = ba_cuda.ba_mask(L, cuda)
    acc = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"], mask=mask)
    dxp = torch.as_tensor(np.random.default_rng(len(kind)).normal(0, 1e-3, (wk, 6)),
                          dtype=torch.float32).to(cuda)
    sub = (acc[7], acc[5], acc[6], dxp)
    got = ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"], mask=mask)
    again = ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"], mask=mask)
    every = ba_cuda.ba_backsub(*sub, n_pts=inst["n_pts"], mask=torch.full_like(mask, -1))
    want = ba_pallas.ba_backsub_plain(*sub)
    torch.cuda.synchronize()
    plain_mask = ba_pallas.window_mask(inst["slot"][:, :n], inst["povar"][:, :n], wk)
    assert torch.equal(mask[:n], plain_mask) and (mask[n:] == 0).all()
    check_ba(f"ba_backsub ({kind})", "backsub", got, sub, want)
    for other in (again, every):
        assert torch.equal(got.view(torch.int32), other.view(torch.int32))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_ba_backsub_nonfinite_step(cuda, bad):
    """A pose step with NaN or inf (a failed Cholesky) makes every live
    point's step non-finite, as the LM test needs, and leaves the dead points
    at -Hinv bl, bit-equal to a zero step's."""
    inst = _ba_instance(cuda, True)
    n = int(inst["n_pts"])
    mask = ba_cuda.ba_mask(4096, cuda)
    acc = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"], mask=mask)
    dxp = torch.full((16, 6), 1e-3, device=cuda)
    dxp[3, 2] = bad
    got = ba_cuda.ba_backsub(acc[7], acc[5], acc[6], dxp, n_pts=inst["n_pts"], mask=mask)
    zero = (acc[7], acc[5], acc[6], torch.zeros_like(dxp))
    still = ba_cuda.ba_backsub(*zero, n_pts=inst["n_pts"], mask=mask)
    torch.cuda.synchronize()
    assert not torch.isfinite(got[:, :n]).any()
    assert torch.equal(got[:, n:].view(torch.int32), still[:, n:].view(torch.int32))
    check_ba("ba_backsub, zero step", "backsub", still, zero, ba_pallas.ba_backsub_plain(*zero))


def test_ba_backsub_requires_mask_on_card(cuda):
    inst = _ba_instance(cuda, True)
    acc = ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])
    with pytest.raises(ValueError, match="mask"):
        ba_cuda.ba_backsub(acc[7], acc[5], acc[6], torch.zeros((16, 6), device=cuda),
                           n_pts=inst["n_pts"])


@pytest.mark.parametrize("n_live,O", [(0, 1), (0, 16), (512, 1), (512, 16)])
def test_ba_cost_kernel_edges(cuda, n_live, O):
    """No live point (cost 0) and only live points, with O = 1 and 16: the
    cost is within tolerance of the plain version and bit-equal to
    ba_accumulate's; the arrival counter reads 0 after a call and after a
    replayed CUDA graph of 50 calls, which all give the same bits."""
    rng = np.random.default_rng(O * 1000 + n_live)
    slot = None
    if O == 1:
        slot = np.full((1, 512), -1, np.int32)
        slot[0, :n_live] = rng.integers(0, 32, n_live)
    inst = random_ba_instance(rng, 32, 16, O, 512, n_live, cuda, slot=slot)
    args = _acc_args(inst)
    cost_args = args[1:9] + (inst["cam5"], True)
    cost = ba_cuda.ba_cost(*cost_args, n_pts=inst["n_pts"])
    acc = ba_cuda.ba_accumulate(*args, n_pts=inst["n_pts"])
    counter = ba_cuda.cost_counter(cuda)
    torch.cuda.synchronize()
    assert int(counter) == 0
    assert torch.equal(cost.view(torch.int32), acc[4].view(torch.int32))
    check_ba(f"ba_cost n={n_live} O={O}", "cost", cost, inst, ba_pallas.ba_cost_plain(*cost_args))
    if n_live == 0:
        assert float(cost) == 0.0
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [ba_cuda.ba_cost(*cost_args, n_pts=inst["n_pts"]) for _ in range(50)]
    g.replay()
    torch.cuda.synchronize()
    assert int(counter) == 0
    assert all(torch.equal(c.view(torch.int32), cost.view(torch.int32)) for c in outs)


def test_ba_accumulate_reuses_its_buffers(cuda):
    """The Wc buffer and the scratch of one BA call serve a second pass with
    fewer active observations: rows of observations that left are zero."""
    inst = _ba_instance(cuda, True)
    args = list(_acc_args(inst))
    scratch = ba_cuda.ba_scratch(inst["wk"], 4096, cuda)
    first = ba_cuda.ba_accumulate(*args, n_pts=inst["n_pts"], scratch=scratch)
    keep = torch.as_tensor(np.random.default_rng(0).random(tuple(args[8].shape)) < 0.7).to(cuda)
    args[8] = args[8] * keep
    args[12] = False
    got = ba_cuda.ba_accumulate(*args, n_pts=inst["n_pts"], wc=first[7], scratch=scratch)
    want = ba_pallas.ba_accumulate_plain(*args)
    torch.cuda.synchronize()
    check_ba("ba_accumulate, second pass", "acc", got, inst, want)


def test_ba_accumulate_rejects_too_many_observers(cuda):
    inst = random_ba_instance(np.random.default_rng(0), 32, 16, 17, 64, 20, cuda)
    with pytest.raises(ValueError):
        ba_cuda.ba_accumulate(*_acc_args(inst), n_pts=inst["n_pts"])


def _fast_inputs(kind, cuda):
    rng = np.random.default_rng(len(kind))
    if kind == "37x53":
        x = rng.integers(0, 256, (1, 37, 53))
    elif kind == "3x96x131":
        x = rng.integers(0, 256, (3, 96, 131))
    elif kind == "zeros":
        x = np.zeros((2, 48, 70))
    elif kind == "constant":
        x = np.full((2, 48, 70), 255)
    elif kind == "corners":  # the ring wraps in both axes
        x = np.zeros((2, 40, 67))
        for (y, xx), v in zip(((0, 0), (0, -1), (-1, 0), (-1, -1)), (255, 90, 17, 200)):
            x[0, y, xx] = v
        x[1, 0, 0] = 1
    elif kind == "tiny":
        x = rng.integers(0, 256, (2, 5, 4))
    else:  # "strided": the interior of a wider canvas, rows not 16-byte aligned
        canvas = rng.integers(0, 256, (3, 70, 150)).astype(np.float32)
        return torch.as_tensor(canvas).to(cuda)[:, 19:19 + 45, 19:19 + 101]
    return torch.as_tensor(x.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("kind", ["37x53", "3x96x131", "zeros", "constant", "corners", "tiny",
                                  "strided"])
def test_fast_kernel_edge_inputs(cuda, kind):
    levels = _fast_inputs(kind, cuda)
    before = fast_cuda.KERNEL.launches
    got = fast_cuda.fast_score(levels)
    torch.cuda.synchronize()
    assert fast_cuda.KERNEL.launches == before + 1
    assert got.is_contiguous() and torch.equal(got, fast.fast_score(levels))
    if kind in ("zeros", "constant"):
        assert (got == 0).all()


# (M, N) of each top-2 edge case; "live_tail": live rows only past row 4000
_TOP2_SHAPES = {"all_dead": (1024, 1024), "live_tail": (4096, 1024), "outside": (1024, 1024),
                "window_edge": (256, 1024), "big_window": (1024, 1024), "n1": (1024, 1),
                "n777": (1000, 777), "n5000": (1024, 5000)}
_ODD = [-5.0, -1e-3, 0.0, 479.99, 480.0, 512.0, 520.0, 700.0, 1e6, -1e6, float("inf"),
        float("-inf"), float("nan")]


def _top2_edge_one(kind, chi2, rng, cuda):
    """One search's arguments ([M,...] tensors, col_isig2 last in chi2 mode)."""
    M, N = _TOP2_SHAPES[kind]
    x = (random_chi2_instance if chi2 else random_top2_instance)(rng, M, N, cuda)
    x = [t.clone() for t in x]
    if not chi2:
        x.append(None)
    r_u, r_v, r_rw, r_ur, r_rur, r_lo, r_hi, r_ok = x[2:10]
    c_u, c_v, c_ur, c_oct, c_ok, c_isig = x[10:16]
    odd = torch.tensor(_ODD, dtype=torch.float32, device=cuda)
    k = len(_ODD)
    if kind == "all_dead":
        r_ok[:] = False
    elif kind == "live_tail":
        r_ok[:4000] = False
        r_ok[4000:] = True
    elif kind == "outside":  # coordinates off the image, +-inf and NaN on both sides
        c_u[:k], c_v[:k] = odd, odd.roll(3)
        c_u[k:2 * k], c_v[k:2 * k] = 320.0, odd
        r_u[16:16 + k], r_v[16:16 + k] = odd.roll(5), odd
        r_u[16 + k:16 + 2 * k], r_v[16 + k:16 + 2 * k] = 320.0, odd + 2.0
        r_rw[16:16 + 2 * k] = 40.0
        r_rw[16 + 2 * k:16 + 3 * k] = float("inf")
        r_v[16 + 2 * k:16 + 3 * k] = odd
        r_ok[16:16 + 3 * k] = True
        c_ok[:2 * k] = True
        c_ur[:2 * k] = -1.0
        if chi2:
            c_isig[:2 * k] = 1e-6
    elif kind == "window_edge":  # col_v at row_v +- row_rw exactly, and one ulp inside
        rv = torch.as_tensor(rng.integers(0, 1920, M) / 4.0, dtype=torch.float32, device=cuda)
        rw = torch.as_tensor(rng.choice([0.25, 4.0, 7.5, 12.0, 8.0, 40.0], M),
                             dtype=torch.float32, device=cuda)
        r_v[:], r_rw[:], r_ok[16:] = rv, rw, True
        r_lo[:], r_hi[:] = 0, 7
        hi, lo = rv + rw, rv - rw
        cols = torch.stack([hi, torch.nextafter(hi, rv), lo, torch.nextafter(lo, rv)], 1)
        c_v[:4 * M] = cols.flatten()
        c_u[:4 * M] = r_u.repeat_interleave(4)
        c_oct[:4 * M], c_ur[:4 * M], c_ok[:4 * M] = 3, -1.0, True
        if chi2:
            c_isig[:4 * M] = 1e-4
    elif kind == "big_window":  # windows larger than the image, and infinite ones
        r_rw[::2] = 1e4
        r_rw[1::4] = float("inf")
    return x


def _top2_edge_case(kind, site, cuda):
    """-> (args, kw) of the call site's wrapper; the batched site stacks 16
    searches that share one source set."""
    rng = np.random.default_rng(sum(map(ord, kind + site)))
    if site != "nb":
        x = _top2_edge_one(kind, site == "chi2", rng, cuda)
        return x[:15], (dict(col_isig2=x[15], chi2_gate=True) if site == "chi2" else {})
    xs = [_top2_edge_one(kind, True, rng, cuda) for _ in range(16)]
    args = [torch.stack(t) for t in zip(*xs)]
    args[0] = xs[0][0][None].expand_as(args[0])
    return args[:15], dict(col_isig2=args[15], chi2_gate=True)


@pytest.mark.parametrize("site", ["frame", "local", "chi2", "nb"])
@pytest.mark.parametrize("kind", list(_TOP2_SHAPES))
def test_top2_kernel_edges_at_every_site(cuda, kind, site):
    args, kw = _top2_edge_case(kind, site, cuda)
    kernel = {"frame": match_cuda.KERNEL, "local": match_cuda.KERNEL_LOCAL,
              "chi2": match_cuda.KERNEL_CHI2, "nb": match_cuda.KERNEL_NB}[site]
    before = kernel.launches
    if site == "nb":
        got = match_cuda.masked_top2_nb(*args, **kw)
        want = match_pallas.masked_top2_nb_plain(*args, **kw)
    else:
        got = match_cuda.masked_top2(*args, **kw, kernel=kernel)
        want = match_pallas.masked_top2_plain(*args, **kw)
    _equal(got, want)
    assert kernel.launches == before + 1
    if kind == "all_dead":
        assert (got[1] == match_pallas.BIG).all() and (got[0] == 0).all()


def _orb_edge_case(kind, cuda):
    """-> (raw, blur, level, ys, xs). "border": keypoints whose disc and
    samples run past the canvas's first and last pixels and across row ends
    (the clamps act); "quadrants": tiles whose moments are zero, positive or
    negative on either axis; "n1" and "n1001": one keypoint, and a count that
    is not a multiple of the keypoints per block."""
    rng = np.random.default_rng(len(kind))
    L, CH, CW = 3, 96, 128
    raw = rng.integers(0, 256, (L, CH, CW)).astype(np.float32)
    blur = rng.integers(0, 256, (L, CH, CW)).astype(np.float32)
    H, W = CH - 38, CW - 38  # level-image size inside the 19-pixel halo
    if kind == "border":
        ys = [-19, -19, -19, 0, H - 1, H + 18, H + 18, 5, 5, -40, H + 60, 30]
        xs = [-19, 0, W + 18, -19, W + 18, -19, W + 18, -19, W + 18, 10, 10, -60]
        lv = [0, 0, 0, 0, 2, 2, 2, 1, 1, 0, 2, 1]
    elif kind == "quadrants":
        yy, xx = np.mgrid[-19:20, -19:20]
        tiles = [np.zeros_like(yy), xx, -xx, yy, -yy, xx + yy, xx - yy, -xx + yy, -xx - yy,
                 np.abs(xx), np.abs(yy), xx * (yy > 0)]
        ys, xs, lv = [], [], []
        for i, t in enumerate(tiles):
            lvl, cy, cx = i % L, 19 + 39 * ((i // L) % 2), 19 + 39 * ((i // L) // 2 % 2)
            raw[lvl, cy - 19:cy + 20, cx - 19:cx + 20] = 100 + 4 * t
            ys.append(cy - 19)
            xs.append(cx - 19)
            lv.append(lvl)
    else:
        n = 1 if kind == "n1" else 1001
        ys, xs = rng.integers(0, H, n), rng.integers(0, W, n)
        lv = rng.integers(0, L, n)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(cuda)  # noqa: E731
    return (torch.as_tensor(raw).to(cuda), torch.as_tensor(blur).to(cuda), i32(lv), i32(ys),
            i32(xs))


@pytest.mark.parametrize("kind", ["border", "quadrants", "n1", "n1001"])
def test_orb_kernel_edges(cuda, kind):
    raw, blur, level, ys, xs = _orb_edge_case(kind, cuda)
    before = orb_cuda.KERNEL.launches
    ang, desc = orb_cuda.orb_angle_desc(raw, blur, level, ys, xs)
    ang_ref = orientation.ic_angle(raw, level, ys, xs)
    desc_ref = brief.compute_descriptors(blur, level, ys, xs, ang_ref)
    torch.cuda.synchronize()
    assert orb_cuda.KERNEL.launches == before + 1
    assert torch.equal(ang.view(torch.int32), ang_ref.view(torch.int32))
    assert torch.equal(desc, desc_ref)
    if kind == "quadrants":  # every branch of cvFastAtan2's quadrant fix-up ran
        a = ang_ref.cpu().numpy()
        assert a[0] == 0.0 and ((a > 90) & (a < 180)).any() and ((a > 180) & (a < 270)).any()
        assert ((a > 270) & (a < 360)).any() and ((a > 0) & (a < 90)).any()


@pytest.fixture(scope="module")
def kidnap_launches(cuda):
    """chip_smoke.py's main path 4 in its depth-poor variant (EPnP; its
    return frames make keyframes, whose triangulation searches carry live
    featVec groups): a copy of the arguments of every epipolar search, and of
    FAST and the top-2 searches on the black frames 8-10."""
    from vo_slam_test_tpu_torch.pipeline import system

    seq, cfg = chip_smoke.kidnap_sequence()
    voc = chip_smoke.kidnap_vocabulary(seq, cfg, cuda)
    on_black = lambda f, args: 8 <= f <= 10  # noqa: E731
    recorded = [(fast_cuda, "fast_score", on_black), (match_cuda, "masked_top2", on_black),
                (match_cuda, "masked_top1_epi", lambda f, args: True)]
    with chip_smoke.LaunchRecorder(recorded) as lrec:
        s, _ = chip_smoke.run_kidnap(system, cfg, voc, chip_smoke.kidnap_frames(seq, True), False,
                                     lrec)
    assert s.reloc_frames and s.reloc_frames[0] >= 11
    return lrec.got


def test_epi_kernel_on_kidnap_live_groups(kidnap_launches):
    calls = kidnap_launches["masked_top1_epi"]
    assert calls
    for f, args, _ in calls:
        assert bool((args[4] >= 0).any() and (args[10] >= 0).any()), f  # live featVec groups
        _equal(match_cuda.masked_top1_epi(*args), match_pallas.masked_top1_epi_plain(*args))


def test_epi_kernel_on_kidnap_without_live_rows(kidnap_launches):
    """The same searches with no live row, the shape a keyframe without free
    keypoints gives (no epipolar search runs on a black frame itself:
    triangulation runs only on keyframe events)."""
    for f, args, _ in kidnap_launches["masked_top1_epi"]:
        dead = list(args)
        dead[5] = torch.zeros_like(args[5])
        got = match_cuda.masked_top1_epi(*dead)
        _equal(got, match_pallas.masked_top1_epi_plain(*dead))
        assert bool((got[1] == match_pallas.BIG).all())


@pytest.mark.parametrize("name", ["fast_score", "masked_top2"])
def test_black_frame_launches_match_plain(kidnap_launches, name):
    calls = kidnap_launches[name]
    assert len(calls) >= 3
    for f, args, kw in calls:
        if name == "fast_score":
            assert not bool(args[0].any())  # an all-zero pyramid
            _equal((fast_cuda.fast_score(*args),), (fast.fast_score(*args),))
        else:
            assert not bool(args[14].any())  # no target keypoint
            plain_kw = {k: v for k, v in kw.items() if k != "kernel"}
            _equal(match_cuda.masked_top2(*args, **kw),
                   match_pallas.masked_top2_plain(*args, **plain_kw))


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
                 "pipeline.system", "solvers.local_ba", "ops.ba_cuda", "ops.ba_pallas",
                 "bow.vocabulary", "bow.retrieval", "matching.bow_match", "solvers.ransac",
                 "solvers.epnp", "utils.prng", "utils.linalg", "utils.drift", "solvers.sim3",
                 "solvers.pose_graph", "solvers.global_ba", "pipeline.loop_closing",
                 "frontend.distribute", "datasets.tum", "datasets.staging", "native.loader",
                 "slam_map.serialize", "viz.drawer", "viz.webviewer", "run_slam"):
        assert pkg.__name__ + "." + name in sys.modules
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vo_slam_test_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# loop closing: the loop fuse (row 4 at its new site) and global BA
# ---------------------------------------------------------------------------


def drifted_loop_map(device):
    """tests/test_loop_close.py::build_drifted_loop_map with the port's own
    map and lie (the card's machine has no JAX): ten keyframes, KF0 and KF9
    revisit one place, the stored chain drifts with the index -> (map, caps,
    camera, scale factors)."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps, empty_map

    caps = MapCaps(max_kf=16, max_pt=512, max_obs=8, n_feat=128)
    cam = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                        camera_k3=0), device)

    def se3(tx=0.0, ty=0.0, ry=0.0):
        return lie.se3_exp(torch.tensor([tx, ty, 0.0, 0.0, ry, 0.0])).numpy()

    rng = np.random.default_rng(7)
    n = 80
    gt = np.stack([np.eye(4, dtype=np.float32)] + [se3(tx=0.02 * i, ry=0.01 * i)
                                                   for i in range(1, 9)] + [se3(tx=0.05)])
    stored = np.stack([gt[i] @ se3(tx=0.03 * i, ty=0.015 * i, ry=0.008 * i) for i in range(10)])
    p_true = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                       rng.uniform(1.5, 2.5, n)], 1).astype(np.float32)
    descs = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32).view(np.int32)
    fx, fy, cx, cy = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))

    def project(T):
        pc = p_true @ T[:3, :3].T + T[:3, 3]
        return np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1), pc

    uv0, pc0 = project(gt[0])
    uv9, pc9 = project(gt[9])
    inv9 = np.linalg.inv(stored[9])
    p_dup = pc9 @ inv9[:3, :3].T + inv9[:3, 3]
    K, N, P, O = caps.max_kf, caps.n_feat, caps.max_pt, caps.max_obs
    f = {k: v.cpu().numpy().copy() for k, v in empty_map(caps, "cpu").__dict__.items()}
    f["kf_pose"][:10] = stored
    f["kf_valid"][:10] = True
    for k, uv, base in ((0, uv0, 0), (9, uv9, n)):
        f["kf_uv_und"][k, :n] = uv
        f["kf_desc"][k, :n] = descs
        f["kf_kp_valid"][k, :n] = True
        f["kf_mp"][k, :n] = base + np.arange(n)
        f["pt_obs_kf"][base:base + n, 0] = k
        f["pt_obs_kp"][base:base + n, 0] = np.arange(n)
    for i in range(9):
        f["covis"][i, i + 1] = f["covis"][i + 1, i] = 120
    f["parent"][1:10] = np.arange(9)
    f["pt_pos"][:n], f["pt_pos"][n:2 * n] = p_true, p_dup
    f["pt_desc"][:n] = f["pt_desc"][n:2 * n] = descs
    f["pt_valid"][:2 * n] = True
    f["pt_ref_kf"][:n], f["pt_ref_kf"][n:2 * n] = 0, 9
    d0, d9 = np.linalg.norm(pc0, axis=1), np.linalg.norm(pc9, axis=1)
    f["pt_min_dist"][:n], f["pt_max_dist"][:n] = 0.5 * d0, 1.02 * d0
    f["pt_min_dist"][n:2 * n], f["pt_max_dist"][n:2 * n] = 0.5 * d9, 1.02 * d9
    f["pt_obs_cnt"][:2 * n] = 1
    f["kf_seq"][:10] = 10 + np.arange(10)
    f["n_kf_ever"], f["n_kf"], f["n_pt"] = np.int32(20), np.int32(10), np.int32(2 * n)
    m = type(empty_map(caps, "cpu"))(**{k: torch.as_tensor(np.asarray(v)).to(device)
                                         for k, v in f.items()})
    return m, caps, cam, torch.tensor([1.2 ** i for i in range(8)], device=device), gt


def test_loop_fuse_launches_match_plain(cuda):
    """close_step on the drifted chain, on the card: every chi2 top-2 launch
    of the loop fuse (one per corrected-group keyframe) bit-equal to the
    plain version; the loop accepted and KF9 corrected."""
    from chip_smoke import LaunchRecorder, TOP2_OUTS
    from vo_slam_test_tpu_torch.pipeline import loop_closing

    m, caps, cam, scales, gt = drifted_loop_map(cuda)
    groups = torch.zeros(caps.n_feat, dtype=torch.int32, device=cuda)
    orig = loop_closing._correct

    def tagged(*a, **k):
        rec.tag = "loop_fuse"
        try:
            return orig(*a, **k)
        finally:
            rec.tag = None

    before = match_cuda.KERNEL_CHI2.launches
    loop_closing._correct = tagged
    try:
        with LaunchRecorder([(match_cuda, "masked_top2",
                              lambda f, args: rec.tag == "loop_fuse")]) as rec:
            m2, ls, accepted, gates = loop_closing.close_step(
                m, loop_closing.empty_loop_state(caps, cuda), 9, 0, caps, cam, scales, groups,
                groups, diag=True)
    finally:
        loop_closing._correct = orig
    torch.cuda.synchronize()
    calls = rec.got["masked_top2"]
    assert accepted and gates["total"] >= 40
    # the corrected group: KF9 and its covisible KF8
    assert len(calls) == 2 == match_cuda.KERNEL_CHI2.launches - before
    for _, args, kw in calls:
        got = match_cuda.masked_top2(*args, **kw)
        want = match_pallas.masked_top2_plain(*args, **kw)
        for name, a, b in zip(TOP2_OUTS, got, want):
            assert torch.equal(a, b), name
    assert np.linalg.norm(m2.kf_pose[9, :3, 3].cpu().numpy() - gt[9][:3, 3]) < 0.05


def fabricated_ba_map(device, n_kf=6, n_pt=400, seed=3):
    """tests/test_local_ba.py::fabricate_map's scene with the port's map and
    lie: n_kf views of n_pt points with 0.3 px noise, half of the
    observations stereo, poses (but KF0) and points perturbed -> (map,
    caps, camera)."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps, empty_map

    caps = MapCaps(max_kf=16, max_pt=2048, max_obs=12, n_feat=256)
    cam = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                        camera_k3=0), device)
    fx, fy, cx, cy, bf = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf))
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 6.0], size=(n_pt, 3)).astype(np.float32)
    f = {k: v.cpu().numpy().copy() for k, v in empty_map(caps, "cpu").__dict__.items()}
    for k in range(n_kf):
        xi = np.concatenate([rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.05, 0.05, 3)])
        T = lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
        pc = pts @ T[:3, :3].T + T[:3, 3]
        u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, 0.3, n_pt)
        v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, 0.3, n_pt)
        vis = np.nonzero((u > 5) & (u < 635) & (v > 5) & (v < 475))[0][:caps.n_feat]
        stereo = rng.uniform(size=vis.size) < 0.5
        f["kf_pose"][k] = T
        f["kf_valid"][k] = True
        f["kf_uv_und"][k, :vis.size] = np.stack([u[vis], v[vis]], 1)
        f["kf_u_right"][k, :vis.size] = np.where(stereo, u[vis] - bf / pc[vis, 2], -1.0)
        f["kf_kp_valid"][k, :vis.size] = True
        f["kf_mp"][k, :vis.size] = vis
    f["pt_pos"][:n_pt] = pts + rng.normal(0, 0.05, (n_pt, 3))
    f["pt_valid"][:n_pt] = True
    for k in range(1, n_kf):
        xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.015, 3)])
        f["kf_pose"][k] = lie.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy() @ f["kf_pose"][k]
    m = type(empty_map(caps, "cpu"))(**{k: torch.as_tensor(np.asarray(v)).to(device)
                                         for k, v in f.items()})
    return m, caps, cam


def _reproj_rmse(m, cam):
    valid = (m.kf_mp >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    T = m.kf_pose[:, None].expand(-1, m.kf_mp.shape[1], -1, -1)[valid]
    X = m.pt_pos[m.kf_mp[valid].long()]
    pc = torch.einsum("mij,mj->mi", T[:, :3, :3], X) + T[:, :3, 3]
    uv = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)
    return float(torch.sqrt(((uv - m.kf_uv_und[valid]) ** 2).sum(1).mean()))


def test_global_ba_deterministic(cuda):
    """Global BA on the card twice gives identical maps (every sum in a
    fixed order), and recovers the perturbed scene as on the CPU."""
    from vo_slam_test_tpu_torch.solvers.global_ba import global_bundle_adjust

    m, caps, cam = fabricated_ba_map(cuda)
    a = global_bundle_adjust(m, caps, cam, 0)
    b = global_bundle_adjust(m, caps, cam, 0)
    torch.cuda.synchronize()
    assert torch.equal(a.kf_pose, b.kf_pose) and torch.equal(a.pt_pos, b.pt_pos)
    before, after = _reproj_rmse(m, cam), _reproj_rmse(a, cam)
    assert after < 0.1 * before and after < 1.0, (before, after)
    assert torch.equal(a.kf_pose[0], m.kf_pose[0])


@pytest.fixture(scope="module")
def saturated_iteration(cuda):
    """The first LM iteration of one local BA on tests/test_local_ba_saturation.py's
    seed-3 dense map (every cap of the window exceeded), built on the card by
    the ported ``datasets/synth_map.build``: (instance, back-substitution
    arguments), as chip_smoke's main path 7b captures them."""
    from vo_slam_test_tpu_torch.datasets import synth_map
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import local_ba

    caps = MapCaps(*chip_smoke.SAT_CAPS)
    m, cam = synth_map.build(caps, n_kf=40, n_pt=3500, seed=3, span_max=24, device=cuda)
    with chip_smoke.BaCapture(ba_cuda) as cap:
        local_ba.local_bundle_adjust(m, chip_smoke.SAT_CENTER, caps, cam)
    return cap.instance()


@pytest.mark.parametrize("key", ["ba_acc", "ba_cost", "ba_backsub"])
def test_ba_rows_on_saturated_window(saturated_iteration, key):
    """Rows 7-9 with 24 window slots and observer lists full: within
    check_ba's tolerances of the plain versions, two launches bit-equal."""
    inst, sub = saturated_iteration
    assert int(inst["n_pts"]) > 500 and inst["slot"].shape == (12, 4096)
    spec = chip_smoke.ba_kernel_specs(ba_cuda, ba_pallas)[key]
    chip_smoke.hold_ba(ba_cuda, spec, "the saturated window", inst, sub)


def test_distribute_level_cell_boundaries_on_card(cuda):
    """The quad-tree's cell keys on the card round as on the CPU (one f32
    multiply by XLA's folded constant): keep masks equal on candidates at
    every integer position of a row and a column of each 640x480 level."""
    from vo_slam_test_tpu_torch.ops.distribute_device import distribute_level

    spec = PyramidSpec(640, 480, 8, 1.2)
    b = fast.DETECT_BORDER
    for lvl in range(8):
        h, w = spec.sizes[lvl]
        col, row = np.arange(b, h - b, dtype=np.int32), np.arange(b, w - b, dtype=np.int32)
        ys = np.concatenate([col, np.full(row.size, b + 7, np.int32)])
        xs = np.concatenate([np.full(col.size, b + 7, np.int32), row])
        args = [torch.as_tensor(a) for a in (xs, ys, np.full(xs.size, 80.0, np.float32),
                                             np.ones(xs.size, bool))]
        bounds = (float(b), float(w - b), float(b), float(h - b))
        n_ini = max(int(round((w - 2 * b) / (h - 2 * b))), 1)
        want = distribute_level(*args, bounds, 8, n_ini=n_ini)
        got = distribute_level(*[a.to(cuda) for a in args], bounds, 8, n_ini=n_ini)
        assert torch.equal(got.cpu(), want), lvl
