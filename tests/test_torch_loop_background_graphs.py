"""Loop closing on the graph path, on the CPU: the background program
(``background_step`` with device ``did_kf``/``kf_id``/interruptBA, in select
mode under ``no_host_reads``: the mapping chain and loop detection under
their conds, the candidates left on the device), then the host's one read of
the confirmed candidates and the eager close (``close_confirmed``), as
``SlamSystem(vocabulary=..., graphs=True)`` runs a keyframe event, against
the eager ``background_step`` with host values, round after round on
tests/test_torch_loop_background.py's drifted chain (the fourth detection
confirms KF0 and the loop closes): the loop records, every map and
loop-state tensor equal bit for bit."""

import dataclasses

import jax
import numpy as np
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.pipeline import system
from vo_slam_test_tpu_torch.utils import graphs
from test_torch_loop_background import GROUP_DIV, KW, P_CAPS, ROUNDS, SCALES, place_map
from torch_slam_helpers import port_map


def test_background_program_then_close_equals_eager():
    cam = Camera.from_config(SlamConfig(**KW), "cpu")
    start = jax.device_get(place_map(JCamera.from_config(JConfig(**KW)))[0])
    sf = torch.as_tensor(SCALES)
    m_e, ls_e = port_map(start), LC.empty_loop_state(P_CAPS, "cpu")
    m_g, ls_g = port_map(start), LC.empty_loop_state(P_CAPS, "cpu")
    event = (torch.tensor(True), torch.tensor(9, dtype=torch.int32), torch.tensor(True))
    closed = []
    for r in range(ROUNDS):
        m_e, ls_e, out_e = system.background_step(m_e, ls_e, True, 9, True, P_CAPS, cam, sf,
                                                  True, GROUP_DIV)
        with graphs.use("select"), graphs.no_host_reads():
            m_g, ls_g, bg = system.background_step(m_g, ls_g, *event, P_CAPS, cam, sf, True,
                                                   GROUP_DIV)
        out_g = system.BackgroundOut()
        m_g, ls_g = system.close_confirmed(m_g, ls_g, 9, bg.cands.tolist(),
                                           bg.cand_gens.tolist(), out_g, GROUP_DIV, P_CAPS, cam, sf)
        assert (out_e.attempted, out_e.closed, out_e.which) == \
            (out_g.attempted, out_g.closed, out_g.which), r
        assert [(c, a) for c, a, _ in out_e.attempts] == [(c, a) for c, a, _ in out_g.attempts]
        for f in dataclasses.fields(m_e):
            assert torch.equal(getattr(m_e, f.name), getattr(m_g, f.name)), (r, f.name)
        for f in dataclasses.fields(ls_e):
            assert torch.equal(getattr(ls_e, f.name), getattr(ls_g, f.name)), (r, f.name)
        closed.append(out_g.closed)
    assert closed == [False, False, False, True]
    assert np.isfinite(m_g.kf_pose.numpy()).all()
