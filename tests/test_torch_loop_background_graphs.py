"""Loop closing on the graph path, on the CPU: the background program
(``background_step`` with device ``did_kf``/``kf_id``/interruptBA, in select
mode under ``no_host_reads``: the mapping chain, loop detection and the close
(the candidate scan and the correction) under their conds, nothing read
back), then the host's read of the close's outcome, against the eager
``background_step`` with host values, round after round on
tests/test_torch_loop_background.py's drifted chain (the fourth detection
confirms KF0 and the loop closes inside the program): the loop records, every
map and loop-state tensor equal bit for bit; and each round against the JAX
package's ``background_step`` (its inline close): the candidates, the
outcome and the loop state equal, the map's integer fields equal and its
float fields within 1e-4 (the JAX run is the shared fixture of
tests/test_torch_loop_background.py)."""

import dataclasses

import jax
import numpy as np
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.pipeline import system
from vo_slam_test_tpu_torch.utils import graphs
from test_torch_loop_background import (GROUP_DIV, KW, P_CAPS, ROUNDS, SCALES,  # noqa: F401
                                        jax_rounds, place_map)
from torch_slam_helpers import port_map


def test_background_program_then_close_equals_eager(jax_rounds):
    cam = Camera.from_config(SlamConfig(**KW), "cpu")
    start = jax.device_get(place_map(JCamera.from_config(JConfig(**KW)))[0])
    sf = torch.as_tensor(SCALES)
    m_e, ls_e = port_map(start), LC.empty_loop_state(P_CAPS, "cpu")
    m_g, ls_g = port_map(start), LC.empty_loop_state(P_CAPS, "cpu")
    event = (torch.tensor(True), torch.tensor(9, dtype=torch.int32), torch.tensor(True))
    closed = []
    for r, want in enumerate(jax_rounds["rounds"]):
        m_e, ls_e, out_e = system.background_step(m_e, ls_e, True, 9, True, P_CAPS, cam, sf,
                                                  True, GROUP_DIV)
        with graphs.use("select"), graphs.no_host_reads():
            m_g, ls_g, bg = system.background_step(m_g, ls_g, *event, P_CAPS, cam, sf, True,
                                                   GROUP_DIV)
        out_g = system.BackgroundOut()
        out_g.fold(*graphs.fetch(bg.cands, *bg.close.leaves()))
        assert (out_e.attempted, out_e.closed, out_e.which, out_e.attempts) == \
            (out_g.attempted, out_g.closed, out_g.which, out_g.attempts), r
        if out_e.close is not None:
            for x, y in zip(out_e.close.leaves(), bg.close.leaves()):
                assert torch.equal(x, y), r
        for f in dataclasses.fields(m_e):
            assert torch.equal(getattr(m_e, f.name), getattr(m_g, f.name)), (r, f.name)
        for f in dataclasses.fields(ls_e):
            assert torch.equal(getattr(ls_e, f.name), getattr(ls_g, f.name)), (r, f.name)
        # against the JAX package's background_step with its inline close
        np.testing.assert_array_equal(bg.cands.numpy(), want["cand"])
        assert (out_g.closed, out_g.which) == (want["closed"], want["which"]), r
        for f, v in want["ls"].items():
            np.testing.assert_array_equal(getattr(ls_g, f).numpy(), v, err_msg=f"round {r}: {f}")
        got = convert.map_state_to_numpy(m_g)
        for k, v in want["map"].items():
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                           err_msg=f"round {r}: {k}")
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=f"round {r}: {k}")
        closed.append(out_g.closed)
    assert closed == [False, False, False, True]
    assert out_g.attempts[0][:2] == (0, True)
    assert np.isfinite(m_g.kf_pose.numpy()).all()
