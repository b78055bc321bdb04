"""SlamSystem(vocabulary=...) through its step programs on the CPU, the
default relocalization mode: with ``graphs=True`` every frame of the 320x240
kidnap (tests/torch_slam_helpers.py::kidnap_small: frames 0-7, three black
frames, frames 2-5 again) runs StepGraph's select form under
``no_host_reads`` (the stand-in for a replay with conditional nodes: the
motion gate, the reference-keyframe and relocalization fallbacks, each
relocalization candidate slot, Horn or EPnP by ``depth_rich``, the top-up
cascade's gates, the background program's mapping chain and loop detection),
and it must equal the eager run bit for bit
(``torch_slam_helpers.kidnap_graph_vs_eager``). The depth-poor return frames
(EPnP), ``reloc_parity=True`` and ``chunk=4`` are in
test_torch_graphs_reloc_{poor,parity,chunk}.py.

Also here: one tracking step with the vocabulary, from a lost state and on a
relocalizing frame, raises nothing under ``no_host_reads`` in select mode and
equals the eager step."""

import dataclasses

import torch

from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import system as S
from vo_slam_test_tpu_torch.utils import graphs

from torch_slam_helpers import P_CAPS, kidnap_graph_vs_eager, kidnap_small


def test_kidnap_select_bit_equal_to_eager():
    a, b = kidnap_graph_vs_eager()
    assert a.reloc_frames == [11]
    slot, n_bow, n_ransac, n_obs = b._outs[11].reloc_winner
    assert n_bow >= 15 and n_ransac >= 10 and n_obs >= 50


def test_tracking_step_reads_nothing():
    """Frames 9 (lost, black: relocalization with no candidate) and 11 (the
    return: relocalized) of the kidnap, each stepped from the eager system's
    state in select mode under no_host_reads: no host read, and the step's
    outputs, state and map equal the eager step's."""
    k = kidnap_small()
    voc = V.build_vocabulary(k["descs"], k=8, levels=3, seed=2, device="cpu")
    s = S.SlamSystem(SlamConfig(**k["kw"]), caps=P_CAPS, device="cpu", vocabulary=voc)
    for i, (g, d, ts) in enumerate(k["frames"][:12]):
        if i in (9, 11):
            args = (torch.as_tensor(g), torch.as_tensor(d), ts, s.camera, s.caps, s.spec,
                    s.budgets, s.scale_factors, s.inv_level_sigma2, s.fast_hi, s.fast_lo,
                    s.max_frame_gap, s.voc, False)
            st_e, m_e, out_e, kf_e = S._slam_step(s.state, s.map, *args)
            with graphs.use("select"), graphs.no_host_reads():
                st_g, m_g, out_g, kf_g = S._slam_step(s.state, s.map, *args)
            assert bool(out_e.relocalized) == (i == 11) and int(kf_g) == kf_e
            assert (graphs.fetch(out_e.reloc_winner)[0] == -1) == (i == 9)  # -1: no candidate
            for leaf_e, leaf_g in zip(graphs.flatten((st_e, m_e))[0],
                                      graphs.flatten((st_g, m_g))[0]):
                assert torch.equal(leaf_e, leaf_g)
            for f in dataclasses.fields(out_e):
                if f.name != "made_kf":
                    assert torch.equal(getattr(out_e, f.name), getattr(out_g, f.name)), f.name
        s.track(g, d, ts)
