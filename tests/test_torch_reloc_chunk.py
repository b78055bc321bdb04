"""The kidnap at 320x240 (tests/torch_slam_helpers.py::kidnap_small) through
SlamSystem(vocabulary=..., chunk=5) in both packages: three chunks of five
frames, each tracked frame after frame before its keyframe events are mapped
(the JAX package's track_chunk scan and background_chunk). The relocalization
lands in the third chunk, after two black frames of the second.

Per frame: ok, relocalized, the feature, match and inlier counts and the
keyframe decision equal; poses of tracked frames within 1e-4. The first
chunk's local BA (after frame 4) rounds in another order than JAX's (its LM
decisions are rounding-sensitive, ROADMAP queue 3), which moves the later
poses by up to 4e-5; FLOAT_TOL's atol of 1e-5 holds the frames before it.
Both sides run with loop closing on and close no loop."""

import jax
import numpy as np

from vo_slam_test_tpu.bow import vocabulary as JV
from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from torch_slam_helpers import (FLOAT_TOL, J_CAPS, JConfig, JSlamSystem, P_CAPS, kidnap_small,
                                per_frame_rows)

CHUNK = 5
KEYS = ("ok", "relocalized", "n_features", "n_matches", "n_inliers", "made_kf")


def test_kidnap_in_chunks_matches_jax():
    k = kidnap_small()
    js = JSlamSystem(JConfig(**k["kw"]), caps=J_CAPS, chunk=CHUNK,
                     vocabulary=JV.build_vocabulary(k["descs"], k=8, levels=3, seed=2))
    ps = SlamSystem(SlamConfig(**k["kw"]), caps=P_CAPS, device="cpu", chunk=CHUNK,
                    vocabulary=V.build_vocabulary(k["descs"], k=8, levels=3, seed=2, device="cpu"))
    for g, d, ts in k["frames"]:
        js.track(g, d, ts)
        ps.track(g, d, ts)
    js.results()
    ps.results()
    assert js.loop_closures == [] == ps.loop_closures
    j_rows = per_frame_rows(js._per_frame(jax.device_get(js._outs)))
    p_rows = per_frame_rows(ps._outs)
    assert len(p_rows) == len(j_rows) == 15
    for i, (p, j) in enumerate(zip(p_rows, j_rows)):
        assert tuple(p[x] for x in KEYS) == tuple(j[x] for x in KEYS), (i, p, j)
        if j["ok"]:
            tol = FLOAT_TOL if i < CHUNK else dict(atol=1e-4)
            np.testing.assert_allclose(p["T"], j["T"], err_msg=f"frame {i}", **tol)
    assert ps.reloc_frames == js.reloc_frames == [11]
    # the archive for create_vocabulary holds every frame of every chunk
    assert len(ps._frame_desc) == 15
