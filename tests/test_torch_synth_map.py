"""The port's filled-map function (``datasets/synth_map.py::build``) against
the JAX package's ``tools/synth_map.py::build``, which the card cannot run
(it imports JAX): on the caps and seeds of the tests that use it, every
field of the map, through ``convert.map_state_to_numpy``, is equal to the
JAX map's, exactly (the same numpy draws and arithmetic), and the cameras
agree.

- tests/test_culling.py:23's caps, the oracle case (12 keyframes, 600
  points, seed 3);
- tests/test_local_ba_saturation.py:32's caps and dense map (40 keyframes,
  3500 points, seed 3, spans up to 24 keyframes);
- the n_feat=1024 caps of its point-overflow case (:124, seed 5).
"""

import os
import sys

import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.datasets import synth_map
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from synth_map import build as jbuild  # noqa: E402

torch.set_num_threads(1)

CASES = {
    "culling": ((32, 1024, 8, 128), dict(n_kf=12, n_pt=600, seed=3)),
    "saturation": ((64, 4096, 24, 256), dict(n_kf=40, n_pt=3500, seed=3, span_max=24)),
    "overflow": ((64, 4096, 24, 1024), dict(n_kf=40, n_pt=3500, seed=5, span_max=24)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synth_map_equals_jax_build(case):
    caps, kw = CASES[case]
    jm, jcam = jbuild(JMapCaps(*caps), **kw)
    pm, pcam = synth_map.build(MapCaps(*caps), device="cpu", **kw)
    want = convert.dataclass_to_numpy(jm)
    got = convert.map_state_to_numpy(pm)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    for f in ("fx", "fy", "cx", "cy", "bf", "b", "th_depth"):
        assert float(getattr(pcam, f)) == float(getattr(jcam, f)), f
    assert (pcam.width, pcam.height) == (jcam.width, jcam.height)
    # the map is filled: every live keyframe binds points, every live point
    # is observed at least twice
    assert int(pm.n_kf) == kw["n_kf"] and bool(pm.kf_valid[: kw["n_kf"]].all())
    assert int(pm.pt_obs_cnt[pm.pt_valid].min()) >= 1
    assert pm.kf_pose.device.type == "cpu"
