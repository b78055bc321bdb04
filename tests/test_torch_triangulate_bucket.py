"""Twin of tests/test_triangulate_bucket.py: BoW-bucket gating of
triangulation candidate pairs (searchForTriangulation's featVec lockstep
walk, matcher.cpp:903-965) in the port's ``create_new_map_points``, whose
``bow_group_div`` is a Python int, against the JAX package on the JAX
test's two-view map.

Each case: the numbers of new points are equal, the maps agree (integer and
bool fields exactly, float fields within rtol 1e-4 / atol 1e-5,
tests/test_torch_system.py's tolerance), and the JAX test's gate holds on
the port: pairs in one bucket triangulate (> 6 of 12), pairs in different
buckets do not (0), and without a vocabulary (div = 0) the full
epipolar-gated search is the unrestricted fallback (> 6). The JAX side runs
once per file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map.triangulate import create_new_map_points as jcreate
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.slam_map.triangulate import create_new_map_points
from test_triangulate_bucket import CAPS, two_view_map
from torch_slam_helpers import assert_maps_agree, port_map

PCAPS = MapCaps(max_kf=CAPS.max_kf, max_pt=CAPS.max_pt, max_obs=CAPS.max_obs,
                n_feat=CAPS.n_feat)
SF = [1.2 ** i for i in range(8)]
W_SAME = np.arange(12, dtype=np.int32) + 640    # bucket 640 // 64 = 10 for every pair
W_OTHER = np.arange(12, dtype=np.int32) + 1280  # bucket 20
CASES = {"same_bucket": (W_SAME, W_SAME, 64), "cross_bucket": (W_SAME, W_OTHER, 64),
         "div_zero": (W_SAME, W_OTHER, 0)}


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the input map (numpy), JAX's map after triangulation and its
    number of new points."""
    out = {}
    for name, (w0, w1, div) in CASES.items():
        m, cam = two_view_map(w0, w1)
        m_in = jax.device_get(m)
        m2 = jax.device_get(jcreate(m, jnp.asarray(1, jnp.int32), CAPS, cam,
                                    jnp.asarray(SF, jnp.float32),
                                    bow_group_div=jnp.asarray(div, jnp.int32)))
        out[name] = (m_in, m2, int(m2.pt_valid.sum()) - int(m_in.pt_valid.sum()))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_gate_matches_jax(jax_runs, case):
    m_in, want, n_jax = jax_runs[case]
    pm = port_map(m_in)
    cam = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                        camera_k3=0), "cpu")
    got = create_new_map_points(pm, 1, PCAPS, cam, torch.tensor(SF, dtype=torch.float32),
                                bow_group_div=CASES[case][2])
    n_new = int(got.pt_valid.sum()) - int(pm.pt_valid.sum())
    assert n_new == n_jax, (n_new, n_jax)
    assert_maps_agree(got, want, case)
    if case == "cross_bucket":
        assert n_new == 0
    else:
        assert n_new > 6, n_new
