"""Loop detection as the background program runs it: the port's
``detect_step`` on device arguments (a device ``did_kf`` and ``kf_id``,
detection under ``graphs.cond`` on ``did_kf & (kf_id >= 0)``) in select mode
under ``no_host_reads``, against its eager form with host arguments, round
after round on the maps of tests/test_torch_loop_detect.py (the loop map,
its connected variant, a round without a keyframe and one with kf_id -1):
candidates, generations and the loop state equal bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.utils import graphs
from test_loop_detect import make_map_with_loop
from test_torch_loop_detect import P_CAPS
from torch_slam_helpers import port_map


def _rounds_both(jm, events):
    """detect_step over ``events`` (did_kf, kf_id), eager with host values
    and in select mode with device values; every round equal."""
    pm = port_map(jax.device_get(jm))
    ls_e = ls_g = LC.empty_loop_state(P_CAPS, "cpu")
    confirmed = []
    for did, kf in events:
        ls_e, c_e, g_e = LC.detect_step(pm, ls_e, did, kf, P_CAPS)
        with graphs.use("select"), graphs.no_host_reads():
            ls_g, c_g, g_g = LC.detect_step(pm, ls_g, torch.tensor(did),
                                            torch.tensor(kf, dtype=torch.int32), P_CAPS)
        assert torch.equal(c_e, c_g) and torch.equal(g_e, g_g), (did, kf)
        for f in dataclasses.fields(ls_e):
            assert torch.equal(getattr(ls_e, f.name), getattr(ls_g, f.name)), (did, kf, f.name)
        confirmed.append(int(c_e[0]))
    return confirmed


def test_loop_map_rounds():
    first = _rounds_both(make_map_with_loop(), [(True, q) for q in (9, 10, 11, 12)])
    assert first[:3] == [-1, -1, -1] and first[3] in (0, 1, 2), first


@pytest.mark.parametrize("events", [
    [(False, 5)], [(True, -1)],
    [(True, 9), (False, 10), (True, -1), (True, 10), (True, 11), (True, 12)]])
def test_rounds_without_a_keyframe(events):
    _rounds_both(make_map_with_loop(), events)


def test_connected_candidates_excluded():
    jm = make_map_with_loop()
    covis = np.array(jm.covis)
    for q in (9, 10, 11, 12):
        for c in (0, 1, 2):
            covis[q, c] = covis[c, q] = 30
    first = _rounds_both(jm.replace(covis=jnp.asarray(covis)), [(True, q) for q in (9, 10, 11, 12)])
    assert first == [-1] * 4
