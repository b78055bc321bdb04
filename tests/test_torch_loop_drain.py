"""The ``VO_LOOP_DIAG`` drain path of ``SlamSystem`` against the JAX
package's, on tests/test_torch_loop_background.py's scene (the drifted chain
with KF0 and KF9 sharing one place's words).

Both systems are made with ``VO_LOOP_DIAG=1`` (set for the test alone) and
``drain_chunk=1``; five keyframe events of KF9 then run the background step
without the inline close, and each frame's detection goes through the
system's own ``_queue_loop``, as ``track`` sends it: a batch is verified one
frame after its detection, the last one at the final drain. The fourth
detection confirms KF0, the drain closes it one frame later (after the fifth
event's detection), and the fifth frame's candidate then meets the closed
loop's gap gate. ``loop_attempts`` (gate values included) and
``loop_closures`` equal JAX's, the map's integer fields equal and its floats
agree within 1e-4 (as in tests/test_torch_loop_background.py).

``n_ba_interrupts`` and ``ba_iters`` (each event's local BA is skipped at its
entry here) equal what the JAX package's own fold
(``_collect_close_results``) makes of its background rows; its diagnostic
path never folds them, the port folds every event's counts in every mode.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import system
from test_loop_close import CAPS
from test_torch_loop_background import GROUP_DIV, KW, P_CAPS, SCALES, place_map
from torch_slam_helpers import assert_maps_agree, port_map

torch.set_num_threads(1)
ROUNDS = 5
# featVec buckets of the scene: words // 10**3 (GROUP_DIV)
VOC = types.SimpleNamespace(k=10, levels=3)


@pytest.fixture(scope="module")
def drained():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VO_LOOP_DIAG", "1")
        js = jsystem.SlamSystem(JConfig(**KW), CAPS, drain_chunk=1)
        ps = system.SlamSystem(SlamConfig(**KW), P_CAPS, device="cpu", drain_chunk=1)
    assert not js._inline_close and not ps._inline_close
    # the systems' pyramid scales are the scene's (tests/test_torch_loop_background.py)
    np.testing.assert_array_equal(np.asarray(js.scale_factors), SCALES)
    np.testing.assert_array_equal(ps.scale_factors.numpy(), SCALES)
    jcam = JCamera.from_config(JConfig(**KW))
    m, _ = place_map(jcam)
    host = jax.device_get(m)
    js.map, js.voc, js.enable_loop_closing = jax.tree.map(jnp.asarray, host), VOC, True
    ps.map, ps.voc, ps.enable_loop_closing = port_map(host), VOC, True
    rows = []
    for f in range(ROUNDS):
        gen = js.map.kf_gen[9][None]
        js.map, js.loop_state, cand, cand_gen, _, _, packed = jsystem.background_step(
            js.map, js.loop_state, jnp.asarray(True), jnp.asarray(9, jnp.int32),
            jnp.asarray(True), jnp.asarray(GROUP_DIV, jnp.int32), CAPS, js.camera,
            js.scale_factors, True, inline_close=False)
        rows.append(([f], packed[None]))
        js._queue_loop([f], cand[None], cand_gen[None], jnp.asarray([9], jnp.int32), gen)

        pgen = ps.map.kf_gen[9:10]
        ps.map, ps.loop_state, bg = system.background_step(
            ps.map, ps.loop_state, True, 9, True, P_CAPS, ps.camera, ps.scale_factors, True,
            GROUP_DIV, inline_close=False)
        ps._fold_background([(f, True, bg)])
        ps._queue_loop([f], bg.cands[None], bg.cand_gens[None],
                       torch.tensor([9], dtype=torch.int32), pgen)
    js._drain_loop_queue(final=True)
    ps._drain_loop_queue(final=True)
    # the JAX package's own fold of its background rows
    fold = object.__new__(jsystem.SlamSystem)
    fold.ba_iters, fold.n_ba_interrupts, fold.loop_attempts, fold.loop_closures = [], 0, [], []
    fold.enable_global_ba, fold._close_results = False, rows
    fold._collect_close_results()
    return js, ps, fold


def test_drain_attempts_and_closures_match_jax(drained):
    js, ps, _ = drained
    assert ps.loop_attempts == js.loop_attempts
    assert ps.loop_closures == js.loop_closures == [3]
    assert [a[:3] for a in ps.loop_attempts] == [(3, 0, True), (4, 0, False)]
    closed, gap = ps.loop_attempts[0][3], ps.loop_attempts[1][3]
    assert closed["n_bow"] >= 20 and closed["total"] >= 40 and gap["gap_ok"] == 0
    assert ps.loop_gates == ps.loop_attempts
    assert_maps_agree(ps.map, jax.device_get(js.map), "after the drain")
    for f, v in convert.dataclass_to_numpy(jax.device_get(js.loop_state)).items():
        np.testing.assert_array_equal(getattr(ps.loop_state, f).numpy(), v, err_msg=f)


def test_ba_interrupts_counted_like_jax(drained):
    _, ps, fold = drained
    assert ps.ba_iters == fold.ba_iters == [(f, 0, 0) for f in range(ROUNDS)]
    assert ps.n_ba_interrupts == fold.n_ba_interrupts == ROUNDS


def test_drain_chunk_defers_batches(monkeypatch):
    """With drain_chunk > 1 nothing is verified before the batch fills, and
    results() drains what is left; the default (no VO_LOOP_DIAG) closes
    inline and queues nothing."""
    monkeypatch.setenv("VO_LOOP_DIAG", "1")
    ps = system.SlamSystem(SlamConfig(**KW), P_CAPS, device="cpu", drain_chunk=3)
    calls = []
    ps._process_drain = lambda fids, host, landed: calls.append(list(fids))
    minus = torch.full((1, 8), -1, dtype=torch.int32)
    one = torch.zeros((1,), dtype=torch.int32)
    for f in range(7):
        ps._queue_loop([f], minus, minus, one, one)
    assert calls == [[0, 1, 2]] and len(ps._inflight_drain) == 1 and len(ps._pending_loop) == 1
    ps._drain_loop_queue(final=True)
    assert calls == [[0, 1, 2], [3, 4, 5], [6]] and not ps._inflight_drain
    monkeypatch.delenv("VO_LOOP_DIAG")
    assert system.SlamSystem(SlamConfig(**KW), P_CAPS, device="cpu")._inline_close
