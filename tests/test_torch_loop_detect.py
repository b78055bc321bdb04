"""Loop detection: the port's detect_step and advance_consistency
(pipeline/loop_closing.py) against the JAX package's, on the maps of
tests/test_loop_detect.py.

The seven cases of tests/test_loop_detect.py run on the port, and each
detection round's candidates, generations and consistency state (groups,
counts, n_groups) equal JAX's exactly; the randomized case holds both
packages to the file's literal transcription of loopClosing.cpp:95-174 and
to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vo_slam_test_tpu.pipeline import loop_closing as JLC
from vo_slam_test_tpu_torch.bow import retrieval
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from test_loop_detect import CAPS, TestConsistencyGroupDedup, make_map_with_loop
from torch_slam_helpers import port_map

torch.set_num_threads(1)
P_CAPS = MapCaps(max_kf=CAPS.max_kf, max_pt=CAPS.max_pt, max_obs=CAPS.max_obs,
                 n_feat=CAPS.n_feat)


def _rounds(jm, kfs, did=True):
    """detect_step over ``kfs`` in both packages; every round's outputs and
    loop state equal -> the port's first confirmed candidate per round."""
    pm = port_map(jax.device_get(jm))
    jls, pls = JLC.empty_loop_state(CAPS), LC.empty_loop_state(P_CAPS, "cpu")
    first = []
    for kf in kfs:
        jls, jc, jg = JLC.detect_step(jm, jls, jnp.asarray(did), jnp.asarray(kf, jnp.int32), CAPS)
        pls, pc, pg = LC.detect_step(pm, pls, did, kf, P_CAPS)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
        for f in ("groups", "counts", "n_groups", "last_loop_seq"):
            np.testing.assert_array_equal(getattr(pls, f).numpy(), np.asarray(getattr(jls, f)), f)
        c = pc.numpy()
        first.append(int(c[c >= 0][0]) if (c >= 0).any() else -1)
    return first, pls


def test_fourth_consecutive_detection_confirms():
    first, _ = _rounds(make_map_with_loop(), [9, 10, 11, 12])
    assert first[:3] == [-1, -1, -1]
    assert first[3] in (0, 1, 2), first


def test_no_keyframe_noop():
    first, pls = _rounds(make_map_with_loop(), [5], did=False)
    assert first == [-1]
    assert int(pls.n_groups) == 0 and not bool(pls.counts.any())


def test_connected_candidates_excluded():
    jm = make_map_with_loop()
    covis = np.array(jm.covis)
    for q in (9, 10, 11, 12):
        for c in (0, 1, 2):
            covis[q, c] = covis[c, q] = 30
    first, _ = _rounds(jm.replace(covis=jnp.asarray(covis)), [9, 10, 11, 12])
    assert first == [-1] * 4


def test_alternating_groups_both_accumulate():
    """tests/test_loop_detect.py's two disjoint candidate neighbourhoods."""
    rng = np.random.default_rng(1)
    from vo_slam_test_tpu.slam_map.map_state import empty_map

    m = empty_map(CAPS)
    N = CAPS.n_feat
    kf_bow_word = np.full((CAPS.max_kf, N), 1 << 30, np.int64)
    kf_bow_weight = np.zeros((CAPS.max_kf, N), np.float32)
    covis = np.zeros((CAPS.max_kf, CAPS.max_kf), np.int32)
    valid = np.zeros(CAPS.max_kf, bool)
    words_a = np.sort(rng.choice(2048, 40, replace=False))
    words_b = np.sort(rng.choice(np.arange(2048, 4096), 40, replace=False))
    both = np.sort(np.concatenate([words_a[:20], words_b[:20]]))
    for k in range(13):
        valid[k] = True
        if k <= 2:
            words = words_a
        elif k <= 5:
            words = words_b
        elif k >= 9:
            words = both
        else:
            words = np.sort(rng.choice(8192, 40, replace=False) + 8192)
        kf_bow_word[k, :40] = words
        kf_bow_weight[k, :40] = 1.0 / 40
    for group in [(0, 1, 2), (3, 4, 5), (6, 7, 8), (9, 10, 11, 12)]:
        for a in group:
            for b in group:
                if a != b:
                    covis[a, b] = 50
    for q in (9, 10, 11, 12):
        covis[q, 6] = covis[6, q] = 20
    jm = m.replace(
        kf_bow_word=jnp.asarray(kf_bow_word.astype(np.int32)),
        kf_bow_weight=jnp.asarray(kf_bow_weight), covis=jnp.asarray(covis),
        kf_valid=jnp.asarray(valid),
        kf_seq=jnp.asarray(np.where(valid, np.arange(CAPS.max_kf), -1).astype(np.int32)),
        n_kf=jnp.asarray(13, jnp.int32))
    first, pls = _rounds(jm, [9, 10, 11, 12])
    assert (pls.counts.numpy() >= 3).sum() >= 2, pls.counts
    assert first[3] in (0, 1, 2, 3, 4, 5), first


def test_loop_candidates_match_jax():
    """bow/retrieval.py::loop_candidates on each query of the loop map, with
    its own minimum score and a zero one."""
    from vo_slam_test_tpu.bow import retrieval as jretrieval

    jm = make_map_with_loop()
    pm = port_map(jax.device_get(jm))
    for q in range(13):
        s, sh = jretrieval.scores_vs_keyframes(jm.kf_bow_word[q], jm.kf_bow_weight[q],
                                               jm.kf_bow_word, jm.kf_bow_weight,
                                               jm.kf_valid.astype(jnp.float32))
        for min_score in (0.0, float(np.asarray(s).max()) * 0.5):
            want = jretrieval.loop_candidates(s, sh, jm.covis, jm.kf_valid, jnp.asarray(q),
                                              jnp.asarray(min_score, jnp.float32))
            got = retrieval.loop_candidates(torch.as_tensor(np.asarray(s)),
                                            torch.as_tensor(np.asarray(sh)), pm.covis,
                                            pm.kf_valid, q, torch.tensor(min_score))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), f"query {q}")


def _advance_both(cand_groups, top_ok, prev_groups, prev_counts, n_prev):
    """Both packages' advance_consistency against the literal transcription."""
    K = cand_groups.shape[1]
    pg = np.zeros((LC.MAX_GROUPS, K), bool)
    pc = np.zeros((LC.MAX_GROUPS,), np.int32)
    pg[:n_prev] = prev_groups[:n_prev]
    pc[:n_prev] = prev_counts[:n_prev]
    jout = JLC.advance_consistency(jnp.asarray(cand_groups), jnp.asarray(top_ok),
                                   jnp.asarray(pg), jnp.asarray(pc), jnp.asarray(n_prev))
    pout = LC.advance_consistency(torch.as_tensor(cand_groups), torch.as_tensor(top_ok),
                                  torch.as_tensor(pg), torch.as_tensor(pc), torch.tensor(n_prev))
    for got, want in zip(pout, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g, c, n, cc = pout
    want, want_cc = TestConsistencyGroupDedup.oracle(cand_groups, top_ok, prev_groups,
                                                     prev_counts, n_prev)
    want = want[:LC.MAX_GROUPS]
    assert int(n) == len(want)
    got = sorted((g.numpy()[k].tobytes(), int(c[k])) for k in range(len(want)))
    assert got == sorted((w[0].tobytes(), int(w[1])) for w in want)
    np.testing.assert_array_equal(cc.numpy(), np.asarray(want_cc))


def test_two_candidates_share_one_previous_group():
    K, C = 16, 8
    cand_groups = np.zeros((C, K), bool)
    top_ok = np.zeros((C,), bool)
    cand_groups[0, [3, 4]] = True
    cand_groups[1, [3, 7]] = True
    top_ok[:2] = True
    prev_groups = np.zeros((4, K), bool)
    prev_groups[0, [2, 3]] = True
    _advance_both(cand_groups, top_ok, prev_groups, np.array([1, 0, 0, 0], np.int32), 1)


def test_candidate_with_no_intersection_seeds_fresh_group():
    K, C = 16, 8
    cand_groups = np.zeros((C, K), bool)
    top_ok = np.zeros((C,), bool)
    cand_groups[0, [1, 2]] = True
    cand_groups[1, [9, 10]] = True
    top_ok[:2] = True
    prev_groups = np.zeros((4, K), bool)
    prev_groups[0, [2]] = True
    _advance_both(cand_groups, top_ok, prev_groups, np.array([2, 0, 0, 0], np.int32), 1)


def test_randomized_against_oracle():
    rng = np.random.default_rng(7)
    for _ in range(50):
        K, C = 24, 8
        n_prev = int(rng.integers(0, 12))
        cand_groups = rng.random((C, K)) < 0.12
        top_ok = np.arange(C) < rng.integers(0, C + 1)
        cand_groups &= top_ok[:, None]
        for i in range(C):
            if top_ok[i]:
                cand_groups[i, rng.integers(0, K)] = True
        prev_groups = rng.random((12, K)) < 0.12
        prev_counts = rng.integers(0, 4, 12).astype(np.int32)
        _advance_both(cand_groups, top_ok, prev_groups, prev_counts, n_prev)
