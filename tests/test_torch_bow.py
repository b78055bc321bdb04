"""The port's BoW vocabulary and retrieval (vo_slam_test_tpu_torch/bow)
against the JAX package's (vo_slam_test_tpu/bow) on the CPU.

Twins of tests/test_bow.py run on the port, and every case is also held
against JAX on the same inputs: the k-means build (the same numpy code and
seed) gives identical trees; transform word ids and feature groups are equal
bit for bit; bow_vector words are equal and its weights within rtol 1e-6 (the
total is a float sum taken in another order); scores_vs_keyframes within rtol
1e-6 and its shared-word counts equal; reloc_candidates masks equal; and the
.npz and DBoW text files written by one package load in the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.bow import retrieval as j_ret
from vo_slam_test_tpu.bow import vocabulary as JV
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.bow import retrieval
from vo_slam_test_tpu_torch.bow import vocabulary as V

RTOL = dict(rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def corpus():
    """tests/test_bow.py's corpus: 30 prototypes with ~12 bits flipped."""
    rng = np.random.default_rng(0)
    protos = rng.integers(0, 2**32, size=(30, 8), dtype=np.uint32)
    descs = []
    for i in range(3000):
        p = protos[i % 30].copy()
        for _ in range(12):
            w = rng.integers(0, 8)
            p[w] ^= np.uint32(1 << rng.integers(0, 32))
        descs.append(p)
    return np.stack(descs)


@pytest.fixture(scope="module")
def voc(corpus):
    return V.build_vocabulary(corpus, k=5, levels=3, seed=1, device="cpu")


@pytest.fixture(scope="module")
def jvoc(corpus):
    return JV.build_vocabulary(corpus, k=5, levels=3, seed=1)


def t(a):
    """uint32 descriptors -> the port's int32 bit patterns."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def words_both(voc, jvoc, desc, valid):
    got = V.transform(voc, t(desc), torch.as_tensor(valid)).numpy()
    want = np.asarray(JV.transform(jvoc, jnp.asarray(desc), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    return got


def vectors_both(voc, jvoc, desc, valid=None):
    valid = np.ones(len(desc), bool) if valid is None else valid
    w = words_both(voc, jvoc, desc, valid)
    uq, wq = retrieval.bow_vector(torch.as_tensor(w), voc.idf)
    juq, jwq = j_ret.bow_vector(jnp.asarray(w), jvoc.idf)
    np.testing.assert_array_equal(uq.numpy(), np.asarray(juq))
    np.testing.assert_allclose(wq.numpy(), np.asarray(jwq), **RTOL)
    return (uq, wq), (juq, jwq)


def test_build_is_the_jax_tree(voc, jvoc):
    assert (voc.k, voc.levels) == (jvoc.k, jvoc.levels)
    for c, jc, v, jv in zip(voc.centroids, jvoc.centroids, voc.node_valid, jvoc.node_valid):
        np.testing.assert_array_equal(c.numpy().view(np.uint32), np.asarray(jc))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(voc.idf.numpy(), np.asarray(jvoc.idf))


def test_build_and_transform(corpus, voc, jvoc):
    assert voc.n_words == 125
    words = words_both(voc, jvoc, corpus[:500], np.ones(500, bool))
    assert words.min() >= 0 and words.max() < 125
    same = sum(words[i] == words[i + 30] for i in range(200))
    assert same > 120, same


def test_transform_invalid_masked(voc, jvoc, corpus):
    valid = np.zeros(10, bool)
    valid[:3] = True
    words = words_both(voc, jvoc, corpus[:10], valid)
    assert (words[3:] == -1).all() and (words[:3] >= 0).all()


def test_save_load_roundtrip(voc, corpus, tmp_path):
    path = str(tmp_path / "voc.npz")
    voc.save(path)
    voc2 = V.Vocabulary.load(path, device="cpu")
    ok = torch.ones(100, dtype=torch.bool)
    assert torch.equal(V.transform(voc, t(corpus[:100]), ok), V.transform(voc2, t(corpus[:100]), ok))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_crosses_packages(writer, voc, jvoc, corpus, tmp_path):
    path = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        voc.save(path)
        other = JV.Vocabulary.load(path)
        got_p, got_j = voc, other
    else:
        jvoc.save(path)
        other = V.Vocabulary.load(path, device="cpu")
        got_p, got_j = other, jvoc
    words_both(got_p, got_j, corpus[:400], np.ones(400, bool))
    np.testing.assert_array_equal(got_p.idf.numpy(), np.asarray(got_j.idf))


def test_feature_groups(voc, jvoc):
    words = [0, 5, 24, 124, -1]
    g = V.feature_groups(voc, torch.tensor(words), levels_up=1).numpy()
    assert g[0] == 0 and g[-1] == -1 and g[3] == 124 // 5
    for up in (1, 2, 3):
        np.testing.assert_array_equal(
            V.feature_groups(voc, torch.tensor(words), levels_up=up).numpy(),
            np.asarray(JV.feature_groups(jvoc, jnp.asarray(words), levels_up=up)))


def test_feature_groups_shallow_vocab_collapses_to_root(voc):
    g = V.feature_groups(voc, torch.tensor([0, 5, 24, 124])).numpy()
    assert (g == 0).all(), g


def test_bow_vector_normalized(voc, jvoc):
    words = np.array([3, 3, 5, 7, -1, 7, 7, 2], np.int32)
    uniq, wgt = retrieval.bow_vector(torch.as_tensor(words), voc.idf)
    juniq, jwgt = j_ret.bow_vector(jnp.asarray(words), jvoc.idf)
    uniq, wgt = uniq.numpy(), wgt.numpy()
    valid = uniq < retrieval.PAD_WORD
    assert sorted(uniq[valid].tolist()) == [2, 3, 5, 7]
    assert wgt[valid].sum() == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_array_equal(uniq, np.asarray(juniq))
    np.testing.assert_allclose(wgt, np.asarray(jwgt), **RTOL)


def test_self_score_is_one(voc, jvoc, corpus):
    (uq, wq), (juq, jwq) = vectors_both(voc, jvoc, corpus[:200])
    score, shared = retrieval.scores_vs_keyframes(uq, wq, uq[None], wq[None], torch.ones(1))
    assert float(score[0]) == pytest.approx(1.0, abs=1e-4)
    jscore, jshared = j_ret.scores_vs_keyframes(juq, jwq, juq[None], jwq[None], jnp.ones((1,)))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **RTOL)
    np.testing.assert_array_equal(shared.numpy(), np.asarray(jshared))


def _kf_set(voc, jvoc, corpus, similar_at, K, seed):
    rng = np.random.default_rng(seed)
    port, jax_ = [], []
    for k in range(K):
        sl = corpus[10:310] if k == similar_at else rng.integers(0, 2**32, (300, 8), np.uint32)
        p, j = vectors_both(voc, jvoc, sl)
        port.append(p)
        jax_.append(j)
    return ((torch.stack([u for u, _ in port]), torch.stack([w for _, w in port])),
            (jnp.stack([u for u, _ in jax_]), jnp.stack([w for _, w in jax_])))


def test_similar_frames_score_higher(voc, jvoc, corpus):
    (uq, wq), (juq, jwq) = vectors_both(voc, jvoc, corpus[:300])
    (kfw, kfwt), (jkfw, jkfwt) = _kf_set(voc, jvoc, corpus, 0, 2, 5)
    score, shared = retrieval.scores_vs_keyframes(uq, wq, kfw, kfwt, torch.ones(2))
    assert float(score[0]) > float(score[1]) * 1.5 and int(shared[0]) > int(shared[1])
    jscore, jshared = j_ret.scores_vs_keyframes(juq, jwq, jkfw, jkfwt, jnp.ones((2,)))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **RTOL)
    np.testing.assert_array_equal(shared.numpy(), np.asarray(jshared))


@pytest.mark.parametrize("covis_kind", ["none", "chain", "seeded"])
def test_reloc_candidates_equal_jax(voc, jvoc, corpus, covis_kind):
    """tests/test_bow.py's retrieval case (no covisibility), plus a chain and
    a seeded covisibility graph with invalid slots, so the group scores and
    the best-member picks take part."""
    K = 8
    (uq, wq), (juq, jwq) = vectors_both(voc, jvoc, corpus[:300])
    (kfw, kfwt), (jkfw, jkfwt) = _kf_set(voc, jvoc, corpus, 3, K, 7)
    valid = np.ones(K, bool)
    covis = np.zeros((K, K), np.int32)
    if covis_kind == "chain":
        for k in range(K - 1):
            covis[k, k + 1] = covis[k + 1, k] = 20 + k
    elif covis_kind == "seeded":
        rng = np.random.default_rng(3)
        c = rng.integers(0, 40, (K, K)) * (rng.random((K, K)) < 0.5)
        covis = np.triu(c, 1) + np.triu(c, 1).T
        valid[[1, 6]] = False
    # a shared-word tie with the similar keyframe: the 0.8 cut and the group
    # scores see equal counts
    kfw[5], kfwt[5] = kfw[3], kfwt[3]
    jkfw, jkfwt = jkfw.at[5].set(jkfw[3]), jkfwt.at[5].set(jkfwt[3])
    score, shared = retrieval.scores_vs_keyframes(uq, wq, kfw, kfwt,
                                                  torch.as_tensor(valid, dtype=torch.float32))
    jscore, jshared = j_ret.scores_vs_keyframes(juq, jwq, jkfw, jkfwt, jnp.asarray(valid, jnp.float32))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), **RTOL)
    mask = retrieval.reloc_candidates(score, shared, torch.as_tensor(covis), torch.as_tensor(valid))
    jmask = j_ret.reloc_candidates(jscore, jshared, jnp.asarray(covis), jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if covis_kind == "none":
        assert mask[3] and int(mask.sum()) <= 3


class TestDbowText:
    def test_text_roundtrip(self, voc, corpus, tmp_path):
        p = str(tmp_path / "voc.txt")
        V.save_dbow_text(voc, p)
        voc2 = V.load_dbow_text(p, device="cpu")
        ok = torch.ones(400, dtype=torch.bool)
        assert torch.equal(V.transform(voc, t(corpus[:400]), ok),
                           V.transform(voc2, t(corpus[:400]), ok))
        np.testing.assert_allclose(voc.idf.numpy(), voc2.idf.numpy(), rtol=1e-6)

    @pytest.mark.parametrize("writer,name", [("port", "voc.txt"), ("jax", "voc.txt"),
                                             ("port", "voc.txt.gz"), ("jax", "voc.txt.gz")])
    def test_text_crosses_packages(self, writer, name, voc, jvoc, corpus, tmp_path):
        p = str(tmp_path / name)
        if writer == "port":
            V.save_dbow_text(voc, p)
        else:
            JV.save_dbow_text(jvoc, p)
        got_p, got_j = V.load_dbow_text(p, device="cpu"), JV.load_dbow_text(p)
        words_both(got_p, got_j, corpus[:400], np.ones(400, bool))
        np.testing.assert_array_equal(got_p.idf.numpy(), np.asarray(got_j.idf))

    def test_ragged_tree_shallow_leaf(self, tmp_path):
        """A DBoW leaf above the final level still becomes a word."""
        d = np.zeros((4, 32), np.int64)
        d[1:] = 255
        d[2, 0] = 254
        d[3, 31] = 253

        def line(par, leaf, desc, w):
            return f"{par} {leaf} " + " ".join(str(int(b)) for b in desc) + f" {w}"
        txt = "\n".join(["2 2 0 0", line(0, 1, d[0], 0.7), line(0, 0, d[1], 0.0),
                         line(2, 1, d[2], 0.5), line(2, 1, d[3], 0.3)])
        p = tmp_path / "ragged.txt"
        p.write_text(txt + "\n")
        voc = V.load_dbow_text(str(p), device="cpu")
        jvoc = JV.load_dbow_text(str(p))
        assert voc.k == 2 and voc.levels == 2
        packed = d.astype(np.uint8).view("<u4").reshape(4, 8)[[0, 2, 3]]
        words = words_both(voc, jvoc, packed, np.ones(3, bool))
        assert len(set(words.tolist())) == 3
        assert np.allclose([voc.idf.numpy()[w] for w in words], [0.7, 0.5, 0.3])


class TestSynthVocabulary:
    def test_transform_full_depth(self):
        voc = V.synth_vocabulary(k=10, levels=3, seed=1, device="cpu")
        jvoc = JV.synth_vocabulary(k=10, levels=3, seed=1)
        assert voc.n_words == 1000
        rng = np.random.default_rng(0)
        desc = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
        valid = np.arange(64) < 60
        words = words_both(voc, jvoc, desc, valid)
        assert ((words[:60] >= 0) & (words[:60] < 1000)).all() and (words[60:] == -1).all()
        assert len(set(words[:60].tolist())) > 30

    def test_full_scale_shapes(self):
        voc = V.synth_vocabulary(k=10, levels=6, seed=0, device="cpu")
        assert voc.n_words == 10**6
        assert tuple(voc.centroids[-1].shape) == (10**6, 8) and tuple(voc.idf.shape) == (10**6,)
        jvoc = JV.synth_vocabulary(k=10, levels=6, seed=0)
        np.testing.assert_array_equal(voc.centroids[-1].numpy().view(np.uint32),
                                      np.asarray(jvoc.centroids[-1]))
        rng = np.random.default_rng(4)
        desc = rng.integers(0, 2**32, (1000, 8), dtype=np.uint32)
        vectors_both(voc, jvoc, desc)


def test_vocabulary_from_jax(jvoc, corpus):
    voc = convert.vocabulary_from_jax(jvoc, "cpu")
    words_both(voc, jvoc, corpus[:300], np.ones(300, bool))
