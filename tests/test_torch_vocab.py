"""PyTorch port vs the JAX package: vocabulary and keyframe database.

The same numpy descriptors go through both packages. Word ids are integers
and held equal, on the shipped 64k-word tree and on a small built tree,
including descriptors built to lie at the same Hamming distance from
several children of one node (the reference's `argmin` takes the first
minimum; the port's packed-key minimum must too). Sparse and dense BoW
vectors are held within 1e-6. The keyframe database's host arrays and its
candidate lists are held equal.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.map.keyframe_db import KeyFrameDatabase as JKeyFrameDatabase
from orbslam_jpminipc_tpu.vocab import tree as jtree
from orbslam_jpminipc_tpu.vocab import vocabulary as jvoc
from orbslam_jpminipc_torch.map.keyframe_db import KeyFrameDatabase
from orbslam_jpminipc_torch.vocab import tree as ttree
from orbslam_jpminipc_torch.vocab import vocabulary as tvoc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_VOCAB = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "vocab_tree64k.npz")
JAX_VOCAB = os.path.join(REPO, "orbslam_jpminipc_tpu", "data", "vocab_tree64k.npz")
BOW_TOL = 1e-6
TREE_FIELDS = ("child_idx", "node_desc", "node_word", "word_weight")


def _descriptors(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 32)).astype(np.uint8)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def shipped():
    return jvoc.load_vocabulary(JAX_VOCAB), tvoc.load_vocabulary(PORT_VOCAB, device="cpu")


@pytest.fixture(scope="module")
def small_tree():
    jv = jtree.build_tree_vocabulary(_descriptors(1, 6000), k=6, depth=3, seed=2)
    return jv, tvoc.vocab_from_numpy(jv, device="cpu")


@pytest.fixture(scope="module")
def flat():
    jv = jvoc.build_vocabulary(_descriptors(2, 4000), n_words=256, iters=2)
    return jv, tvoc.vocab_from_numpy(jv, device="cpu")


def test_load_vocabulary_equals_the_jax_loader(shipped):
    jv, tv = shipped
    assert isinstance(tv, ttree.TreeVocabulary)
    for name in TREE_FIELDS:
        a, b = _np(getattr(tv, name)), np.asarray(getattr(jv, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tv.depth, tv.k, tv.n_words) == (jv.depth, jv.k, jv.n_words)
    assert tv.n_words > 60000


@pytest.mark.parametrize("kind", ["tree", "flat"])
def test_vocab_from_numpy_and_save_load_round_trip(kind, small_tree, flat, tmp_path):
    jv, tv = small_tree if kind == "tree" else flat
    fields = TREE_FIELDS if kind == "tree" else ("words", "idf")
    path = str(tmp_path / "v.npz")
    tvoc.save_vocabulary(tv, path)
    back = tvoc.load_vocabulary(path, device="cpu")
    ref = jvoc.load_vocabulary(path)  # the reference reads the port's file
    assert type(back) is type(tv)
    for name in fields:
        np.testing.assert_array_equal(_np(getattr(back, name)), np.asarray(getattr(jv, name)))
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), np.asarray(getattr(jv, name)))


@pytest.mark.parametrize("which", ["shipped", "small"])
def test_word_ids_match_jax(which, shipped, small_tree):
    jv, tv = shipped if which == "shipped" else small_tree
    desc = _descriptors(3, 1500)
    ref = np.asarray(jtree.word_ids(jv, jnp.asarray(desc)))
    got = ttree.word_ids(tv, torch.from_numpy(desc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).all() and len(np.unique(ref)) > 100


def _tie_descriptors(vocab, rng, n_nodes=40):
    """Descriptors at equal distance from two children of one node: start
    from the first child and flip half of the bits in which the two
    differ (an even count is needed), so both lie d/2 away."""
    child_idx = np.asarray(vocab.child_idx)
    node_desc = np.asarray(vocab.node_desc)
    inner = np.nonzero((child_idx >= 0).sum(axis=1) >= 2)[0]
    out = []
    for node in rng.choice(inner, min(n_nodes, len(inner)), replace=False):
        kids = child_idx[node][child_idx[node] >= 0]
        a, b = rng.choice(kids, 2, replace=False)
        bits_a = np.unpackbits(node_desc[a], bitorder="little")
        diff = np.nonzero(bits_a != np.unpackbits(node_desc[b], bitorder="little"))[0]
        diff = diff[: len(diff) // 2 * 2]
        bits = bits_a.copy()
        bits[rng.permutation(diff)[: len(diff) // 2]] ^= 1
        out.append(np.packbits(bits, bitorder="little"))
    return np.stack(out)


@pytest.mark.parametrize("which", ["shipped", "small"])
def test_word_ids_break_ties_like_jax(which, shipped, small_tree):
    jv, tv = shipped if which == "shipped" else small_tree
    rng = np.random.default_rng(4)
    ties = _tie_descriptors(jv, rng)
    # every node centroid itself (distance 0 to one child, and duplicates of
    # a centroid among siblings tie at 0), and constant descriptors
    centroids = np.asarray(jv.node_desc)[rng.choice(np.asarray(jv.node_desc).shape[0], 200)]
    const = np.stack([np.zeros(32, np.uint8), np.full(32, 255, np.uint8)])
    desc = np.concatenate([ties, centroids, const])
    # the construction ties at the first level below some node
    child_idx = np.asarray(jv.child_idx)
    kd = np.asarray(jv.node_desc)[np.maximum(child_idx, 0)]
    n_tied = 0
    for d in ties:
        ham = np.unpackbits(d[None, None] ^ kd, axis=-1).sum(-1)
        ham = np.where(child_idx >= 0, ham, 1 << 20)
        n_tied += int(((ham == ham.min(axis=1, keepdims=True)).sum(axis=1) >= 2).any())
    assert n_tied >= len(ties) // 2
    ref = np.asarray(jtree.word_ids(jv, jnp.asarray(desc)))
    got = ttree.word_ids(tv, torch.from_numpy(desc)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_descend_masks_pads_and_leaves_self_loop():
    """A ragged hand-made tree: a leaf directly under the root (it must
    self-loop through the remaining levels) and -1 pads that would win an
    unmasked minimum (their row 0 is the all-zero root descriptor)."""
    node_desc = np.zeros((6, 32), np.uint8)
    node_desc[1] = 0xFF          # leaf under the root
    node_desc[2] = 0x0F          # inner node
    node_desc[3] = 0x0F
    node_desc[4] = 0x1F
    node_desc[5] = 0x0F          # same centroid as node 3: a tie at distance 0
    child_idx = np.full((6, 3), -1, np.int32)
    child_idx[0, :2] = [1, 2]
    child_idx[2] = [3, 4, 5]
    node_word = np.array([-1, 0, -1, 1, 2, 3], np.int32)
    desc = np.stack([np.full(32, v, np.uint8) for v in (0xFF, 0x0F, 0x1F, 0x00, 0xF0)])
    args = (child_idx, node_desc, node_word)
    ref = np.asarray(jtree._descend(jnp.asarray(desc), *map(jnp.asarray, args), depth=3))
    got = ttree._descend(torch.from_numpy(desc), *map(torch.from_numpy, args), depth=3).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.tolist()[:3] == [0, 1, 2]  # leaf kept, tie to the first child, exact hit


def test_nearest_word_matches_jax_with_ties(flat):
    jv, tv = flat
    words = np.asarray(jv.words).copy()
    words[17] = words[5]           # duplicated words: ties at every distance
    words[200] = words[5]
    desc = np.concatenate([_descriptors(5, 800), words[[5, 17, 200, 31]]])
    ref = np.asarray(jvoc.nearest_word(jnp.asarray(desc), jnp.asarray(words)))
    got = tvoc.nearest_word(torch.from_numpy(desc), torch.from_numpy(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy()[-4:].tolist() == [5, 5, 5, 31]


def test_transform_and_score_l1_match_jax(flat):
    jv, tv = flat
    desc = _descriptors(6, 700)
    valid = np.random.default_rng(6).random(700) < 0.8
    ref = np.asarray(jvoc.transform(jnp.asarray(desc), jnp.asarray(valid), jv))
    got = tvoc.transform(torch.from_numpy(desc), torch.from_numpy(valid), tv).numpy()
    np.testing.assert_allclose(got, ref, atol=BOW_TOL)
    assert abs(got.sum() - 1.0) < 1e-5
    db = np.stack([np.asarray(jvoc.transform(jnp.asarray(_descriptors(s, 500)),
                                             jnp.ones(500, bool), jv)) for s in (7, 8, 9)])
    np.testing.assert_allclose(
        tvoc.score_l1(torch.from_numpy(got), torch.from_numpy(db)).numpy(),
        np.asarray(jvoc.score_l1(jnp.asarray(ref), jnp.asarray(db))), atol=BOW_TOL)


@pytest.mark.parametrize("kind", ["tree", "flat"])
def test_sparse_bow_matches_jax(kind, small_tree, flat):
    jv, tv = small_tree if kind == "tree" else flat
    rng = np.random.default_rng(10)
    wid = rng.integers(-1, jv.n_words, 900).astype(np.int32)
    valid = rng.random(900) < 0.7
    rids, rvals = jtree.sparse_bow(jv, wid, valid)
    gids, gvals = ttree.sparse_bow(tv, wid, valid)
    np.testing.assert_array_equal(gids, rids)
    np.testing.assert_allclose(gvals, rvals, atol=BOW_TOL)
    assert gids.dtype == np.int32 and gvals.dtype == np.float32


# ---- keyframe database ----------------------------------------------------

def _databases(jv, tv, max_kf=12, S=2048):
    return JKeyFrameDatabase(jv, max_kf, S), KeyFrameDatabase(tv, max_kf, S, device="cpu")


def _assert_same_state(jdb, tdb):
    for name in ("bow_ids", "bow_n", "present"):
        np.testing.assert_array_equal(getattr(tdb, name), getattr(jdb, name), err_msg=name)
    np.testing.assert_allclose(tdb.bow_vals, jdb.bow_vals, atol=BOW_TOL)


def _fill(jdb, tdb, base, rng, kfs):
    """Keyframes that share descriptors with `base` to varying degrees."""
    for kf in kfs:
        desc = base.copy()
        n_new = int(rng.integers(0, len(base)))
        desc[rng.choice(len(base), n_new, replace=False)] = _descriptors(100 + kf, n_new)
        valid = rng.random(len(base)) < 0.9
        jdb.add(kf, desc, valid)
        tdb.add(kf, desc, valid)


@pytest.mark.parametrize("kind", ["tree", "flat"])
def test_keyframe_db_add_erase_and_scores_match_jax(kind, small_tree, flat):
    jv, tv = small_tree if kind == "tree" else flat
    jdb, tdb = _databases(jv, tv)
    rng = np.random.default_rng(11)
    base = _descriptors(12, 600)
    _fill(jdb, tdb, base, rng, range(8))
    _assert_same_state(jdb, tdb)
    for db in (jdb, tdb):
        db.erase(3)
        db.add(5, _descriptors(13, 600), np.ones(600, bool))  # re-add replaces
    _assert_same_state(jdb, tdb)
    q = base.copy()
    qv = rng.random(600) < 0.95
    jq, tq = jdb.query_bow(q, qv), tdb.query_bow(q, qv)
    np.testing.assert_array_equal(tq[0], jq[0])
    np.testing.assert_allclose(tq[1], jq[1], atol=BOW_TOL)
    js, jsc = jdb.shared_and_scores(jq)
    ts, tsc = tdb.shared_and_scores(tq)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, atol=BOW_TOL)
    assert ts[3] == 0 and ts.max() > 0
    np.testing.assert_allclose(tdb.scores(tq), jdb.scores(jq), atol=BOW_TOL)
    for db in (jdb, tdb):
        db.clear()
    _assert_same_state(jdb, tdb)
    assert not tdb.present.any()


def test_keyframe_db_add_truncates_to_the_top_words_like_jax(shipped):
    """More distinct words than the row holds: the top-S by weight are kept
    and renormalised."""
    jv, tv = shipped
    jdb, tdb = _databases(jv, tv, max_kf=3, S=64)
    desc = _descriptors(14, 400)
    valid = np.ones(400, bool)
    assert len(jdb.query_bow(desc, valid)[0]) > 64
    jdb.add(1, desc, valid)
    tdb.add(1, desc, valid)
    _assert_same_state(jdb, tdb)
    assert tdb.bow_n[1] == 64 and abs(tdb.bow_vals[1].sum() - 1.0) < 1e-5


@pytest.mark.parametrize("with_covis", [False, True])
def test_detect_candidates_match_jax(with_covis, small_tree):
    jv, tv = small_tree
    jdb, tdb = _databases(jv, tv)
    rng = np.random.default_rng(15)
    base = _descriptors(16, 600)
    _fill(jdb, tdb, base, rng, range(10))
    covis = np.zeros((12, 12), np.int32)
    if with_covis:
        c = rng.integers(0, 40, (12, 12))
        covis = ((c + c.T) // 2).astype(np.int32)
        np.fill_diagonal(covis, 0)
        jdb.set_covisibility(covis)
        tdb.set_covisibility(covis)
    qv = np.ones(600, bool)
    jq, tq = jdb.query_bow(base, qv), tdb.query_bow(base, qv)
    reloc = tdb.detect_reloc_candidates(tq)
    assert reloc == jdb.detect_reloc_candidates(jq) and len(reloc) >= 1
    row = covis[9].copy()
    if not with_covis:
        row[8] = 20  # one connected keyframe to exclude and to set minScore
    loop = tdb.detect_loop_candidates(9, tq, row.copy())
    assert loop == jdb.detect_loop_candidates(9, jq, row.copy())
    assert 9 not in loop
    # an empty database and an empty query give no candidates in either
    jdb.clear(), tdb.clear()
    assert tdb.detect_reloc_candidates(tq) == jdb.detect_reloc_candidates(jq) == []
