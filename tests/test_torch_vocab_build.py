"""PyTorch port vs the JAX package: building vocabularies, the other five
DBoW2 scores, the training script and `run.py`'s fallback vocabulary.

Held:
  * `score_l2`, `score_chi_square`, `score_kl`, `score_bhattacharyya`,
    `score_dot` (and `SCORING`) within 1e-6 relative of the reference's on
    tests/test_scoring.py's sparse L1- and L2-normalized vectors;
  * `build_vocabulary` and `build_tree_vocabulary` on the same descriptors
    and seed: EQUAL word/node arrays and idf. Both draw from a numpy
    generator in the same order and break ties the same way. The sets:
    tests/test_vocab_map.py's and tests/test_tree_vocab.py's uniform
    descriptors, and a set of 40 distinct descriptors repeated, where the
    seeds repeat and clusters empty (the re-seeding path);
  * `run.py`'s ad-hoc vocabulary (no file found) equal to the reference's
    `build_vocabulary` on the same call;
  * `train.main` with tiny `--frames/--seeds` writes a file that loads.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.vocab import tree as jtree
from orbslam_jpminipc_tpu.vocab import vocabulary as jvoc
from orbslam_jpminipc_torch.vocab import train as ttrain
from orbslam_jpminipc_torch.vocab import tree as ttree
from orbslam_jpminipc_torch.vocab import vocabulary as tvoc

from test_scoring import _vectors

torch.set_num_threads(2)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("kind", ["l1", "l2", "chi_square", "kl", "bhattacharyya", "dot"])
def test_scores_match_reference(kind, norm):
    v, db = _vectors(np.random.default_rng(3), W=96, K=7, norm=norm)
    got = tvoc.SCORING[kind](torch.from_numpy(v), torch.from_numpy(db)).numpy()
    ref = np.asarray(jvoc.SCORING[kind](jnp.asarray(v), jnp.asarray(db)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def _descriptors(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.integers(0, 256, (3000, 32)).astype(np.uint8)
    # 40 distinct descriptors, each repeated: repeated seeds, empty clusters
    base = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    return base[rng.integers(0, 40, 1200)]


def _assert_flat_equal(got, ref):
    np.testing.assert_array_equal(got.words.numpy(), np.asarray(ref.words))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(ref.idf))


@pytest.mark.parametrize("kind,n_words,iters,seed",
                         [("uniform", 256, 3, 0), ("uniform", 128, 6, 5),
                          ("repeated", 64, 4, 1)])
def test_build_vocabulary_equal(kind, n_words, iters, seed):
    d = _descriptors(kind)
    ref = jvoc.build_vocabulary(d, n_words=n_words, iters=iters, seed=seed)
    got = tvoc.build_vocabulary(d, n_words=n_words, iters=iters, seed=seed, device="cpu")
    _assert_flat_equal(got, ref)
    if kind == "repeated":
        # more words than distinct descriptors: the re-seeding ran
        assert len(np.unique(got.words.numpy(), axis=0)) <= 40


@pytest.mark.parametrize("kind,k,depth,seed",
                         [("uniform", 5, 3, 0), ("uniform", 4, 3, 1), ("repeated", 6, 3, 2)])
def test_build_tree_vocabulary_equal(kind, k, depth, seed):
    d = _descriptors(kind)
    ref = jtree.build_tree_vocabulary(d, k=k, depth=depth, seed=seed)
    got = ttree.build_tree_vocabulary(d, k=k, depth=depth, seed=seed, device="cpu")
    for f in ("child_idx", "node_desc", "node_word"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(got.word_weight, ref.word_weight)
    assert got.depth == ref.depth and got.n_words == ref.n_words


def test_run_fallback_vocabulary_equal(monkeypatch, tmp_path):
    """With neither data file present, `run.py` builds the reference's
    ad-hoc vocabulary: 20,000 random descriptors of default_rng(0), 1024
    words, 3 iterations."""
    from orbslam_jpminipc_torch import run

    monkeypatch.setattr(run, "DATA_DIR", str(tmp_path))
    got = run.default_vocabulary(torch.device("cpu"))
    d = np.random.default_rng(0).integers(0, 256, (20000, 32)).astype(np.uint8)
    ref = jvoc.build_vocabulary(d, n_words=1024, iters=3)
    _assert_flat_equal(got, ref)


def test_run_fallback_order(monkeypatch, tmp_path):
    """The tree file first, else the flat file."""
    from orbslam_jpminipc_torch import run

    monkeypatch.setattr(run, "DATA_DIR", str(tmp_path))
    flat = tvoc.build_vocabulary(_descriptors("uniform"), n_words=32, iters=1, device="cpu")
    tvoc.save_vocabulary(flat, str(tmp_path / "vocab_synthetic.npz"))
    assert isinstance(run.default_vocabulary(torch.device("cpu")), tvoc.Vocabulary)
    tree = ttree.build_tree_vocabulary(_descriptors("uniform"), k=4, depth=2, device="cpu")
    tvoc.save_vocabulary(tree, str(tmp_path / "vocab_tree64k.npz"))
    assert isinstance(run.default_vocabulary(torch.device("cpu")), ttree.TreeVocabulary)


@pytest.mark.parametrize("tree", [False, True])
def test_train_main_writes_a_loadable_file(tmp_path, tree):
    out = str(tmp_path / "v.npz")
    args = ["--frames", "2", "--seeds", "1", "--out", out, "--device", "cpu"]
    args += ["--tree", "--k", "4", "--depth", "2"] if tree else ["--words", "48", "--iters", "2"]
    v = ttrain.main(args)
    loaded = tvoc.load_vocabulary(out, device="cpu")
    if tree:
        assert isinstance(loaded, ttree.TreeVocabulary)
        np.testing.assert_array_equal(loaded.node_desc.numpy(), v.node_desc.numpy())
    else:
        assert loaded.n_words == 48
        np.testing.assert_array_equal(loaded.words.numpy(), v.words.numpy())
    assert os.path.getsize(out) > 0
