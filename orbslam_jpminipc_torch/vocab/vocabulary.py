"""Binary-descriptor vocabulary: transform, L1 score, files (counterpart of
orbslam_jpminipc_tpu/vocab/vocabulary.py).

DBoW2's TemplatedVocabulary as a flat word table: its hierarchical
k-means++ `create` (TemplatedVocabulary.h:570-760, with FORB::meanValue
bit-majority centroids, FORB.cpp:28-77) becomes a flat Hamming k-medians
(`build_vocabulary`); the greedy tree `transform` (:1216-1260) becomes an
exact nearest-word assignment over one dense Hamming matrix; scoring is the
L1 metric s = 1 - 0.5 |v - w|_1 on L1-normalized tf-idf vectors
(ScoringObject.cpp:30-68), with DBoW2's five other metrics beside it
(`SCORING`). Tree-format files yield a `TreeVocabulary` (vocab/tree.py).

A vocabulary is built (`build_vocabulary`), loaded from a file
(`load_vocabulary`, `load_dbow2_text`) or carried over from host arrays
(`vocab_from_numpy`), onto a device: `device=None` is the current CUDA
device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamming import hamming_matrix, unpack_bits
from ..utils.device import resolve_device
from . import tree as vtree


class Vocabulary(NamedTuple):
    words: torch.Tensor    # (W, 32) uint8 — word centroid descriptors
    idf: torch.Tensor      # (W,) float32 — inverse document frequency weights

    @property
    def n_words(self):
        return self.words.shape[0]

    @property
    def device(self) -> torch.device:
        return self.words.device


def nearest_word(desc: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N,) int32 exact nearest word id. The minimum runs
    over a packed key `(distance << shift) | word`, so the lowest word id
    wins a tie (the reference's first-minimum `argmin`)."""
    ham = hamming_matrix(desc, words)
    W = words.shape[0]
    shift = max(W.bit_length(), 1)
    col = torch.arange(W, dtype=torch.int32, device=desc.device)
    return (((ham << shift) | col).amin(dim=1) & ((1 << shift) - 1)).to(torch.int32)


def transform(desc: torch.Tensor, valid: torch.Tensor, vocab: Vocabulary) -> torch.Tensor:
    """Descriptors -> dense L1-normalized tf-idf BoW vector (W,)."""
    wid = nearest_word(desc, vocab.words)
    W = vocab.words.shape[0]
    hist = torch.zeros((W,), dtype=torch.float32, device=desc.device)
    hist = hist.index_add(0, wid.to(torch.int64), valid.to(torch.float32))
    v = hist * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-12)


def score_l1(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """L1 similarity of a query vector vs a database matrix (K, W):
    s = 1 - 0.5 |v - w|_1 in [0, 1] for L1-normalized inputs."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v[None, :] - db), dim=-1)


# --- the other five DBoW2 scoring variants (ScoringObject.cpp) -------------
# The reference walks two sorted sparse maps; on dense vectors every variant
# is one reduction over the word axis. Zero entries contribute nothing in
# each formula, so dense == sparse-intersection semantics.

def score_l2(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """L2 similarity (ScoringObject.cpp:73-119): for L2-normalized vectors,
    s = 1 - sqrt(1 - sum(v_i w_i)), clamped to 1 on rounding."""
    dot = db @ v
    return torch.where(dot >= 1.0, 1.0, 1.0 - torch.sqrt(torch.clamp(1.0 - dot, min=0.0)))


def score_chi_square(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Chi-square similarity (ScoringObject.cpp:124-168):
    s = 2 sum(v_i w_i / (v_i + w_i)) over words where v_i + w_i > 0."""
    denom = v[None, :] + db
    term = torch.where(denom > 0, v[None, :] * db / torch.clamp(denom, min=1e-30), 0.0)
    return 2.0 * torch.sum(term, dim=-1)


_LOG_EPS = float(np.log(np.finfo(np.float64).eps))


def score_kl(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """KL divergence of the query from each database vector
    (ScoringObject.cpp:173-221): sum over v_i > 0 of v_i log(v_i / w_i),
    with log(eps) of float64 standing in where w_i = 0. Lower is more
    similar (a divergence, 'cannot be scaled')."""
    vi = v[None, :]
    log_v = torch.where(vi > 0, torch.log(torch.clamp(vi, min=1e-30)), 0.0)
    log_w = torch.where(db > 0, torch.log(torch.clamp(db, min=1e-30)), _LOG_EPS)
    return torch.sum(torch.where(vi > 0, vi * (log_v - log_w), 0.0), dim=-1)


def score_bhattacharyya(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Bhattacharyya coefficient (ScoringObject.cpp:227-266):
    s = sum sqrt(v_i w_i) in [0, 1] for L1-normalized inputs."""
    return torch.sum(torch.sqrt(torch.clamp(v[None, :] * db, min=0.0)), dim=-1)


def score_dot(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Dot-product similarity (ScoringObject.cpp:272-310)."""
    return db @ v


SCORING = {
    "l1": score_l1,
    "l2": score_l2,
    "chi_square": score_chi_square,
    "kl": score_kl,
    "bhattacharyya": score_bhattacharyya,
    "dot": score_dot,
}


# --- building a flat vocabulary ------------------------------------------

_ASSIGN_CHUNK = 16384   # descriptors a Hamming matrix: 16384 x 8192 int32 is 0.5 GB


def _majority_centroids(bits: torch.Tensor, assign: torch.Tensor, k: int):
    """Bit-majority centroid per cluster (FORB::meanValue semantics):
    (N, 256) {0,1}, (N,) cluster ids -> ((k, 256) uint8, (k,) int64 counts).
    Integer sums on the bits' device, so the vote is exact."""
    sums = torch.zeros((k, 256), dtype=torch.int32, device=bits.device)
    sums.index_add_(0, assign, bits.to(torch.int32))
    counts = torch.bincount(assign, minlength=k)
    maj = (sums.to(torch.int64) * 2 > counts[:, None]).to(torch.uint8)
    return maj, counts


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 32) uint8, LSB-first (matches unpack_bits)."""
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=bits.device)
    return (bits.reshape(-1, 32, 8).to(torch.int32) * w).sum(-1).to(torch.uint8)


def _assign(desc: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Nearest word of every descriptor, in chunks of descriptors: (N,) int64."""
    return torch.cat([nearest_word(desc[i:i + _ASSIGN_CHUNK], words).to(torch.int64)
                      for i in range(0, desc.shape[0], _ASSIGN_CHUNK)])


def build_vocabulary(descriptors: np.ndarray, n_words: int = 4096, iters: int = 10,
                     seed: int = 0, device=None) -> Vocabulary:
    """Flat Hamming k-medians from random distinct seeds, on `device`.

    descriptors: (N, 32) uint8 training set (N >> n_words). The assignment
    (the nearest word, lowest id on a tie, as the reference's argmin) and
    the majority vote run on the device; the draws come from a numpy
    generator in the reference's order (the seeds, then the re-seeding of
    empty clusters in each iteration), so the words and idf equal the
    reference's. Each iteration reads the cluster counts and whether the
    centroids moved back to the host.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    descriptors = np.ascontiguousarray(descriptors, np.uint8)
    n = len(descriptors)
    n_words = min(n_words, n)
    desc = torch.from_numpy(descriptors).to(dev)
    bits = unpack_bits(desc)
    centroids = desc[torch.from_numpy(rng.choice(n, n_words, replace=False)).to(dev)]
    for _ in range(iters):
        maj, counts = _majority_centroids(bits, _assign(desc, centroids), n_words)
        # re-seed empty clusters from random points
        empty = np.nonzero(counts.cpu().numpy() == 0)[0]
        if len(empty):
            maj[torch.from_numpy(empty).to(dev)] = bits[
                torch.from_numpy(rng.choice(n, len(empty))).to(dev)]
        new_centroids = _pack_bits(maj)
        same = bool(torch.equal(new_centroids, centroids))
        centroids = new_centroids
        if same:
            break
    # idf from the training corpus (TemplatedVocabulary::setNodeWeights), in
    # float64 on the host as the reference computes it
    df = torch.bincount(_assign(desc, centroids), minlength=n_words).cpu().numpy()
    idf = np.log(n / np.maximum(df.astype(np.float64), 1.0)).astype(np.float32)
    return Vocabulary(words=centroids, idf=torch.from_numpy(idf).to(dev))


def _flat_from_arrays(words, idf, device=None) -> Vocabulary:
    dev = resolve_device(device)
    return Vocabulary(
        words=torch.from_numpy(np.array(words, np.uint8)).to(dev),
        idf=torch.from_numpy(np.array(idf, np.float32)).to(dev))


def vocab_from_numpy(vocab, device=None):
    """Carry a vocabulary held as host arrays (any object with the fields
    of a `TreeVocabulary` or of a `Vocabulary`, such as the reference
    package's) onto `device` as this package's."""
    if hasattr(vocab, "child_idx"):
        return vtree.tree_from_arrays(vocab.child_idx, vocab.node_desc, vocab.node_word,
                                      vocab.word_weight, vocab.depth, device=device)
    return _flat_from_arrays(vocab.words, vocab.idf, device=device)


def load_dbow2_text(path: str, device=None) -> Vocabulary:
    """Load a DBoW2 text vocabulary (the ORBvoc.txt format,
    TemplatedVocabulary::loadFromTextFile, src/main.cc:101) as a flat
    vocabulary: every LEAF node is a word with its tf-idf weight.

    Header line: `k L scoring weighting`; then one node per line:
    `parent_id is_leaf b0 ... b31 weight`.
    """
    words = []
    weights = []
    with open(path) as f:
        header = f.readline().split()
        assert len(header) >= 2, "not a DBoW2 text vocabulary"
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            if not int(parts[1]):
                continue
            words.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))
    return _flat_from_arrays(np.array(words, np.uint8), np.array(weights, np.float32),
                             device=device)


def save_vocabulary(vocab, path: str):
    """Save a flat Vocabulary or a TreeVocabulary (auto-detected on load)."""
    host = lambda t: t.detach().cpu().numpy()
    if isinstance(vocab, vtree.TreeVocabulary):
        np.savez_compressed(
            path,
            child_idx=host(vocab.child_idx), node_desc=host(vocab.node_desc),
            node_word=host(vocab.node_word), word_weight=np.asarray(vocab.word_weight),
            depth=np.int32(vocab.depth),
        )
    else:
        np.savez_compressed(path, words=host(vocab.words), idf=host(vocab.idf))


def load_vocabulary(path: str, device=None):
    """Load a vocabulary npz onto `device`; tree-format files (the
    ORBvoc-scale artifact) yield a TreeVocabulary, flat files a Vocabulary."""
    z = np.load(path)
    if "child_idx" in z:
        return vtree.tree_from_arrays(z["child_idx"], z["node_desc"], z["node_word"],
                                      z["word_weight"], int(z["depth"]), device=device)
    return _flat_from_arrays(z["words"], z["idf"], device=device)
