"""Binary-descriptor vocabulary: transform, L1 score, files (counterpart of
orbslam_jpminipc_tpu/vocab/vocabulary.py).

DBoW2's TemplatedVocabulary as a flat word table: the greedy tree
`transform` (TemplatedVocabulary.h:1216-1260) becomes an exact nearest-word
assignment over one dense Hamming matrix; scoring is the L1 metric
s = 1 - 0.5 |v - w|_1 on L1-normalized tf-idf vectors
(ScoringObject.cpp:30-68). Tree-format files yield a `TreeVocabulary`
(vocab/tree.py).

A vocabulary is loaded from a file (`load_vocabulary`, `load_dbow2_text`)
or carried over from host arrays (`vocab_from_numpy`), onto a device:
`device=None` is the current CUDA device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamming import hamming_matrix
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
