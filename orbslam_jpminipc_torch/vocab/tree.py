"""Hierarchical k-ary vocabulary: batched level-wise tree descent
(counterpart of orbslam_jpminipc_tpu/vocab/tree.py).

DBoW2's greedy per-descriptor descent (TemplatedVocabulary.h:1216-1260: at
each node take the child with the least Hamming distance) as a
level-synchronous batched program: for all N query descriptors at once,
gather the k children of each current node, compute the (N, k) pairwise
Hamming distances, take the minimum, advance. The node tables stay on the
vocabulary's device; a transform uploads only the descriptors.

`build_tree_vocabulary` trains the tree (DBoW2's `create`) from a
descriptor set. Word ids are leaf indices; tf-idf weights ride per word (TF_IDF,
TemplatedVocabulary.h:107) and stay on the host, where the sparse BoW
vector is made.

Distances are integers and ties between children are common, so the
minimum is taken over a packed key `(distance << 8) | column`: the lowest
column wins a tie, as the reference's `argmin` (first minimum) does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamming import hamming_pairwise
from ..utils.device import resolve_device

_PAD_DIST = 1 << 20
_COL_BITS = 8


class TreeVocabulary(NamedTuple):
    child_idx: torch.Tensor   # (n_nodes, k) int32 — child node ids, -1 pad
    node_desc: torch.Tensor   # (n_nodes, 32) uint8 — node centroid descriptors
    node_word: torch.Tensor   # (n_nodes,) int32 — word id if leaf else -1
    word_weight: np.ndarray   # (W,) float32 — idf weight per word (host)
    depth: int                # max depth

    @property
    def n_words(self) -> int:
        return int(self.word_weight.shape[0])

    @property
    def k(self) -> int:
        return int(self.child_idx.shape[1])

    @property
    def device(self) -> torch.device:
        return self.node_desc.device


def _descend(desc, child_idx, node_desc, node_word, depth: int):
    """(N, 32) uint8 -> (N,) int32 word ids (leaf indices)."""
    N = desc.shape[0]
    k = child_idx.shape[1]
    if k > (1 << _COL_BITS):
        raise ValueError(f"branching factor {k} above {1 << _COL_BITS}")
    col = torch.arange(k, dtype=torch.int32, device=desc.device)
    cur = torch.zeros(N, dtype=torch.int64, device=desc.device)
    for _ in range(depth):
        kids = child_idx[cur]                                      # (N, k)
        # flat 1-D gather of the children's descriptors; -1 pads read row 0
        # and are masked below
        flat = torch.clamp(kids.reshape(-1), min=0).to(torch.int64)
        kd = node_desc[flat].reshape(N, k, 32)
        d = hamming_pairwise(desc[:, None, :], kd)                 # (N, k)
        d = torch.where(kids >= 0, d, _PAD_DIST)
        best = ((d << _COL_BITS) | col).amin(dim=1) & ((1 << _COL_BITS) - 1)
        nxt = torch.take_along_dim(kids, best[:, None].to(torch.int64), dim=1)[:, 0]
        cur = torch.where(nxt >= 0, nxt.to(torch.int64), cur)      # leaves self-loop
    return node_word[cur]


def word_ids(vocab: TreeVocabulary, desc: torch.Tensor) -> torch.Tensor:
    return _descend(desc, vocab.child_idx, vocab.node_desc, vocab.node_word, vocab.depth)


def host_weights(vocab) -> np.ndarray:
    """The per-word weights on the host: a tree's `word_weight`, or a flat
    vocabulary's `idf` (one host read when that lies on a card)."""
    w = vocab.word_weight if hasattr(vocab, "word_weight") else vocab.idf
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w)


def sparse_bow(vocab, wid: np.ndarray, valid: np.ndarray, weights: np.ndarray | None = None):
    """Host: word ids + validity -> sorted (ids, L1-normalized tf-idf vals).

    Works for TreeVocabulary (word_weight) and the flat Vocabulary (idf);
    `weights` is the host copy of those, when the caller keeps one.
    """
    w = np.asarray(wid)[np.asarray(valid)]
    w = w[w >= 0]
    ids, counts = np.unique(w, return_counts=True)
    if weights is None:
        weights = host_weights(vocab)
    vals = counts.astype(np.float32) * weights[ids]
    s = vals.sum()
    if s > 0:
        vals = vals / s
    return ids.astype(np.int32), vals.astype(np.float32)


def tree_from_arrays(child_idx, node_desc, node_word, word_weight, depth,
                     device=None) -> TreeVocabulary:
    """A TreeVocabulary on `device` from host arrays."""
    dev = resolve_device(device)
    put = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)
    return TreeVocabulary(
        child_idx=put(child_idx, np.int32), node_desc=put(node_desc, np.uint8),
        node_word=put(node_word, np.int32),
        word_weight=np.asarray(word_weight).astype(np.float32), depth=int(depth))


def build_tree_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 4, seed: int = 0,
                          min_cluster: int = 8, device=None) -> TreeVocabulary:
    """Hierarchical Hamming k-medians (TemplatedVocabulary::create
    semantics, :570-760, with FORB::meanValue bit-majority centroids), built
    on the host; the result lies on `device`.

    The nodes are split depth first in the reference's order, and each
    node's k-medians draws from the one numpy generator as the reference's
    does (the distinct seeds, then the re-seeding of empty clusters, up to 6
    rounds), so the tree equals the reference's. The reference unpacks the
    XOR of every (descriptor, centroid) pair to bits; here the same integer
    distances come from popcount(a) + popcount(b) - 2 <a, b>, with <a, b>
    and the majority sums float32 matrix products of 0/1 bits (every sum is
    an integer below 2^24, so exact). Ties go to the first minimum.
    """
    rng = np.random.default_rng(seed)
    descriptors = np.ascontiguousarray(descriptors, np.uint8)
    bits_all = np.unpackbits(descriptors, axis=1, bitorder="little").astype(np.float32)

    child_idx: list[list[int]] = [[]]   # node 0 = root
    node_desc: list[np.ndarray] = [np.zeros(32, np.uint8)]
    node_word: list[int] = [-1]
    weights: list[float] = []

    def kmedians(idx: np.ndarray, kk: int):
        """Cluster a descriptor subset into kk groups: (assign, centroids)."""
        sub = descriptors[idx]
        bits = bits_all[idx]
        pop = bits.sum(1).astype(np.int64)
        kk = min(kk, len(idx))
        cols = np.arange(len(idx))
        cents = sub[rng.choice(len(idx), kk, replace=False)].copy()
        for _ in range(6):
            cb = np.unpackbits(cents, axis=1, bitorder="little").astype(np.float32)
            dot = (bits @ cb.T).astype(np.int64)
            d = pop[:, None] + cb.sum(1).astype(np.int64)[None, :] - 2 * dot
            assign = d.argmin(1)
            onehot = np.zeros((kk, len(idx)), np.float32)
            onehot[assign, cols] = 1.0
            sums = (onehot @ bits).astype(np.int64)
            cnt = np.bincount(assign, minlength=kk)
            maj = (sums * 2 > cnt[:, None]).astype(np.uint8)
            empty = np.nonzero(cnt == 0)[0]
            if len(empty):
                maj[empty] = bits[rng.choice(len(idx), len(empty))].astype(np.uint8)
            new = (maj.reshape(-1, 32, 8) << np.arange(8)).sum(2).astype(np.uint8)
            if (new == cents).all():
                break
            cents = new
        return assign, cents

    def split(node: int, idx: np.ndarray, level: int):
        if level >= depth or len(idx) < max(k, min_cluster):
            # leaf: the next word id, its idf weight from the training counts
            node_word[node] = len(weights)
            weights.append(float(np.log(len(descriptors) / max(len(idx), 1))))
            return
        assign, cents = kmedians(idx, k)
        for c in range(len(cents)):
            sel = idx[assign == c]
            if len(sel) == 0:
                continue
            nid = len(node_desc)
            node_desc.append(cents[c])
            node_word.append(-1)
            child_idx.append([])
            child_idx[node].append(nid)
            split(nid, sel, level + 1)

    split(0, np.arange(len(descriptors)), 0)

    kmax = max((len(c) for c in child_idx), default=1) or 1
    ci = np.full((len(node_desc), kmax), -1, np.int32)
    for n, c in enumerate(child_idx):
        ci[n, : len(c)] = c
    return tree_from_arrays(
        ci, np.stack(node_desc), np.array(node_word, np.int32),
        np.array(weights, np.float32) if weights else np.ones(1, np.float32), depth,
        device=device)


def load_dbow2_tree(path: str, device=None) -> TreeVocabulary:
    """Load the ORBvoc.txt tree format (loadFromTextFile, src/main.cc:101).
    Header: `k L scoring weighting`; then one node per line
    `parent is_leaf b0..b31 weight`, nodes numbered 1.. in file order,
    root = 0 (TemplatedVocabulary.h:1398-1460)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, descs, leaf_w = [], [], []
        for line in f:
            p = line.split()
            if len(p) < 35:
                continue
            parents.append(int(p[0]))
            descs.append([int(x) for x in p[2:34]])
            leaf_w.append(float(p[34]) if int(p[1]) else np.nan)

    n = len(parents) + 1
    node_desc = np.zeros((n, 32), np.uint8)
    node_desc[1:] = np.array(descs, np.uint8)
    node_word = np.full(n, -1, np.int32)
    children: list[list[int]] = [[] for _ in range(n)]
    for i, p in enumerate(parents):
        children[p].append(i + 1)
    weights = []
    wid = 0
    for i, w in enumerate(leaf_w):
        if not np.isnan(w):
            node_word[i + 1] = wid
            weights.append(w)
            wid += 1
    ci = np.full((n, k), -1, np.int32)
    for i, c in enumerate(children):
        ci[i, : min(len(c), k)] = c[:k]
    # DBoW2's L counts levels below the root conservatively
    return tree_from_arrays(ci, node_desc, node_word, np.array(weights, np.float32), L + 1,
                            device=device)
