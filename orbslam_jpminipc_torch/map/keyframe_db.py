"""Keyframe database: loop-closure and relocalization candidate retrieval
(counterpart of orbslam_jpminipc_tpu/map/keyframe_db.py).

src/KeyFrameDatabase.cc. The reference walks an inverted file (word id ->
observing keyframes) per query word; here the same sparse BoW data lives
as dense PADDED per-keyframe sorted word rows (max_kf x S), and the whole
shared-word + L1-score pass is ONE vectorized searchsorted over all
keyframes at once: O(K*S log Q) whatever the vocabulary size. The BoW
transform runs on the database's device (flat nearest-word matrix for
small vocabularies, batched tree descent for large ones, vocab/tree.py)
and comes back in one host read; the candidate gating below is host numpy.

DetectLoopCandidates (KeyFrameDatabase.cc:75-196):
  - exclude the query's covisible keyframes,
  - count shared words; keep candidates with > 0.8 * maxCommonWords (:119),
  - require L1 score >= minScore (min BoW similarity among covisible KFs),
  - accumulate scores over each candidate's top-10 covisibility group,
  - return best-of-group for groups scoring > 0.75 * best group score.

DetectRelocalisationCandidates (:198-308): same gates without the
covisibility exclusion / minScore.

L1 similarity of L1-normalized sparse vectors reduces to
s = sum_common min(v_i, w_i)  (ScoringObject.cpp:30-68 algebra).
"""
from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device
from ..utils.host import fetch, upload
from ..utils.tracing import get_tracer
from ..vocab import tree as vtree
from ..vocab import vocabulary as voc


class KeyFrameDatabase:
    def __init__(self, vocab, max_kf: int, max_words_per_kf: int = 2048, device=None):
        self.vocab = vocab
        self.device = resolve_device(device)
        if vocab.device != self.device:
            raise ValueError(f"the vocabulary lies on {vocab.device}, the database on "
                             f"{self.device}")
        self.max_kf = max_kf
        S = max_words_per_kf
        self.bow_ids = np.full((max_kf, S), -1, np.int32)
        self.bow_vals = np.zeros((max_kf, S), np.float32)
        self.bow_n = np.zeros(max_kf, np.int32)
        self.present = np.zeros(max_kf, bool)
        # host copy of the per-word weights: the sparse vector is host work
        self._weights = vtree.host_weights(vocab)

    # -- BoW transform (device) ----------------------------------------

    def _word_ids(self, desc: np.ndarray) -> np.ndarray:
        """Word id per descriptor: the transform on the database's device,
        one host read."""
        with get_tracer().stage("bow_word_ids"):
            d = upload(desc, self.device)
            if isinstance(self.vocab, vtree.TreeVocabulary):
                wid = vtree.word_ids(self.vocab, d)
            else:
                wid = voc.nearest_word(d, self.vocab.words)
            return fetch(wid)[0]

    def _bow(self, desc: np.ndarray, feat_valid: np.ndarray):
        wid = self._word_ids(desc)
        return vtree.sparse_bow(self.vocab, wid, feat_valid, weights=self._weights)

    def query_bow(self, desc: np.ndarray, feat_valid: np.ndarray):
        """(ids, vals): sorted word ids + L1-normalized tf-idf weights."""
        with get_tracer().stage("kfdb_query_bow"):
            return self._bow(desc, feat_valid)

    def bow_of(self, kf: int):
        n = int(self.bow_n[kf])
        return self.bow_ids[kf, :n], self.bow_vals[kf, :n]

    # -- maintenance -----------------------------------------------------

    def add(self, kf: int, desc: np.ndarray, feat_valid: np.ndarray):
        with get_tracer().stage("kfdb_add"):
            self._add(kf, desc, feat_valid)

    def _add(self, kf: int, desc: np.ndarray, feat_valid: np.ndarray):
        if self.present[kf]:
            self.erase(kf)
        ids, vals = self._bow(desc, feat_valid)
        S = self.bow_ids.shape[1]
        if len(ids) > S:
            # keep the top-S words by weight and renormalize so stored
            # vectors stay L1-normalized (similarities would skew otherwise)
            keep = np.sort(np.argsort(-vals)[:S])
            ids, vals = ids[keep], vals[keep]
            vals = vals / max(vals.sum(), 1e-12)
        n = len(ids)
        self.bow_ids[kf, :n] = ids
        self.bow_ids[kf, n:] = -1
        self.bow_vals[kf, :n] = vals
        self.bow_vals[kf, n:] = 0
        self.bow_n[kf] = n
        self.present[kf] = True

    def erase(self, kf: int):
        """KeyFrameDatabase::erase (:47)."""
        self.present[kf] = False
        self.bow_n[kf] = 0
        self.bow_ids[kf] = -1
        self.bow_vals[kf] = 0

    def clear(self):
        self.present[:] = False
        self.bow_n[:] = 0
        self.bow_ids[:] = -1
        self.bow_vals[:] = 0

    # -- scoring ----------------------------------------------------------

    def shared_and_scores(self, qbow):
        """(#shared words, L1 score) vs every keyframe, as ONE vectorized
        sorted-intersection: each stored row's word ids are sorted
        (np.unique order), so searchsorted into the sorted query ids finds
        the common words of ALL keyframes in one batched pass."""
        q_ids, q_vals = qbow
        shared = np.zeros(self.max_kf, np.int32)
        score = np.zeros(self.max_kf, np.float32)
        if len(q_ids) == 0 or not self.present.any():
            return shared, score
        rows = self.bow_ids                      # (K, S) sorted, -1 pad
        pos = np.searchsorted(q_ids, np.maximum(rows, 0))
        pos_c = np.minimum(pos, len(q_ids) - 1)
        hit = (rows >= 0) & (q_ids[pos_c] == rows)
        shared = hit.sum(axis=1).astype(np.int32)
        mins = np.minimum(q_vals[pos_c], self.bow_vals)
        score = np.where(hit, mins, 0.0).sum(axis=1).astype(np.float32)
        shared[~self.present] = 0
        score[~self.present] = 0.0
        return shared, score

    def scores(self, qbow) -> np.ndarray:
        _, s = self.shared_and_scores(qbow)
        s[~self.present] = -1.0
        return s

    # -- retrieval ---------------------------------------------------------

    _covis_matrix: np.ndarray | None = None

    def set_covisibility(self, covis: np.ndarray):
        """Provide the covisibility matrix for group accumulation."""
        self._covis_matrix = covis

    def _group_select(self, cand: np.ndarray, scores: np.ndarray,
                      top_group: int, min_covis_weight: int) -> list[int]:
        """Covisibility-group score accumulation + 0.75 * best gate
        (KeyFrameDatabase.cc:146-196 / :262-306)."""
        cand_set = set(cand.tolist())
        acc, best_of_group = {}, {}
        for c in cand:
            group = [c]
            if self._covis_matrix is not None:
                row = self._covis_matrix[c].copy()
                row[c] = 0
                order = np.argsort(-row)[:top_group]
                group += [int(g) for g in order
                          if row[g] >= min_covis_weight and int(g) in cand_set]
            acc[c] = float(scores[group].sum())
            best_of_group[c] = int(group[int(np.argmax(scores[group]))])
        best_acc = max(acc.values())
        keep = {best_of_group[c] for c, s in acc.items() if s > 0.75 * best_acc}
        return sorted(keep)

    def detect_loop_candidates(
        self,
        query_kf: int,
        qbow,
        covis_weights: np.ndarray,   # (MAX_KF,) covisibility row of query
        min_covis_weight: int = 15,
        top_group: int = 10,
    ) -> list[int]:
        shared, scores = self.shared_and_scores(qbow)
        connected = covis_weights >= min_covis_weight
        connected[query_kf] = True

        shared_ext = shared.copy()
        shared_ext[~self.present | connected] = 0
        if shared_ext.max() == 0:
            return []
        # shared-word prefilter: > 0.8 * maxCommonWords (:119)
        min_common = 0.8 * shared_ext.max()

        # minScore: lowest similarity to a covisible KF (LoopClosing.cc:136-150)
        covis_scores = scores[connected & self.present]
        min_score = covis_scores.min() if len(covis_scores) else 0.0

        cand = np.nonzero(
            self.present & ~connected & (shared > min_common)
            & (scores >= min_score)
        )[0]
        n_shared_gate = int((self.present & ~connected
                             & (shared > min_common)).sum())
        get_tracer().log(
            "loop_gates", kf=int(query_kf),
            max_shared=int(shared_ext.max()), min_common=round(min_common, 1),
            min_score=round(float(min_score), 4),
            n_nonconnected=int((self.present & ~connected).sum()),
            n_shared_gate=n_shared_gate, n_score_gate=int(len(cand)),
        )
        if len(cand) == 0:
            return []
        return self._group_select(cand, scores, top_group, min_covis_weight)

    def detect_reloc_candidates(self, qbow, top_group: int = 10,
                                min_covis_weight: int = 15) -> list[int]:
        with get_tracer().stage("kfdb_detect_reloc"):
            return self._detect_reloc_candidates(qbow, top_group, min_covis_weight)

    def _detect_reloc_candidates(self, qbow, top_group, min_covis_weight) -> list[int]:
        shared, scores = self.shared_and_scores(qbow)
        shared_ext = shared.copy()
        shared_ext[~self.present] = 0
        if shared_ext.max() == 0:
            return []
        min_common = 0.8 * shared_ext.max()  # (:234)
        cand = np.nonzero(self.present & (shared > min_common) & (scores > 0))[0]
        if len(cand) == 0:
            return []
        return self._group_select(cand, scores, top_group, min_covis_weight)
