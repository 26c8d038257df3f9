"""Place-recognition vocabulary (counterpart of orbslam_jpminipc_tpu/vocab).

`vocabulary.py` holds the flat vocabulary (exact nearest word over a dense
Hamming matrix, DBoW2's six scores, the flat k-medians `build_vocabulary`),
the loaders and `vocab_from_numpy`; `tree.py` the k-ary tree vocabulary
with its level-synchronous batched descent and its builder
`build_tree_vocabulary`; `train.py` the training script
(`python -m orbslam_jpminipc_torch.vocab.train`).
"""
from .tree import TreeVocabulary  # noqa: F401
from .vocabulary import (  # noqa: F401
    Vocabulary, build_vocabulary, load_vocabulary, vocab_from_numpy,
)
