"""Place-recognition vocabulary (counterpart of orbslam_jpminipc_tpu/vocab).

`vocabulary.py` holds the flat vocabulary (exact nearest word over a dense
Hamming matrix), the loaders and `vocab_from_numpy`; `tree.py` the k-ary
tree vocabulary with its level-synchronous batched descent. The trainers
(`build_vocabulary`, `build_tree_vocabulary`, the training script) are not
ported: a vocabulary is loaded from a file or carried over as numpy arrays.
"""
from .tree import TreeVocabulary  # noqa: F401
from .vocabulary import Vocabulary, load_vocabulary, vocab_from_numpy  # noqa: F401
