"""Place recognition: binary vocabulary, BoW scoring, keyframe database.

Device-side replacement for DBoW2 (the reference's Thirdparty/DBoW2/,
TemplatedVocabulary.h): the k-ary vocabulary tree is a set of static level
tensors; transforming N descriptors is L batched [N, k] Hamming argmins on
device. The inverted file and candidate policies (KeyFrameDatabase.cc) stay
host-side — they are control-plane bookkeeping over small sparse lists.

The shipped ORBvoc is stripped from the reference mirror
(.MISSING_LARGE_BLOBS), so we train our own vocabulary (hierarchical binary
k-medians, the DBoW2 training recipe) from sampled ORB descriptors.
"""

from .vocab import BinaryVocabulary, train_vocabulary
from .kf_database import KeyFrameDatabase

__all__ = ["BinaryVocabulary", "train_vocabulary", "KeyFrameDatabase"]
