"""NLP stack — reference deeplearning4j-nlp (SURVEY.md §2.3; JAX
counterpart deeplearning4j_tpu/nlp).

Host side (pure Python): tokenization, sentence iterators, vocab
construction, Huffman coding (text.py, vocab.py, distributed_vocab.py).
Device side (PyTorch): batched skip-gram/CBOW updates as dense gather ->
dot products -> summed scatter-add steps (lookup.py), driven by
SequenceVectors / Word2Vec; skip-gram runs through the embedding engine
(embedding/engine.py) and its K13 scoring kernel. ParagraphVectors,
GloVe and the on-device epoch pipeline come with later slices (ROADMAP
Queue A item 8).
"""

from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    Huffman,
    VocabCache,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
