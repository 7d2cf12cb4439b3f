"""NLP stack — reference deeplearning4j-nlp (SURVEY.md §2.3; JAX
counterpart deeplearning4j_tpu/nlp).

Host side (pure Python): tokenization, sentence and label-aware document
iterators, vocab construction, Huffman coding, co-occurrence counting,
bag-of-words / TF-IDF, the inverted index, moving windows, sentiment,
constituency trees and the annotation engines (text.py, vocab.py,
distributed_vocab.py, bagofwords.py, invertedindex.py, movingwindow.py,
sentiment.py, treeparser.py, annotation.py).
Device side (PyTorch): batched skip-gram/CBOW updates as dense gather ->
dot products -> summed scatter-add steps (lookup.py), driven by
SequenceVectors / Word2Vec / ParagraphVectors; skip-gram runs through
the embedding engine (embedding/engine.py) and its K13 scoring kernel;
the whole-epoch SGNS/CBOW pipeline (device_pipeline.py); GloVe's AdaGrad
epochs (glove.py).
"""

from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    Huffman,
    VocabCache,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (  # noqa: F401
    ParagraphVectors,
)
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
