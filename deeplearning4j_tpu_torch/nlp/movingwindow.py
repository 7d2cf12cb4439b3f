"""Moving-window training glue (reference text/movingwindow/
{WindowConverter,ContextLabelRetriever}.java; Window/windows themselves
live in nlp/text.py).

WindowConverter turns context windows into dense examples by concatenating
the word vectors of each window position — the input featurization for
word-level classifiers (e.g. NER over windows). ContextLabelRetriever
strips inline ``<LABEL> ... </LABEL>`` span markup from a sentence and
returns the clean text plus labeled token spans.

JAX counterpart deeplearning4j_tpu/nlp/movingwindow.py: host code, kept as the
port's own copy.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.text import Window

_BEGIN = re.compile(r"^<([A-Za-z0-9_-]+)>$")
_END = re.compile(r"^</([A-Za-z0-9_-]+)>$")

NONE_LABEL = "NONE"


class WindowConverter:
    @staticmethod
    def as_example_array(window: Window, vec, normalize: bool = False
                         ) -> np.ndarray:
        """Concatenate the window's word vectors into one [w * dim] row
        (reference WindowConverter.asExampleArray). Unknown words get the
        zero vector. `vec` is a Word2Vec-like model exposing
        word_vector(word)."""
        parts = []
        for word in window.words:
            v = vec.word_vector(word)
            if v is None:
                dim = vec.layer_size if hasattr(vec, "layer_size") else None
                if dim is None:
                    raise ValueError("cannot infer vector size for OOV word")
                v = np.zeros((dim,), np.float32)
            v = np.asarray(v, np.float32)
            if normalize:
                n = float(np.linalg.norm(v))
                if n > 0:
                    v = v / n
            parts.append(v)
        return np.concatenate(parts)

    @staticmethod
    def as_example_matrix(windows: List[Window], vec,
                          normalize: bool = False) -> np.ndarray:
        return np.stack([
            WindowConverter.as_example_array(w, vec, normalize)
            for w in windows])


def string_with_labels(sentence: str, tokenizer_factory=None
                       ) -> Tuple[str, Dict[Tuple[int, int], str]]:
    """Strip ``<L> ... </L>`` markup and return (clean sentence,
    {(begin_token, end_token): label}) with NONE spans omitted from the
    map (reference ContextLabelRetriever.stringWithLabels — mismatched or
    nested markers raise, matching its assertions)."""
    if tokenizer_factory is not None:
        tokens = tokenizer_factory.create(sentence).get_tokens()
    else:
        tokens = sentence.split()

    clean: List[str] = []
    spans: Dict[Tuple[int, int], str] = {}
    curr_label: Optional[str] = None
    span_start = 0
    for tok in tokens:
        mb = _BEGIN.match(tok)
        me = _END.match(tok)
        if mb:
            if curr_label is not None:
                raise ValueError(
                    f"nested begin label <{mb.group(1)}> inside "
                    f"<{curr_label}>")
            curr_label = mb.group(1)
            span_start = len(clean)
        elif me:
            if curr_label is None:
                raise ValueError(
                    f"end label </{me.group(1)}> with no begin label")
            if me.group(1) != curr_label:
                raise ValueError(
                    f"label mismatch: <{curr_label}> closed by "
                    f"</{me.group(1)}>")
            if curr_label != NONE_LABEL:
                spans[(span_start, len(clean))] = curr_label
            curr_label = None
        else:
            clean.append(tok)
    if curr_label is not None:
        raise ValueError(f"unclosed label <{curr_label}>")
    return " ".join(clean), spans
