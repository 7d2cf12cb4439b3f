"""Pluggable text-annotation engines — the UIMA AnalysisEngine slot.

Reference: text/uima/UimaResource.java wraps a UIMA AnalysisEngine +
CasPool; PosUimaTokenizer.java / UimaTokenizer.java and
UimaSentenceIterator.java run sentence-segmentation / tokenization / POS
analysis engines over documents. This module provides the same pluggable
seam without the UIMA machinery: an ``AnnotationEngine`` protocol with

- ``LexiconAnnotationEngine`` (default): pure-python regex sentence
  splitter + whitespace/punct tokenizer + the lexicon/suffix POS tagger
  from `nlp/sentiment.py` — zero dependencies, deterministic.
- ``SpacyAnnotationEngine``: routes all three through a spaCy pipeline
  when spacy + a model are installed (the optional industrial-strength
  engine, like swapping a different UIMA AE descriptor in the reference).

`set_annotation_engine` swaps the process default; the POS-aware
tokenizer factory and sentence detector below route through whatever
engine is current, mirroring how every reference UIMA consumer goes
through UimaResource.

JAX counterpart deeplearning4j_tpu/nlp/annotation.py: host code, kept as the
port's own copy.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Tuple


class AnnotationEngine:
    """Protocol of the reference's UIMA AnalysisEngine consumers: sentence
    segmentation (SentenceAnnotator), tokenization (TokenizerAnnotator)
    and POS tagging (PoStagger)."""

    def sentences(self, text: str) -> List[str]:
        raise NotImplementedError

    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError

    def pos_tags(self, tokens: Iterable[str]) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def annotate(self, text: str) -> List[List[Tuple[str, str]]]:
        """Full document pass: sentences -> tokens -> (token, pos) — the
        shape of the reference's CAS after the sentence/token/POS AEs."""
        return [self.pos_tags(self.tokenize(s)) for s in self.sentences(text)]


_SENT_RE = re.compile(r"(?<=[.!?])\s+(?=[\"'(\[]?[A-Z0-9])")


class LexiconAnnotationEngine(AnnotationEngine):
    """Default engine: regex sentence boundaries (terminal punctuation
    followed by a capitalized/numeric start), regex word tokenizer, and
    the lexicon+suffix POS tagger (`nlp/sentiment.pos_tag`)."""

    def sentences(self, text: str) -> List[str]:
        parts = _SENT_RE.split(text.strip())
        return [p.strip() for p in parts if p.strip()]

    def tokenize(self, text: str) -> List[str]:
        return re.findall(r"\w+(?:'\w+)?|[^\w\s]", text)

    def pos_tags(self, tokens: Iterable[str]) -> List[Tuple[str, str]]:
        from deeplearning4j_tpu_torch.nlp.sentiment import pos_tag

        return pos_tag(tokens)


# spaCy coarse tags -> the SentiWordNet letters the lexicon engine emits
_SPACY_TO_SWN = {
    "NOUN": "n", "PROPN": "n", "PRON": "n", "NUM": "n",
    "VERB": "v", "AUX": "v",
    "ADJ": "a",
    "ADV": "r", "PART": "r",
    "DET": "d", "CCONJ": "c", "SCONJ": "c", "ADP": "p",
}


class SpacyAnnotationEngine(AnnotationEngine):
    """Optional spaCy-backed engine (available() gates on the install).
    Tags map onto the same n/v/a/r/d/c/p letters so SentiWordNet scoring
    and `word#pos` keying work identically across engines."""

    def __init__(self, model: str = "en_core_web_sm"):
        import spacy  # raises ImportError when not installed

        try:
            self._nlp = spacy.load(model)
        except OSError:
            # no downloaded model: blank pipeline with the rule sentencizer
            self._nlp = spacy.blank("en")
            self._nlp.add_pipe("sentencizer")

    @staticmethod
    def available() -> bool:
        try:
            import spacy  # noqa: F401
            return True
        except ImportError:
            return False

    def sentences(self, text: str) -> List[str]:
        return [s.text.strip() for s in self._nlp(text).sents
                if s.text.strip()]

    def tokenize(self, text: str) -> List[str]:
        return [t.text for t in self._nlp(text) if not t.is_space]

    def pos_tags(self, tokens: Iterable[str]) -> List[Tuple[str, str]]:
        toks = list(tokens)
        doc = self._nlp(" ".join(toks))
        tags = [_SPACY_TO_SWN.get(t.pos_, "n") for t in doc if not t.is_space]
        if len(tags) == len(toks):
            return list(zip(toks, tags))
        # tokenization drift (spaCy re-split a token): fall back per-token
        return [(t, _SPACY_TO_SWN.get(self._nlp(t)[0].pos_, "n") if t else "n")
                for t in toks]


_engine: AnnotationEngine = LexiconAnnotationEngine()


def get_annotation_engine() -> AnnotationEngine:
    return _engine


def set_annotation_engine(engine: Optional[AnnotationEngine]) -> None:
    """Swap the process-default engine (None restores the lexicon
    default) — the UimaResource.setAE analogue."""
    global _engine
    _engine = engine if engine is not None else LexiconAnnotationEngine()


class SentenceDetector:
    """Segment raw documents into sentences through the current engine
    (reference UimaSentenceIterator's SentenceAnnotator pass)."""

    def __init__(self, engine: Optional[AnnotationEngine] = None):
        self.engine = engine

    def detect(self, text: str) -> List[str]:
        return (self.engine or get_annotation_engine()).sentences(text)


class AnnotationTokenizerFactory:
    """TokenizerFactory emitting `word#pos` tokens through the current
    engine (reference PosUimaTokenizer: tokens keyed by UIMA POS for
    sense-separated vocabularies)."""

    def __init__(self, engine: Optional[AnnotationEngine] = None):
        self.engine = engine

    def create(self, text: str):
        from deeplearning4j_tpu_torch.nlp.text import Tokenizer

        eng = self.engine or get_annotation_engine()
        tagged = eng.pos_tags(eng.tokenize(text))
        return Tokenizer([f"{w}#{p}" for w, p in tagged])
