"""Sentiment lexicon scoring + POS-aware tokenization.

Reference:
- `deeplearning4j-nlp/.../text/corpora/sentiwordnet/SWN3.java` — loads the
  SentiWordNet 3.0 TSV (`POS<TAB>id<TAB>posScore<TAB>negScore<TAB>terms`),
  averages pos-neg per word#pos across senses weighted 1/rank, and maps a
  score to the strings weak/strong_positive/negative/neutral.
- `deeplearning4j-nlp/.../text/annotator/PoStagger.java` (UIMA) — the POS
  annotations the reference pipeline attaches; here a compact rule-based
  perceptron-free tagger (suffix + lexicon heuristics) provides the same
  `word#pos` keys without the UIMA dependency.

Zero egress: when no SentiWordNet file is supplied, a small built-in seed
lexicon (hand-picked common sentiment words) keeps the API functional;
`SentiWordNet(path)` loads the real file when the user has it.

JAX counterpart deeplearning4j_tpu/nlp/sentiment.py: host code, kept as the
port's own copy.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

# score -> label thresholds (reference SWN3.classifyScore)
_STRONG = 0.5
_WEAK = 0.25

# seed lexicon used when no SentiWordNet file is available: word#pos -> score
_SEED: Dict[str, float] = {
    "good#a": 0.625, "great#a": 0.75, "excellent#a": 0.875,
    "wonderful#a": 0.75, "amazing#a": 0.625, "love#v": 0.625,
    "like#v": 0.375, "enjoy#v": 0.5, "happy#a": 0.625, "best#a": 0.75,
    "nice#a": 0.5, "awesome#a": 0.75, "fantastic#a": 0.75,
    "bad#a": -0.625, "terrible#a": -0.75, "awful#a": -0.75,
    "horrible#a": -0.75, "hate#v": -0.75, "dislike#v": -0.5,
    "worst#a": -0.875, "poor#a": -0.5, "sad#a": -0.5, "angry#a": -0.625,
    "disappointing#a": -0.625, "boring#a": -0.5, "broken#a": -0.375,
}


class SentiWordNet:
    """SWN3 equivalent: per-`word#pos` sentiment scores + classification."""

    def __init__(self, path: Optional[str] = None):
        if path is not None:
            self.scores = self._load(path)
        else:
            self.scores = dict(_SEED)

    @staticmethod
    def _load(path: str) -> Dict[str, float]:
        """Parse the SentiWordNet 3.0 TSV exactly like SWN3.java: each
        `term#rank` contributes (pos-neg)/rank, normalized by sum 1/rank."""
        acc: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5:
                    continue
                pos, _id, p, n, terms = parts[:5]
                try:
                    delta = float(p) - float(n)
                except ValueError:
                    continue
                for term in terms.split():
                    if "#" not in term:
                        continue
                    word, rank = term.rsplit("#", 1)
                    try:
                        acc[f"{word}#{pos}"].append((int(rank), delta))
                    except ValueError:
                        continue
        out: Dict[str, float] = {}
        for key, senses in acc.items():
            total = sum(d / r for r, d in senses)
            norm = sum(1.0 / r for r, _ in senses)
            out[key] = total / norm if norm else 0.0
        return out

    # ------------------------------------------------------------- scoring
    def extract(self, word: str, pos: str = "a") -> float:
        return self.scores.get(f"{word.lower()}#{pos}", 0.0)

    def classify(self, word: str, pos: str = "a") -> str:
        """Reference SWN3 classification strings."""
        return self.classify_score(self.extract(word, pos))

    @staticmethod
    def classify_score(score: float) -> str:
        if score >= _STRONG:
            return "strong_positive"
        if score >= _WEAK:
            return "positive"
        if score > 0:
            return "weak_positive"
        if score <= -_STRONG:
            return "strong_negative"
        if score <= -_WEAK:
            return "negative"
        if score < 0:
            return "weak_negative"
        return "neutral"

    def extract_any(self, word: str, pos: str = "a") -> Optional[float]:
        """Score for word#pos, falling back to the word's other POS senses
        (the tagger is heuristic; a miss shouldn't zero the sentiment)."""
        w = word.lower()
        if f"{w}#{pos}" in self.scores:
            return self.scores[f"{w}#{pos}"]
        for alt in ("a", "n", "v", "r"):
            if f"{w}#{alt}" in self.scores:
                return self.scores[f"{w}#{alt}"]
        return None

    def score_tokens(self, tagged: Iterable[Tuple[str, str]]) -> float:
        """Mean sentiment over (word, pos) pairs with a lexicon hit."""
        hits = [v for v in (self.extract_any(w, p) for w, p in tagged)
                if v is not None]
        return sum(hits) / len(hits) if hits else 0.0


# --------------------------------------------------------------- POS tagger

_POS_LEXICON = {
    "the": "d", "a": "d", "an": "d", "this": "d", "that": "d",
    "i": "n", "you": "n", "he": "n", "she": "n", "it": "n", "we": "n",
    "they": "n", "is": "v", "are": "v", "was": "v", "were": "v", "be": "v",
    "been": "v", "am": "v", "have": "v", "has": "v", "had": "v", "do": "v",
    "does": "v", "did": "v", "will": "v", "would": "v", "can": "v",
    "could": "v", "not": "r", "very": "r", "really": "r", "quite": "r",
    "and": "c", "or": "c", "but": "c", "of": "p", "in": "p", "on": "p",
    "at": "p", "to": "p", "with": "p", "for": "p",
    # common suffix-less adjectives (the seed lexicon keys these as #a)
    "good": "a", "bad": "a", "great": "a", "nice": "a", "best": "a",
    "worst": "a", "poor": "a", "sad": "a", "happy": "a", "cool": "a",
    "new": "a", "old": "a", "big": "a", "small": "a", "fine": "a",
}

_SUFFIX_RULES: List[Tuple[str, str]] = [
    ("ly", "r"),                       # adverbs
    ("ing", "v"), ("ed", "v"),         # verb forms
    ("ous", "a"), ("ful", "a"), ("ive", "a"), ("able", "a"), ("ible", "a"),
    ("al", "a"), ("ic", "a"), ("less", "a"),
    ("ness", "n"), ("ment", "n"), ("tion", "n"), ("sion", "n"), ("ity", "n"),
    ("er", "n"), ("ism", "n"), ("ist", "n"),
]


def pos_tag(tokens: Iterable[str]) -> List[Tuple[str, str]]:
    """Tag tokens with SentiWordNet POS letters (n/v/a/r + d/c/p for
    function words): lexicon first, then suffix heuristics, noun default —
    the shape of the reference's UIMA PoStagger output keyed for SWN3."""
    out = []
    for tok in tokens:
        w = tok.lower()
        if w in _POS_LEXICON:
            out.append((tok, _POS_LEXICON[w]))
            continue
        if re.fullmatch(r"[0-9.,%-]+", w):
            out.append((tok, "n"))
            continue
        for suffix, tag in _SUFFIX_RULES:
            if w.endswith(suffix) and len(w) > len(suffix) + 2:
                out.append((tok, tag))
                break
        else:
            out.append((tok, "n"))
    return out


class PosAwareTokenizerFactory:
    """TokenizerFactory-compatible wrapper that attaches POS tags: its
    tokenizers yield `word#pos` strings (the reference PoStagger + SWN3
    keying), so downstream vocab/embedding pipelines can train on
    sense-separated tokens. Tagging routes through the pluggable
    annotation engine (nlp/annotation.py — the UIMA AnalysisEngine slot),
    so a spaCy engine upgrades this factory without code changes."""

    def __init__(self, base_factory=None, engine=None):
        from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory

        self.base = base_factory or DefaultTokenizerFactory()
        self.engine = engine

    def create(self, text: str):
        from deeplearning4j_tpu_torch.nlp.annotation import get_annotation_engine
        from deeplearning4j_tpu_torch.nlp.text import Tokenizer

        eng = self.engine or get_annotation_engine()
        toks = self.base.create(text).get_tokens()
        return Tokenizer([f"{w}#{p}" for w, p in eng.pos_tags(toks)])
