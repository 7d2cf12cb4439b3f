"""Text pipeline: tokenizers, preprocessors, sentence iterators (JAX
counterpart deeplearning4j_tpu/nlp/text.py; pure host code, kept as the
port's own copy).

Reference:
- text/tokenization/tokenizer/DefaultTokenizer.java, NGramTokenizer.java,
  preprocessor/{CommonPreprocessor, EndingPreProcessor}.java
- text/tokenization/tokenizerfactory/*
- text/sentenceiterator/{BasicLineIterator, FileSentenceIterator,
  CollectionSentenceIterator, PrefetchingSentenceIterator}
- text/stopwords/StopWords.java
- text/inputsanitation/InputHomogenization.java
- text/movingwindow/{Window, Windows}.java

The label-aware iterators (`LabelsSource`, `LabelAwareIterator`, ...)
come with ParagraphVectors (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from deeplearning4j_tpu_torch.data.prefetcher import EOS, Prefetcher


# --------------------------------------------------------------------------
# Token preprocessors (reference tokenization/tokenizer/preprocessor/*)
# --------------------------------------------------------------------------
class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer (reference EndingPreProcessor: strips s/ed/ing/ly...)."""

    def pre_process(self, token: str) -> str:
        for suffix in ("ing", "ed", "ly", "s"):
            if token.endswith(suffix) and len(token) > len(suffix) + 2:
                return token[: -len(suffix)]
        return token


class StemmingPreprocessor(CommonPreprocessor):
    def pre_process(self, token: str) -> str:
        return EndingPreProcessor().pre_process(super().pre_process(token))


def input_homogenization(s: str, preserve_case: bool = False) -> str:
    """Strip accents/punctuation (reference InputHomogenization.transform)."""
    s = unicodedata.normalize("NFD", s)
    s = "".join(c for c in s if unicodedata.category(c) != "Mn")
    s = re.sub(r"[^\w\s]", "", s)
    return s if preserve_case else s.lower()


# --------------------------------------------------------------------------
# Tokenizers (reference tokenization/tokenizer/*, tokenizerfactory/*)
# --------------------------------------------------------------------------
class Tokenizer:
    """Iterator-style tokenizer (reference Tokenizer interface:
    hasMoreTokens/nextToken/countTokens/getTokens)."""

    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._i = 0
        self._pre = pre_processor

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return self._pre.pre_process(t) if self._pre else t

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out

    def __iter__(self):
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                yield t


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenizer (reference DefaultTokenizer uses StringTokenizer)."""

    def __init__(self, text: str, pre_processor=None):
        super().__init__(text.split(), pre_processor)


class NGramTokenizer(Tokenizer):
    """Emits n-grams joined by spaces (reference NGramTokenizer)."""

    def __init__(self, text: str, min_n: int, max_n: int, pre_processor=None):
        base = DefaultTokenizer(text, pre_processor).get_tokens()
        tokens = list(base) if min_n <= 1 else []
        for n in range(max(2, min_n), max_n + 1):
            for i in range(len(base) - n + 1):
                tokens.append(" ".join(base[i:i + n]))
        super().__init__(tokens, None)


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self):
        self._pre = None

    def create(self, text: str) -> Tokenizer:
        return DefaultTokenizer(text, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n: int, max_n: int):
        self._pre = None
        self.min_n, self.max_n = min_n, max_n

    def create(self, text: str) -> Tokenizer:
        return NGramTokenizer(text, self.min_n, self.max_n, self._pre)


# --------------------------------------------------------------------------
# Sentence iterators (reference text/sentenceiterator/*)
# --------------------------------------------------------------------------
class SentenceIterator:
    """next_sentence/has_next/reset protocol + optional preprocessor
    (reference SentenceIterator interface)."""

    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def _apply(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str], pre_processor=None):
        super().__init__(pre_processor)
        self._sentences = list(sentences)
        self._i = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._i]
        self._i += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._i < len(self._sentences)

    def reset(self):
        self._i = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference BasicLineIterator)."""

    def __init__(self, path: str, pre_processor=None):
        super().__init__(pre_processor)
        self.path = path
        self._fh = None
        self._next = None
        self.reset()

    def _advance(self):
        line = self._fh.readline()
        self._next = line.rstrip("\n") if line else None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._apply(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8", errors="replace")
        self._advance()


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory (reference
    FileSentenceIterator)."""

    def __init__(self, root: str, pre_processor=None):
        super().__init__(pre_processor)
        self.root = root
        self.reset()

    def reset(self):
        self._files = []
        if os.path.isdir(self.root):
            for d, _, fs in sorted(os.walk(self.root)):
                self._files += [os.path.join(d, f) for f in sorted(fs)]
        else:
            self._files = [self.root]
        self._lines: List[str] = []
        self._fi = 0
        self._li = 0
        self._load_next_file()

    def _load_next_file(self):
        while self._fi < len(self._files):
            with open(self._files[self._fi], encoding="utf-8",
                      errors="replace") as fh:
                self._lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
            self._fi += 1
            self._li = 0
            if self._lines:
                return
        self._lines = []

    def has_next(self) -> bool:
        return self._li < len(self._lines)

    def next_sentence(self) -> str:
        s = self._lines[self._li]
        self._li += 1
        if self._li >= len(self._lines):
            self._load_next_file()
        return self._apply(s)


class LineSentenceIterator(BasicLineIterator):
    pass


class PrefetchingSentenceIterator(SentenceIterator):
    """Background-thread prefetch wrapper (reference
    PrefetchingSentenceIterator) — overlaps disk IO with vocab/training.

    An adapter over `data/prefetcher.Prefetcher`: the backend's
    ``reset()`` runs inside the producer thread via the callable-source
    form, and `Prefetcher.stop` joins the superseded producer before a
    successor starts — both generations share the backend iterator, so
    they must never run concurrently."""

    def __init__(self, backend: SentenceIterator, buffer_size: int = 10000):
        super().__init__(None)
        self._backend = backend
        self._size = buffer_size
        self._start()

    def _start(self):
        backend = self._backend

        def source():
            backend.reset()
            while backend.has_next():
                yield backend.next_sentence()

        self._pf = Prefetcher(source, depth=self._size,
                              name="sentence-prefetch")
        self._advance()

    def _advance(self):
        item = self._pf.get()
        self._next = None if item is EOS else item

    def has_next(self) -> bool:
        return self._next is not None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return s

    def reset(self):
        # stop() joins the old producer FULLY (waking it if blocked on a
        # full channel) before the successor touches the shared backend
        self._pf.stop()
        self._start()


# --------------------------------------------------------------------------
# Stop words (reference text/stopwords/StopWords.java — bundled english list)
# --------------------------------------------------------------------------
STOP_WORDS = frozenset("""a an and are as at be but by for if in into is it no
not of on or such that the their then there these they this to was will with
he she his her him i me my we our you your them from has have had do does did
than too very can cannot could should would about after all also am any been
before being between both down during each few further here how more most
other out over own same so some up what when where which while who whom why
""".split())


def get_stop_words() -> List[str]:
    return sorted(STOP_WORDS)


# --------------------------------------------------------------------------
# Moving window (reference text/movingwindow/{Window,Windows}.java)
# --------------------------------------------------------------------------
class Window:
    """A focus word with surrounding context (reference Window.java)."""

    def __init__(self, words: List[str], focus: int, begin: bool, end: bool):
        self.words = words
        self.focus_index = focus
        self.begin = begin
        self.end = end

    def focus_word(self) -> str:
        return self.words[self.focus_index]


def windows(tokens: List[str], window_size: int = 5,
            pad: str = "<none>") -> List[Window]:
    """Sliding windows with edge padding (reference Windows.windows)."""
    half = window_size // 2
    out = []
    for i in range(len(tokens)):
        left = tokens[max(0, i - half):i]
        right = tokens[i + 1:i + 1 + half]
        lpad = [pad] * (half - len(left))
        rpad = [pad] * (half - len(right))
        w = lpad + left + [tokens[i]] + right + rpad
        out.append(Window(w, half, i - half < 0, i + half >= len(tokens)))
    return out


# --------------------------------------------------------------------------
# Sentence → tokens transformer (reference SentenceTransformer in
# models/word2vec — wires iterator + tokenizer factory)
# --------------------------------------------------------------------------
class SentenceTransformer:
    def __init__(self, iterator: SentenceIterator,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Iterable[str] = ()):
        self.iterator = iterator
        self.factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop = frozenset(stop_words)

    def __iter__(self) -> Iterator[List[str]]:
        for sentence in self.iterator:
            toks = self.factory.create(sentence).get_tokens()
            if self.stop:
                toks = [t for t in toks if t not in self.stop]
            if toks:
                yield toks
