"""Constituency trees (reference: text/corpora/treeparser/{TreeParser,
BinarizeTreeTransformer, CollapseUnaries, TreeVectorizer,
HeadWordFinder}.java — UIMA/OpenNLP-backed in the reference; here trees are
parsed from Penn-style bracketed strings, which is what the reference's
tree fixtures serialise to).

Capabilities: parse, binarize (right-factored), collapse unary chains,
yield/leaves, head-word lookup, and vectorisation of constituents by
averaging word vectors — feeding recursive-net style models.

JAX counterpart deeplearning4j_tpu/nlp/treeparser.py: host code, kept as the
port's own copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Tree:
    """A constituency tree node (reference rnn/Tree used by treeparser)."""

    label: str
    children: List["Tree"] = field(default_factory=list)
    value: Optional[str] = None  # token for leaves

    def is_leaf(self) -> bool:
        return not self.children

    def is_pre_terminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def yield_words(self) -> List[str]:
        if self.is_leaf():
            return [self.value] if self.value is not None else []
        out: List[str] = []
        for c in self.children:
            out.extend(c.yield_words())
        return out

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def to_string(self) -> str:
        if self.is_leaf():
            return self.value or ""
        inner = " ".join(c.to_string() for c in self.children)
        return f"({self.label} {inner})"


class TreeParser:
    """Parse Penn-bracketed strings: `(S (NP (DT the) (NN cat)) (VP ...))`
    (reference TreeParser produces the same structure via OpenNLP)."""

    @staticmethod
    def parse(s: str) -> Tree:
        tokens = s.replace("(", " ( ").replace(")", " ) ").split()
        pos = 0

        def read() -> Tree:
            nonlocal pos
            if tokens[pos] != "(":
                raise ValueError(f"expected '(' at token {pos}")
            pos += 1
            label = tokens[pos]
            pos += 1
            node = Tree(label)
            while tokens[pos] != ")":
                if tokens[pos] == "(":
                    node.children.append(read())
                else:
                    node.children.append(Tree("TOK", value=tokens[pos]))
                    pos += 1
            pos += 1
            return node

        tree = read()
        if pos != len(tokens):
            raise ValueError("trailing tokens after tree")
        return tree


def binarize(tree: Tree) -> Tree:
    """Right-factored binarization (BinarizeTreeTransformer): n-ary nodes
    become nested @-labelled binary nodes."""
    if tree.is_leaf():
        return Tree(tree.label, value=tree.value)
    kids = [binarize(c) for c in tree.children]
    while len(kids) > 2:
        right = Tree(f"@{tree.label}", children=kids[-2:])
        kids = kids[:-2] + [right]
    return Tree(tree.label, children=kids, value=tree.value)


def collapse_unaries(tree: Tree) -> Tree:
    """Collapse unary chains A→B→... to a single A_B node (CollapseUnaries);
    pre-terminals are kept so tokens stay attached to their POS."""
    node = tree
    labels = [node.label]
    while (len(node.children) == 1 and not node.is_pre_terminal()
           and not node.children[0].is_leaf()
           and not node.children[0].is_pre_terminal()):
        node = node.children[0]
        labels.append(node.label)
    collapsed = Tree("_".join(labels), value=node.value)
    collapsed.children = [collapse_unaries(c) for c in node.children]
    return collapsed


class HeadWordFinder:
    """Rightmost-leaf head heuristic (reference HeadWordFinder implements
    Collins-style rules; the rightmost-content-word default covers the
    common English head direction)."""

    @staticmethod
    def find_head(tree: Tree) -> Optional[str]:
        words = tree.yield_words()
        return words[-1] if words else None


class TreeVectorizer:
    """Vectorise constituents by averaging word vectors over each subtree's
    yield (reference TreeVectorizer feeds tree-structured models from
    word2vec vectors)."""

    def __init__(self, word_vector_fn: Callable[[str], Optional[np.ndarray]],
                 dim: int):
        self.word_vector_fn = word_vector_fn
        self.dim = dim

    def vectorize(self, tree: Tree) -> np.ndarray:
        vecs = [v for v in (self.word_vector_fn(w)
                            for w in tree.yield_words()) if v is not None]
        if not vecs:
            return np.zeros(self.dim, np.float32)
        return np.mean(vecs, axis=0).astype(np.float32)

    def vectorize_all(self, tree: Tree) -> List[np.ndarray]:
        """One vector per node, preorder."""
        out = [self.vectorize(tree)]
        for c in tree.children:
            out.extend(self.vectorize_all(c))
        return out
