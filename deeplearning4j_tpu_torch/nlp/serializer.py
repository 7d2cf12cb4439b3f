"""WordVectorSerializer — model I/O in the word2vec interchange formats
(JAX counterpart deeplearning4j_tpu/nlp/serializer.py; the files are
the same, so either package reads what the other writes).

Reference: embeddings/loader/WordVectorSerializer.java (Google word2vec
binary and text formats, zip full-model serialization — SURVEY.md §2.3).
Readers place the tables on `device` (CUDA unless the caller names
another).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zipfile
from typing import Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    VocabWord,
    unigram_table,
)


class WordVectorSerializer:
    # ------------------------------------------------ Google text format
    @staticmethod
    def write_word_vectors(model: SequenceVectors, path: str):
        """One `word v1 v2 ... vD` line per word (reference
        writeWordVectors)."""
        V = model.vocab.num_words()
        vecs = model.lookup_table.vectors()
        with open(path, "w", encoding="utf-8") as fh:
            for i in range(V):
                vals = " ".join(f"{v:.6f}" for v in vecs[i])
                fh.write(f"{model.vocab.word_at_index(i)} {vals}\n")

    @staticmethod
    def load_txt_vectors(path: str, device=None) -> SequenceVectors:
        words, rows = [], []
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                parts = line.rstrip("\n").split(" ")
                if len(parts) == 2 and all(p.isdigit() for p in parts):
                    continue  # optional "V D" header
                words.append(parts[0])
                rows.append(np.array(parts[1:], dtype=np.float32))
        return _model_from_arrays(words, np.stack(rows), device)

    # ----------------------------------------------- Google binary format
    @staticmethod
    def write_binary(model: SequenceVectors, path: str):
        """Google word2vec .bin: header `V D\\n`, then per word
        `word<space><D float32 LE><\\n>` (reference loadGoogleModel
        counterpart)."""
        V = model.vocab.num_words()
        vecs = model.lookup_table.vectors().astype("<f4")
        with open(path, "wb") as fh:
            fh.write(f"{V} {vecs.shape[1]}\n".encode())
            for i in range(V):
                fh.write(model.vocab.word_at_index(i).encode("utf-8") + b" ")
                fh.write(vecs[i].tobytes())
                fh.write(b"\n")

    @staticmethod
    def load_google_model(path: str, binary: bool = True,
                          device=None) -> SequenceVectors:
        if not binary:
            return WordVectorSerializer.load_txt_vectors(path, device)
        with open(path, "rb") as fh:
            header = fh.readline().decode("utf-8").strip().split()
            V, D = int(header[0]), int(header[1])
            words, rows = [], []
            for _ in range(V):
                chars = bytearray()
                while True:
                    c = fh.read(1)
                    if c in (b" ", b""):
                        break
                    chars += c
                words.append(chars.decode("utf-8"))
                rows.append(np.frombuffer(fh.read(4 * D), dtype="<f4"))
                nl = fh.peek(1)[:1] if hasattr(fh, "peek") else b""
                if nl == b"\n":
                    fh.read(1)
        return _model_from_arrays(words, np.stack(rows), device)

    # --------------------------------------------------- full-model zip
    @staticmethod
    def write_full_model(model: SequenceVectors, path: str):
        """Zip with config.json + vocab.json + syn0/syn1/syn1neg .npy
        (reference zip serialization; analogue of ModelSerializer zips)."""
        t = model.lookup_table
        cfg = {"layer_size": model.layer_size,
               "window_size": model.window_size,
               "negative": model.negative, "use_hs": model.use_hs,
               "learning_rate": model.learning_rate, "seed": model.seed}
        vocab = [{"word": w.word, "count": w.count, "code": w.code,
                  "points": w.points} for w in model.vocab.vocab_words()]
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("config.json", json.dumps(cfg))
            z.writestr("vocab.json", json.dumps(vocab))
            for name, arr in (("syn0", t.syn0), ("syn1", t.syn1),
                              ("syn1neg", t.syn1neg)):
                buf = io.BytesIO()
                np.save(buf, arr.detach().cpu().numpy())
                z.writestr(f"{name}.npy", buf.getvalue())

    @staticmethod
    def read_full_model(path: str, device=None) -> SequenceVectors:
        with zipfile.ZipFile(path) as z:
            cfg = json.loads(z.read("config.json"))
            vocab_entries = json.loads(z.read("vocab.json"))
            arrays = {name: np.load(io.BytesIO(z.read(f"{name}.npy")))
                      for name in ("syn0", "syn1", "syn1neg")}
        model = SequenceVectors(
            layer_size=cfg["layer_size"], window_size=cfg["window_size"],
            negative=cfg["negative"], use_hs=cfg["use_hs"],
            learning_rate=cfg["learning_rate"], seed=cfg["seed"],
            device=device)
        cache = VocabCache()
        for e in vocab_entries:
            vw = VocabWord(e["word"], e["count"])
            vw.code, vw.points = e["code"], e["points"]
            cache.add_token(vw)
        cache.finish(min_word_frequency=0)
        model.vocab = cache
        model.lookup_table = InMemoryLookupTable(
            arrays["syn0"].shape[0], cfg["layer_size"], seed=cfg["seed"],
            use_hs=cfg["use_hs"], negative=cfg["negative"],
            device=model.device)
        for name, arr in arrays.items():
            setattr(model.lookup_table, name,
                    torch.from_numpy(arr).to(model.device))
        if cfg["negative"] > 0:
            model._cum_table = unigram_table(cache)
        if cfg["use_hs"]:
            # rebuild the padded huffman arrays from the stored codes so a
            # loaded model can continue training
            model._codes, model._points, model._mask = Huffman(
                cache.vocab_words()).padded_arrays()
        return model


def _model_from_arrays(words, matrix: np.ndarray,
                       device=None) -> SequenceVectors:
    model = SequenceVectors(layer_size=matrix.shape[1], device=device)
    cache = VocabCache()
    # preserve file order: counts descend with position
    for rank, w in enumerate(words):
        cache.add_token(VocabWord(w, float(len(words) - rank)))
    cache.finish(min_word_frequency=0)
    model.vocab = cache
    model.lookup_table = InMemoryLookupTable(len(words), matrix.shape[1],
                                             device=model.device)
    order = [cache.index_of(w) for w in words]
    reordered = np.empty_like(matrix)
    for src, dst in enumerate(order):
        reordered[dst] = matrix[src]
    model.lookup_table.syn0 = torch.from_numpy(reordered).to(model.device)
    return model
