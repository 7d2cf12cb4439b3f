"""Word2Vec with the on-device skip-gram pipeline (the port's twin of
examples/word2vec_embeddings.py). Runs on the card; `--device cpu` runs
it on the CPU."""
import argparse
import os
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

rng = np.random.default_rng(0)
sents = []
for _ in range(800):
    i = rng.integers(0, 30)
    sents.append([f"city{i}", f"country{i}"] * 3)

w2v = (Word2Vec.builder()
       .layer_size(64)
       .window_size(2)
       .min_word_frequency(1)
       .negative_sample(5)
       .epochs(3)
       .use_device_pipeline(True)   # corpus on the device, one pass an epoch
       .device(args.device)
       .build())
w2v.fit(sents)

print("sim(city3, country3) =", w2v.similarity("city3", "country3"))
print("sim(city3, country17) =", w2v.similarity("city3", "country17"))
print("nearest to city5:", w2v.words_nearest("city5", 3))

path = os.path.join(tempfile.gettempdir(), "vectors.txt")
WordVectorSerializer.write_word_vectors(w2v, path)
print("saved", path)
