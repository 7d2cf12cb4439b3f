"""AsyncDataSetIterator — background host prefetch (JAX counterpart
deeplearning4j_tpu/datasets/async_iterator.py).

Reference: datasets/iterator/AsyncDataSetIterator.java:30-105 (producer
thread + blocking queue; MultiLayerNetwork.fit wraps every iterator in
one, MultiLayerNetwork.java:1014).

A thin adapter over the port's one background-prefetch implementation
(`data/prefetcher.Prefetcher`): the Channel underneath is event-driven
(condition variables, no polling timeouts) and signals EOS or the
producer's error out of band, so the producer's exception is raised on
the consumer thread, and `reset()` works after a producer died and with
a producer parked on a full channel.

The containers' fit loops ride `data/pipeline.iter_prefetched` (which
also moves the tensor conversion and the device copy off the step
thread); this class is the public API for callers that want plain
host-side DataSet prefetch, and it composes with them: fit over an
AsyncDataSetIterator prefetches the DataSets here and converts them
there.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.data.prefetcher import EOS, Prefetcher
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


class AsyncDataSetIterator(DataSetIterator):
    def __init__(self, underlying: DataSetIterator, queue_size: int = 8):
        super().__init__()
        self._under = underlying
        self._size = queue_size
        self._peek = None
        self._start()

    def _start(self):
        under = self._under

        def source():
            while under.has_next():
                yield under.next()

        self._peek = None
        self._pf = Prefetcher(source, depth=self._size,
                              name="async-dataset-iterator")

    def _fill_peek(self):
        if self._peek is None:
            # blocks event-driven; raises the producer's exception here,
            # on the consumer thread, if iteration failed
            self._peek = self._pf.get()

    def has_next(self):
        self._fill_peek()
        return self._peek is not EOS

    def next(self, num=None):
        self._fill_peek()
        if self._peek is EOS:
            raise StopIteration
        ds, self._peek = self._peek, None
        return self._apply_pre(ds)

    def reset(self):
        # stop() wakes a producer blocked on a full channel, discards
        # buffered items under the lock, and joins the thread — drain is
        # immune to any producer death mode (EOS, error, mid-put)
        self._pf.stop()
        self._under.reset()
        self._start()

    def batch(self):
        return self._under.batch()

    def total_examples(self):
        return self._under.total_examples()

    def input_columns(self):
        return self._under.input_columns()

    def total_outcomes(self):
        return self._under.total_outcomes()
