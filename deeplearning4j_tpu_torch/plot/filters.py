"""Filter-weight visualization (reference plot/PlotFilters.java and
plot/iterationlistener/PlotFiltersIterationListener.java).

Tiles learned filters into one image grid (the Krizhevsky-style weight
plot): 2D input [n_filters, n_pixels] (e.g. a transposed dense/RBM W) or
4D input [n_filters, h, w, channels] (this framework's NHWC conv kernels
reshaped filter-major). Vectorized numpy — the reference's per-tile
put/get loop becomes one reshape/transpose.

The port's copy of the JAX package's plot/filters.py (numpy on the host, the
same results on the same input); the port imports nothing of that package.
Its listener is a port `IterationListener` that reads a port net's W.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

_EPS = 1e-12


def scale(arr: np.ndarray) -> np.ndarray:
    """Min-max scale to [0, 1] (reference PlotFilters.scale)."""
    arr = arr - arr.min()
    return arr / (arr.max() + _EPS)


class PlotFilters:
    def __init__(self, input_array: np.ndarray,
                 tile_shape: Sequence[int],
                 tile_spacing: Sequence[int] = (0, 0),
                 image_shape: Optional[Sequence[int]] = None,
                 scale_rows_to_interval: bool = True,
                 output_pixels: bool = True):
        self.input = np.asarray(input_array)
        self.tile_shape = tuple(tile_shape)
        self.tile_spacing = tuple(tile_spacing)
        if image_shape is None:
            if self.input.ndim < 3:
                raise ValueError(
                    "image_shape required for 2D input (rows are flat)")
            image_shape = self.input.shape[1:3]
        self.image_shape = tuple(image_shape)
        self.scale_rows_to_interval = scale_rows_to_interval
        self.output_pixels = output_pixels
        self._plot: Optional[np.ndarray] = None

    def _tiles(self) -> np.ndarray:
        """[n, h, w] stack of per-filter images."""
        x = self.input
        h, w = self.image_shape
        if x.ndim == 2:
            tiles = x.reshape(-1, h, w)
        elif x.ndim == 4:
            # NHWC filters: average channels for the grayscale grid
            tiles = x.mean(axis=-1).reshape(-1, h, w)
        elif x.ndim == 3:
            tiles = x.reshape(-1, h, w)
        else:
            raise ValueError(f"unsupported input rank {x.ndim}")
        return tiles.astype(np.float64)

    def plot(self) -> np.ndarray:
        th, tw = self.tile_shape
        hs, ws = self.tile_spacing
        h, w = self.image_shape
        out_shape = ((h + hs) * th - hs, (w + ws) * tw - ws)
        out = np.zeros(out_shape, np.float64)
        tiles = self._tiles()
        for idx in range(min(len(tiles), th * tw)):
            r, c = divmod(idx, tw)
            img = tiles[idx]
            if self.scale_rows_to_interval:
                img = scale(img)
            if self.output_pixels:
                img = img * 255.0
            out[r * (h + hs):r * (h + hs) + h,
                c * (w + ws):c * (w + ws) + w] = img
        self._plot = out
        return out

    def get_plot(self) -> np.ndarray:
        if self._plot is None:
            raise RuntimeError("call plot() first")
        return self._plot


class PlotFiltersIterationListener(IterationListener):
    """Renders a layer's weights every `frequency` iterations (reference
    plot/iterationlistener/PlotFiltersIterationListener.java). The latest
    grid is kept on the listener and optionally written as .npy so any
    host tool (or the UI standalone page) can display it. The layer's W
    is read from the net's device once a rendering (f32)."""

    def __init__(self, layer_name: str, tile_shape: Tuple[int, int] = (10, 10),
                 image_shape: Optional[Tuple[int, int]] = None,
                 frequency: int = 10, output_path: Optional[str] = None):
        self.layer_name = layer_name
        self.tile_shape = tile_shape
        self.image_shape = image_shape
        self.frequency = max(1, frequency)
        self.output_path = output_path
        self.last_plot: Optional[np.ndarray] = None
        self.invoked = 0

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency:
            return
        params = model.params.get(self.layer_name)
        if not params or "W" not in params:
            return
        W = params["W"].detach().float().cpu().numpy()
        if W.ndim == 4:  # conv HWIO -> filter-major [O, H, W, I]
            W = np.transpose(W, (3, 0, 1, 2))
            image_shape = self.image_shape or W.shape[1:3]
            filters = W
        else:  # dense [n_in, n_out] -> rows are filters
            filters = W.T
            image_shape = self.image_shape
            if image_shape is None:
                side = int(np.sqrt(filters.shape[1]))
                image_shape = (side, filters.shape[1] // side)
                filters = filters[:, :image_shape[0] * image_shape[1]]
        pf = PlotFilters(filters, self.tile_shape, (1, 1), image_shape)
        self.last_plot = pf.plot()
        self.invoked += 1
        if self.output_path:
            np.save(self.output_path, self.last_plot)
