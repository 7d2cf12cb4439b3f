"""Recurrent layers: GravesLSTM (peepholes), LSTM, the bidirectional
LSTM and GRU (JAX counterpart deeplearning4j_tpu/nn/layers/recurrent.py;
reference layers/recurrent/GravesLSTM.java + LSTMHelpers.java,
GravesBidirectionalLSTM.java, GRU.java).

- Activations are [batch, time, features].
- The input projection for all timesteps is one [B*T, n_in] x
  [n_in, 4n] product, out of the recurrence; the recurrence is a Python
  loop over T of plain tensor ops (the JAX package's `lax.scan`), and
  the backward is autograd through it.
- Params keep the JAX package's names and layout, so they copy across:
  `W` [n_in, 4n] and `RW` [n, 4n] with the gates in the order i, f, g,
  o (GRU: r, u, candidate in thirds of 3n), `b` with the forget slice
  at `forget_gate_bias_init`, and the peepholes as three [n] vectors
  `pi`, `pf` (on c_{t-1}) and `po` (on c_t). torch.nn.LSTM / GRU and
  cuDNN's RNN are not used: they have no peepholes, and their gate
  order and bias layout differ.
- Masking ([B, T], > 0 = a real step): a masked step carries h and c
  unchanged and emits the carried h, as the JAX package's cell does.
- Streaming inference (reference rnnTimeStep): `step()` advances one
  timestep with an explicit carry; `apply(..., initial_carry,
  return_carry=True)` runs a window from a carry and returns the last.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import (
    GravesBidirectionalLSTM,
    GravesLSTM,
    GRU,
    LSTM,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import get_activation


def _lstm_init(conf, gen, dtype, peephole):
    n_in, n = conf.n_in, conf.n_out
    b = torch.zeros(4 * n, dtype=dtype)
    b[n:2 * n] = conf.forget_gate_bias_init
    params = {
        "W": init_weights(gen, (n_in, 4 * n), conf.weight_init, conf.dist,
                          dtype, fan_in=n_in, fan_out=n),
        "RW": init_weights(gen, (n, 4 * n), conf.weight_init, conf.dist,
                           dtype, fan_in=n, fan_out=n),
        "b": b,
    }
    if peephole:
        for k in ("pi", "pf", "po"):
            params[k] = torch.zeros(n, dtype=dtype)
    return params, {}


def _lstm_cell(params, act, peephole):
    n = params["RW"].shape[0]

    def cell(carry, zx, m):
        """One step: carry (h, c), zx [B, 4n] the input projection, m a
        [B, 1] bool mask or None."""
        h, c = carry
        z = zx + h @ params["RW"]
        zi, zf, zg, zo = z.split(n, dim=-1)
        if peephole:
            zi = zi + c * params["pi"]
            zf = zf + c * params["pf"]
        c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        if peephole:
            zo = zo + c_new * params["po"]
        h_new = torch.sigmoid(zo) * act(c_new)
        if m is not None:
            h_new = torch.where(m, h_new, h)
            c_new = torch.where(m, c_new, c)
        return (h_new, c_new), h_new

    return cell


def _scan_time(cell, carry, zx, mask, reverse=False):
    """Run `cell` over the time axis of zx [B, T, k]; mask [B, T] or
    None. Returns (last carry, outputs [B, T, n]), outputs in time order
    also when the scan runs in reverse."""
    T = zx.shape[1]
    m_all = None if mask is None else mask.bool()[..., None]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry, ys[t] = cell(carry, zx[:, t],
                            None if m_all is None else m_all[:, t])
    return carry, torch.stack(ys, dim=1)


class _BaseLSTMImpl(LayerImpl):
    peephole = False

    def init(self, conf, gen, dtype):
        return _lstm_init(conf, gen, dtype, self.peephole)

    def initial_carry(self, conf, batch, dtype=torch.float32, device=None):
        z = torch.zeros(batch, conf.n_out, dtype=dtype, device=device)
        return (z, z.clone())

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None, initial_carry=None, return_carry=False):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        act = get_activation(conf.activation or "tanh")
        zx = x @ params["W"] + params["b"]      # [B, T, 4n], one product
        carry = initial_carry or self.initial_carry(conf, x.shape[0],
                                                    x.dtype, x.device)
        carry, ys = _scan_time(_lstm_cell(params, act, self.peephole),
                               carry, zx, mask)
        if return_carry:
            return ys, state, carry
        return ys, state

    def step(self, conf, params, carry, x_t):
        """One streaming timestep (reference rnnTimeStep); x_t
        [B, n_in]. Returns (carry, h)."""
        act = get_activation(conf.activation or "tanh")
        zx = x_t @ params["W"] + params["b"]
        return _lstm_cell(params, act, self.peephole)(carry, zx, None)


@register_impl(GravesLSTM)
class GravesLSTMImpl(_BaseLSTMImpl):
    peephole = True


@register_impl(LSTM)
class LSTMImpl(_BaseLSTMImpl):
    peephole = False


@register_impl(GravesBidirectionalLSTM)
class BiLSTMImpl(LayerImpl):
    """Forward and backward Graves LSTMs, their outputs summed (reference
    GravesBidirectionalLSTM merges the directions by sum). Params
    {"fwd": {...}, "bwd": {...}}. It needs the whole sequence, so it has
    no `initial_carry` and cannot stream."""

    def init(self, conf, gen, dtype):
        pf, _ = _lstm_init(conf, gen, dtype, peephole=True)
        pb, _ = _lstm_init(conf, gen, dtype, peephole=True)
        return {"fwd": pf, "bwd": pb}, {}

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        act = get_activation(conf.activation or "tanh")
        z = torch.zeros(x.shape[0], conf.n_out, dtype=x.dtype,
                        device=x.device)
        out = 0
        for key, reverse in (("fwd", False), ("bwd", True)):
            p = params[key]
            zx = x @ p["W"] + p["b"]
            _, ys = _scan_time(_lstm_cell(p, act, True), (z, z), zx, mask,
                               reverse=reverse)
            out = out + ys
        return out, state


@register_impl(GRU)
class GRUImpl(LayerImpl):
    """GRU (reference layers/recurrent/GRU.java): reset and update gates
    and the candidate, h = u * h + (1 - u) * c."""

    def init(self, conf, gen, dtype):
        n_in, n = conf.n_in, conf.n_out
        return {
            "W": init_weights(gen, (n_in, 3 * n), conf.weight_init,
                              conf.dist, dtype, fan_in=n_in, fan_out=n),
            "RW": init_weights(gen, (n, 3 * n), conf.weight_init, conf.dist,
                               dtype, fan_in=n, fan_out=n),
            "b": torch.zeros(3 * n, dtype=dtype),
        }, {}

    def initial_carry(self, conf, batch, dtype=torch.float32, device=None):
        return torch.zeros(batch, conf.n_out, dtype=dtype, device=device)

    def _cell(self, conf, params):
        n = conf.n_out
        act = get_activation(conf.activation or "tanh")
        RW = params["RW"]

        def cell(h, zx, m):
            zru = zx[:, :2 * n] + h @ RW[:, :2 * n]
            r = torch.sigmoid(zru[:, :n])
            u = torch.sigmoid(zru[:, n:])
            c = act(zx[:, 2 * n:] + (r * h) @ RW[:, 2 * n:])
            h_new = u * h + (1 - u) * c
            if m is not None:
                h_new = torch.where(m, h_new, h)
            return h_new, h_new

        return cell

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None, initial_carry=None, return_carry=False):
        if conf.dropout:
            x = apply_dropout(x, conf.dropout, generator, train=train)
        zx = x @ params["W"] + params["b"]
        h0 = (initial_carry if initial_carry is not None else
              self.initial_carry(conf, x.shape[0], x.dtype, x.device))
        carry, ys = _scan_time(self._cell(conf, params), h0, zx, mask)
        if return_carry:
            return ys, state, carry
        return ys, state

    def step(self, conf, params, carry, x_t):
        zx = x_t @ params["W"] + params["b"]
        return self._cell(conf, params)(carry, zx, None)
