"""Fused RNN operator of the port (counterpart of
``incubator_mxnet_tpu/ops/rnn.py``; reference src/operator/rnn-inl.h and
src/operator/cudnn_rnn-inl.h): vanilla (relu / tanh), LSTM and GRU,
multi-layer and bidirectional, over one flat parameter vector.

The JAX op is a ``lax.scan`` that XLA compiles; it stands in for cuDNN's
fused RNN, which is what MXNet ran on NVIDIA cards.  No Pallas kernel
lies on this path, so on the card the op's counterpart is cuDNN's fused
RNN again, reached through ``torch._VF.{lstm,gru,rnn_tanh,rnn_relu}``.
The route follows the data's device only:

* a CUDA tensor goes to cuDNN (``_cudnn``), with the per-layer,
  per-direction weight views cut from the flat vector (cuDNN's gate
  orders ``[i, f, c, o]`` and ``[r, z, n]`` are the reference's) and
  the states as ``(L*D, N, H)``.  The views are not cuDNN's packed
  layout, so torch copies them into its own buffer on each call.  The
  module-level ``cudnn_calls`` counts these calls, as a kernel wrapper
  counts its launches.  Where cuDNN cannot take the tensor (cuDNN off,
  an unsupported dtype) the op raises: nothing falls back quietly;
* any other tensor (the CPU, ``meta`` for shape inference) takes the
  plain composition (``_plain``): one input projection over all T*N
  rows, then a loop over the steps with the JAX op's gate arithmetic.

Weight layout (``slice_rnn_weights``, reference rnn-inl.h:52-88): per
layer, per direction, all gates' i2h weights (G*H, in) then all gates'
h2h weights (G*H, H); then all biases, i2h then h2h, per layer per
direction.  Inter-layer dropout ``p`` applies to every layer's input but
the first, in training only; cuDNN draws its own mask (other bits than
the plain route's generator).  ``lstm_state_clip_*`` are accepted and
ignored, as in the JAX op.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register_op

__all__ = ["rnn_param_size", "slice_rnn_weights"]

_NUM_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

# calls of the op that went to cuDNN (the card's route)
cudnn_calls = 0


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Length of the flat parameter vector (rnn-inl.h:72-88)."""
    g = _NUM_GATES[mode]
    b = 2 if bidirectional else 1
    size = (input_size + state_size + 2) * state_size * g * b
    size += (num_layers - 1) * g * state_size * (state_size + b * state_size
                                                 + 2) * b
    return size


def slice_rnn_weights(params, num_layers, input_size, state_size,
                      bidirectional, mode):
    """The flat vector (a tensor or a numpy array) as views per layer and
    direction: ``[layer][direction] = [w_i2h (G*H, in), w_h2h (G*H, H),
    b_i2h (G*H,), b_h2h (G*H,)]``."""
    g = _NUM_GATES[mode]
    b = 2 if bidirectional else 1
    h = state_size
    out = []
    p = 0
    for layer in range(num_layers):
        li = input_size if layer == 0 else b * h
        dirs = []
        for _ in range(b):
            w_i2h = params[p:p + g * h * li].reshape(g * h, li)
            p += g * h * li
            w_h2h = params[p:p + g * h * h].reshape(g * h, h)
            p += g * h * h
            dirs.append([w_i2h, w_h2h, None, None])
        out.append(dirs)
    for layer in range(num_layers):
        for d in range(b):
            out[layer][d][2] = params[p:p + g * h]
            p += g * h
            out[layer][d][3] = params[p:p + g * h]
            p += g * h
    return out


def _layer_plain(x, h, c, w_i2h, w_h2h, b_i2h, b_h2h, mode, reverse):
    """One direction of one layer over x (T, N, in): (h_T, c_T, ys)."""
    t_len, n = x.shape[0], x.shape[1]
    xg = torch.matmul(x.reshape(t_len * n, -1), w_i2h.t()).reshape(
        t_len, n, -1) + b_i2h
    ys = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        if mode == "gru":
            hg = torch.matmul(h, w_h2h.t()) + b_h2h
            xr, xz, xn = xg[t].chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            nn_ = torch.tanh(xn + r * hn)
            h = (1.0 - z) * nn_ + z * h
        else:
            g = xg[t] + torch.matmul(h, w_h2h.t()) + b_h2h
            if mode == "lstm":
                i, f, c_in, o = g.chunk(4, dim=-1)
                i, f, o = torch.sigmoid(i), torch.sigmoid(f), \
                    torch.sigmoid(o)
                c = f * c + i * torch.tanh(c_in)
                h = o * torch.tanh(c)
            elif mode == "rnn_relu":
                h = torch.relu(g)
            else:
                h = torch.tanh(g)
        ys[t] = h
    return h, c, torch.stack(ys)


def _plain(generator, x, weights, state, state_cell, mode, num_layers, b,
           p):
    h_outs, c_outs = [], []
    for layer in range(num_layers):
        if layer > 0 and p > 0:
            keep = torch.rand(x.shape, generator=generator,
                              device=x.device) < 1.0 - p
            x = torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                             device=x.device))
        ys = []
        for d in range(b):
            idx = layer * b + d
            c0 = state_cell[idx] if mode == "lstm" else None
            h, c, y = _layer_plain(x, state[idx], c0, *weights[layer][d],
                                   mode, reverse=d == 1)
            h_outs.append(h)
            if mode == "lstm":
                c_outs.append(c)
            ys.append(y)
        x = ys[0] if b == 1 else torch.cat(ys, dim=-1)
    return x, torch.stack(h_outs), (torch.stack(c_outs) if mode == "lstm"
                                    else None)


def _cudnn(x, weights, state, state_cell, mode, num_layers, b, p, train):
    """cuDNN's fused RNN through torch: (out, h_n, c_n or None)."""
    global cudnn_calls
    if not torch.backends.cudnn.is_acceptable(x):
        raise MXNetError(
            f"RNN: cuDNN cannot take a {x.dtype} tensor on {x.device} "
            f"(torch.backends.cudnn.enabled={torch.backends.cudnn.enabled})")
    flat = [w for layer in weights for d in layer for w in d]
    fn = getattr(torch._VF, mode)    # lstm, gru, rnn_tanh, rnn_relu
    # cuDNN takes dense states (a symbol's begin state is a broadcast view)
    state = state.contiguous()
    hx = [state, state_cell.contiguous()] if mode == "lstm" else state
    res = fn(x, hx, flat, True, num_layers, float(p), bool(train), b == 2,
             False)
    cudnn_calls += 1
    return res[0], res[1], (res[2] if mode == "lstm" else None)


@register_op("RNN", aliases=("rnn",), num_outputs=None, needs_rng=True)
def _rnn(generator, data, parameters, state, state_cell=None, *, state_size,
         num_layers, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=False, is_train=True, lstm_state_clip_min=None,
         lstm_state_clip_max=None):
    """Fused multi-layer (bi)RNN.  data (T, N, input_size); state
    (L*D, N, H); state_cell likewise (LSTM only; zeros when absent).
    Returns out (T, N, D*H), or with ``state_outputs`` (out, state_out)
    and for LSTM (out, state_out, statecell_out) (rnn-inl.h:43-44)."""
    b = 2 if bidirectional else 1
    weights = slice_rnn_weights(parameters, num_layers, data.shape[2],
                                state_size, bidirectional, mode)
    if mode == "lstm" and state_cell is None:
        state_cell = torch.zeros_like(state)
    p = float(p) if is_train else 0.0
    if data.is_cuda:
        # cuDNN's backward needs a forward in training mode: a recorded
        # eval forward runs as training without dropout
        train = is_train or (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (data, parameters, state, state_cell)))
        out, h_n, c_n = _cudnn(data, weights, state, state_cell, mode,
                               num_layers, b, p, train)
    else:
        out, h_n, c_n = _plain(generator, data, weights, state, state_cell,
                               mode, num_layers, b, p)
    if not state_outputs:
        return out
    return (out, h_n, c_n) if mode == "lstm" else (out, h_n)
