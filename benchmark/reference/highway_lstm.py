"""Alternating-direction highway LSTM (a copy of the port's
ops/highway_lstm.py). Gate layout:

    gates_i = x  @ W_i          # [*, 6H]  (in, forget, act, out, r, lin)
    gates_h = h  @ W_h          # [*, 5H]  (no recurrent path for lin)
    g_k     = gates_i[k] + gates_h[k] + b[k]   for k < 5;  g_5 = gates_i[5]
    c'      = sigmoid(g_1) * c + sigmoid(g_0) * tanh(g_2)
    h'      = (sigmoid(g_4) * sigmoid(g_3) * tanh(c')
               + (1 - sigmoid(g_4)) * g_5) * dropout_mask

Layer l runs forward over the sequence if l is even, backward if odd. The
input GEMM of a layer is hoisted out of the time loop. Padded steps carry
(h, c) through unchanged and emit zeros. The time loop is an eager Python
loop that never reads a value back to the host. Training's recurrent
(variational) dropout is one [B, H] mask per layer, the same at every step.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def highway_lstm_gates(gi: Tensor, h: Tensor, c: Tensor, w_h: Tensor,
                       bias: Tensor, dropout_mask: Tensor | None = None
                       ) -> tuple[Tensor, Tensor]:
    """One cell step from a pre-projected input gi = x_t @ w_i [B, 6H];
    h, c: [B, H]. Returns (h', c')."""
    hsz = h.shape[-1]
    g = gi[:, :5 * hsz] + h @ w_h + bias
    in_g = torch.sigmoid(g[:, 0 * hsz:1 * hsz])
    fg_g = torch.sigmoid(g[:, 1 * hsz:2 * hsz])
    act = torch.tanh(g[:, 2 * hsz:3 * hsz])
    out_g = torch.sigmoid(g[:, 3 * hsz:4 * hsz])
    r_g = torch.sigmoid(g[:, 4 * hsz:5 * hsz])
    lin = gi[:, 5 * hsz:6 * hsz]
    c_new = fg_g * c + in_g * act
    h_new = r_g * (out_g * torch.tanh(c_new)) + (1.0 - r_g) * lin
    if dropout_mask is not None:
        h_new = h_new * dropout_mask
    return h_new, c_new


def _run_layer(x: Tensor, mask: Tensor, w_i: Tensor, w_h: Tensor,
               bias: Tensor, dropout_mask: Tensor | None, reverse: bool) -> Tensor:
    """x [B, T, D], mask [B, T] (1 = real step) -> [B, T, H], zeros at
    padded steps."""
    if reverse:
        x = torch.flip(x, dims=[1])
        mask = torch.flip(mask, dims=[1])
    b, t, _ = x.shape
    hsz = w_h.shape[0]
    h = x.new_zeros((b, hsz))
    c = x.new_zeros((b, hsz))
    gi_all = x @ w_i                                   # [B, T, 6H]
    ys = []
    for step in range(t):
        h_new, c_new = highway_lstm_gates(gi_all[:, step], h, c, w_h, bias,
                                          dropout_mask)
        m = mask[:, step, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        ys.append(h_new * m)
    out = torch.stack(ys, dim=1)
    if reverse:
        out = torch.flip(out, dims=[1])
    return out


def alternating_highway_lstm(params: list, x: Tensor, lengths: Tensor,
                             dropout_masks: list | None = None) -> Tensor:
    """Stacked alternating-direction highway LSTM.

    params: per layer a dict with w_i [D_in, 6H], w_h [H, 5H], bias [5H];
    x: [B, T, D_in]; lengths: [B] int; dropout_masks: per layer a [B, H]
    mask (training) or None. Returns [B, T, H], zero past each sequence's
    length.
    """
    t = x.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    out = x
    for layer, p in enumerate(params):
        dm = None if dropout_masks is None else dropout_masks[layer]
        out = _run_layer(out, mask, p["w_i"], p["w_h"], p["bias"], dm,
                         reverse=(layer % 2 == 1))
    return out
