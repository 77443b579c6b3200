"""Alternating-direction highway LSTM (counterpart of
neural_motifs_tpu/ops/highway_lstm.py). Gate layout:

    gates_i = x  @ W_i          # [*, 6H]  (in, forget, act, out, r, lin)
    gates_h = h  @ W_h          # [*, 5H]  (no recurrent path for lin)
    g_k     = gates_i[k] + gates_h[k] + b[k]   for k < 5;  g_5 = gates_i[5]
    c'      = sigmoid(g_1) * c + sigmoid(g_0) * tanh(g_2)
    h'      = (sigmoid(g_4) * sigmoid(g_3) * tanh(c')
               + (1 - sigmoid(g_4)) * g_5) * dropout_mask

Layer l runs forward over the sequence if l is even, backward if odd. The
input GEMM of a layer is hoisted out of the time loop. Padded steps carry
(h, c) through unchanged and emit zeros. Training's recurrent (variational)
dropout is one [B, H] mask per layer, the same at every step.

Two evaluations of a layer:
  * `_run_layer`, an eager Python loop over the steps that never reads a
    value back to the host. It runs for CPU tensors, and for CUDA tensors
    while autograd records (relation training), which gets its gradient
    from autograd.
  * `highway_lstm_cuda`, one persistent CUDA kernel a layer
    (csrc/highway_lstm.cu) that runs the whole sequence on the device, each
    row only to its own length. It runs for every other CUDA call (the eval
    forward, under inference mode), for a hidden size up to 4 units a SM
    (528 on an H100 SXM; a larger one raises). It replaces no Pallas
    kernel: the JAX package's recurrence is a lax.scan.
"""

from __future__ import annotations

import torch

from neural_motifs_tpu_torch.ops import _cuda

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


_REFUSED = -1   # nm_highway_lstm's code for a shape it cannot take


def highway_lstm_cuda(gi: Tensor, w_h: Tensor, bias: Tensor, lengths: Tensor,
                      dropout_mask: Tensor | None = None, reverse: bool = False) -> Tensor:
    """Launch the layer kernel: gi = x @ w_i [B, T, 6H], w_h [H, 5H], bias
    [5H], dropout_mask [B, H] or None, all f32 on one CUDA device; lengths
    [B] int -> [B, T, H] f32, zero past each row's length. `reverse` runs
    each row backward from its last real step (an odd layer)."""
    b, t, hsz = gi.shape[0], gi.shape[1], w_h.shape[0]
    if (gi.dim() != 3 or gi.shape[2] != 6 * hsz or tuple(w_h.shape) != (hsz, 5 * hsz)
            or tuple(bias.shape) != (5 * hsz,) or tuple(lengths.shape) != (b,)
            or (dropout_mask is not None and tuple(dropout_mask.shape) != (b, hsz))):
        raise ValueError(f"highway_lstm_cuda: bad shapes gi {tuple(gi.shape)} "
                         f"w_h {tuple(w_h.shape)} bias {tuple(bias.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    floats = (gi, w_h, bias) + (() if dropout_mask is None else (dropout_mask,))
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError("highway_lstm_cuda: gi, w_h, bias and the dropout mask "
                        "must be f32")
    gi, w_h, bias = gi.contiguous(), w_h.contiguous(), bias.contiguous()
    lengths = lengths.to(torch.int64).contiguous()
    if dropout_mask is not None:
        dropout_mask = dropout_mask.contiguous()
    _cuda.require_cuda("highway_lstm_cuda", *floats, lengths)
    out = torch.empty((b, t, hsz), dtype=torch.float32, device=gi.device)
    code = _cuda.lib().nm_highway_lstm(
        gi.data_ptr(), w_h.data_ptr(), bias.data_ptr(), lengths.data_ptr(),
        0 if dropout_mask is None else dropout_mask.data_ptr(), out.data_ptr(),
        b, t, hsz, int(reverse), _cuda.stream_ptr(gi.device))
    if code == _REFUSED:
        raise ValueError(f"highway_lstm_cuda: hidden size {hsz} at batch {b} does "
                         "not fit: at most 4 units a SM, one block a SM in shared memory")
    _cuda.check(code, "highway_lstm_cuda")
    highway_lstm_cuda.launches += 1
    return out


highway_lstm_cuda.launches = 0


def _records_grad(params: list, x: Tensor) -> bool:
    """Whether autograd records this call: grad mode on and the input or a
    parameter requiring a gradient."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(v.requires_grad for p in params for v in p.values()))


def _alternating(params: list, x: Tensor, lengths: Tensor,
                 dropout_masks: list | None, kernel: bool) -> Tensor:
    """The stack, every layer through the kernel or through the eager loop
    (see alternating_highway_lstm)."""
    if not kernel:
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    out = x
    for layer, p in enumerate(params):
        dm = None if dropout_masks is None else dropout_masks[layer]
        reverse = layer % 2 == 1
        if kernel:
            out = highway_lstm_cuda(out @ p["w_i"], p["w_h"], p["bias"], lengths, dm,
                                    reverse)
        else:
            out = _run_layer(out, mask, p["w_i"], p["w_h"], p["bias"], dm, reverse)
    return out


def alternating_highway_lstm(params: list, x: Tensor, lengths: Tensor,
                             dropout_masks: list | None = None) -> Tensor:
    """Stacked alternating-direction highway LSTM.

    params: per layer a dict with w_i [D_in, 6H], w_h [H, 5H], bias [5H];
    x: [B, T, D_in]; lengths: [B] int; dropout_masks: per layer a [B, H]
    mask (training) or None. Returns [B, T, H], zero past each sequence's
    length.

    CUDA tensors go to the layer kernel (the input product a plain GEMM
    before each launch) unless autograd records; CPU tensors, and CUDA
    tensors under autograd, take the eager loop.
    """
    return _alternating(params, x, lengths, dropout_masks,
                        kernel=x.is_cuda and not _records_grad(params, x))
