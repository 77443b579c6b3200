"""LinearizedContext — object context LSTM -> decoder -> edge context LSTM
(a copy of the port's models/context.py, its eval path with both LSTMs),
in f32. For the benchmark's judgement the decoder can be fed a judged
run's greedy commitments (`forced`), and the edge context that run's
object classes, so that the reference follows that run's decisions and
its logits can be compared.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from benchmark.reference.boxes import center_size, nms_overlaps
from benchmark.reference.common import to_onehot
from benchmark.reference.highway_lstm import alternating_highway_lstm
from benchmark.reference.nms import sort_desc

Tensor = torch.Tensor

NEG = -1e9


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the feature axis of a [..., F] tensor with its running
    statistics (eval), in f32, returning x's type."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Tensor) -> Tensor:
        y = ((x.float() - self.running_mean)
             * torch.rsqrt(self.running_var + self.eps) * self.weight + self.bias)
        return y.to(x.dtype)


class AlternatingHighwayLSTM(nn.Module):
    """Parameters `l{i}_w_i` [D_in, 6H], `l{i}_w_h` [H, 5H], `l{i}_bias` [5H]
    per layer over highway_lstm.alternating_highway_lstm."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        h = hidden_size
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else h
            self.register_parameter(f"l{layer}_w_i", nn.Parameter(torch.empty(d_in, 6 * h)))
            self.register_parameter(f"l{layer}_w_h", nn.Parameter(torch.empty(h, 5 * h)))
            self.register_parameter(f"l{layer}_bias", nn.Parameter(torch.zeros(5 * h)))

    def forward(self, x: Tensor, lengths: Tensor) -> Tensor:
        params = [{"w_i": getattr(self, f"l{i}_w_i"), "w_h": getattr(self, f"l{i}_w_h"),
                   "bias": getattr(self, f"l{i}_bias")} for i in range(self.num_layers)]
        return alternating_highway_lstm(params, x, lengths)


class DecoderRNN(nn.Module):
    """Sequential object-label decoder: a highway-LSTM cell over the
    linearized RoIs, feeding back the embedding of the previous committed
    label (the greedy non-background label, or the judged run's with
    `forced`), then the global leave-one-out NMS decode."""

    def __init__(self, num_classes: int, input_dim: int, hidden_dim: int,
                 embed_dim: int = 100, nms_thresh: float = 0.3):
        super().__init__()
        self.num_classes = num_classes
        self.nms_thresh = nms_thresh
        h = hidden_dim
        self.obj_embed = nn.Parameter(torch.zeros(num_classes + 1, embed_dim))
        self.input_w = nn.Parameter(torch.empty(input_dim + embed_dim, 6 * h))
        self.input_b = nn.Parameter(torch.zeros(6 * h))
        self.state_w = nn.Parameter(torch.empty(h, 5 * h))
        self.state_b = nn.Parameter(torch.zeros(5 * h))
        self.out_w = nn.Parameter(torch.empty(h, num_classes))
        self.out_b = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x: Tensor, mask: Tensor, boxes_for_nms: Tensor | None = None,
                forced: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """x [B, T, D] (sorted), mask [B, T], boxes_for_nms [B, T, NC, 4],
        forced [B, T] -> (logits [B, T, NC], commitments [B, T])."""
        b, t, dx = x.shape
        h = self.state_w.shape[0]
        w_i_x, w_i_e = self.input_w[:dx], self.input_w[dx:]
        pre_all = x @ w_i_x + self.input_b
        prev_h = x.new_zeros((b, h))
        prev_c = x.new_zeros((b, h))
        prev_e = self.obj_embed[0].expand(b, -1)
        logits_seq, commits_seq = [], []
        for step in range(t):
            pi = pre_all[:, step] + prev_e @ w_i_e
            ps = prev_h @ self.state_w + self.state_b
            in_g = torch.sigmoid(pi[:, 0 * h:1 * h] + ps[:, 0 * h:1 * h])
            fg_g = torch.sigmoid(pi[:, 1 * h:2 * h] + ps[:, 1 * h:2 * h])
            act = torch.tanh(pi[:, 2 * h:3 * h] + ps[:, 2 * h:3 * h])
            out_g = torch.sigmoid(pi[:, 3 * h:4 * h] + ps[:, 3 * h:4 * h])
            r_g = torch.sigmoid(pi[:, 4 * h:5 * h] + ps[:, 4 * h:5 * h])
            lin = pi[:, 5 * h:6 * h]
            c = in_g * act + fg_g * prev_c
            out = r_g * (out_g * torch.tanh(c)) + (1.0 - r_g) * lin
            logits = out @ self.out_w + self.out_b
            commit = (torch.argmax(logits[:, 1:], dim=1) + 1 if forced is None
                      else forced[:, step])
            m = mask[:, step, None]
            prev_h = torch.where(m, out, prev_h)
            prev_c = torch.where(m, c, prev_c)
            prev_e = torch.where(m, self.obj_embed[commit + 1], prev_e)
            logits_seq.append(logits)
            commits_seq.append(commit)
        logits = torch.stack(logits_seq, dim=1)
        commits = torch.stack(commits_seq, dim=1)
        if boxes_for_nms is not None and forced is None:
            commits = self._nms_decode(logits, mask, boxes_for_nms)
        return logits, commits

    def _nms_decode(self, logits: Tensor, mask: Tensor, boxes_for_nms: Tensor) -> Tensor:
        """Global leave-one-out NMS decode: pick the global (box, class)
        argmax, commit it, zero the same class on overlapping boxes, never
        revisit the chosen box."""
        b, t, nc = logits.shape
        probs = torch.softmax(logits, dim=-1)
        probs[..., 0] = 0.0
        probs = torch.where(mask[..., None], probs, torch.full_like(probs, -1.0))
        is_over = nms_overlaps(boxes_for_nms) >= self.nms_thresh   # [B, T, T, NC]
        n_valid = mask.sum(dim=1)
        rows = torch.arange(b, device=logits.device)
        commits = torch.zeros((b, t), dtype=torch.int64, device=logits.device)
        for i in range(t):
            best = torch.argmax(probs.reshape(b, -1), dim=1)
            box_i = torch.div(best, nc, rounding_mode="floor")
            cls_i = best % nc
            cls_i = torch.where(i < n_valid, cls_i, commits[rows, box_i])
            commits[rows, box_i] = cls_i
            over = is_over[rows, box_i, :, cls_i]
            col = probs[rows, :, cls_i]
            probs[rows, :, cls_i] = torch.where(over, torch.zeros_like(col), col)
            probs[rows, box_i, :] = -1.0
        return torch.where(mask, commits, torch.zeros_like(commits))


def sort_by_order(order: str, boxes: Tensor, valid: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Per-image linearization (perm, inv_perm, lengths): valid rows first,
    left to right by box centre; padded rows last."""
    if order != "leftright":
        raise ValueError(f"the reference holds the leftright order, not {order!r}")
    centers = center_size(boxes)[..., 0]
    scores = centers / (torch.amax(centers, dim=1, keepdim=True) + 1.0)
    key = torch.where(valid, scores, torch.full_like(scores, NEG))
    _, perm = sort_desc(key, dim=1)
    return perm, inverse_permutation(perm), valid.sum(dim=1)


def inverse_permutation(perm: Tensor) -> Tensor:
    ar = torch.arange(perm.shape[1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(1, perm, ar)


def permute(x: Tensor, perm: Tensor) -> Tensor:
    """Gather rows of [B, O, ...] by a per-image permutation [B, O]."""
    idx = perm.reshape(perm.shape + (1,) * (x.dim() - 2)).expand(perm.shape + x.shape[2:])
    return x.gather(1, idx)


class ContextOutput(NamedTuple):
    obj_dists: Tensor
    obj_preds: Tensor
    edge_ctx: Tensor


class LinearizedContext(nn.Module):
    """The object context LSTM (`nl_obj` layers), the decoder (not in
    predcls, where the GT labels are the predictions) and the edge context
    LSTM (`nl_edge` layers), with the port's parameter names."""

    def __init__(self, num_classes: int, embed_dim: int, hidden_dim: int, obj_dim: int,
                 nl_obj: int, nl_edge: int, order: str, mode: str,
                 decoder_embed_dim: int = 100):
        super().__init__()
        if nl_obj < 1 or nl_edge < 1:
            raise ValueError("the reference holds the context with both LSTMs only")
        self.num_classes = num_classes
        self.mode = mode
        self.order = order
        self.obj_embed = nn.Parameter(torch.zeros(num_classes, embed_dim))
        self.obj_embed2 = nn.Parameter(torch.zeros(num_classes, embed_dim))
        self.pos_bn = MaskedBatchNorm(4)
        self.pos_fc = nn.Linear(4, 128)
        pre_dim = obj_dim + embed_dim + 128
        self.obj_ctx_rnn = AlternatingHighwayLSTM(pre_dim, hidden_dim, nl_obj)
        if mode != "predcls":
            self.decoder_rnn = DecoderRNN(num_classes, hidden_dim, hidden_dim,
                                          embed_dim=decoder_embed_dim)
        self.edge_ctx_rnn = AlternatingHighwayLSTM(embed_dim + hidden_dim, hidden_dim,
                                                   nl_edge)

    def forward(self, obj_fmaps: Tensor, obj_logits: Tensor, boxes: Tensor,
                valid: Tensor, obj_labels: Optional[Tensor] = None,
                boxes_per_cls: Optional[Tensor] = None,
                forced_greedy: Optional[Tensor] = None,
                forced_preds: Optional[Tensor] = None) -> ContextOutput:
        """obj_fmaps [B,O,obj_dim]; obj_logits [B,O,NC]; boxes [B,O,4]; valid
        [B,O]; obj_labels [B,O] (predcls); boxes_per_cls [B,O,NC,4] (sgdet's
        decode); forced_greedy / forced_preds [B,O]: the judged run's
        decoder commitments and object classes, in the objects' order."""
        obj_embedded = torch.softmax(obj_logits, dim=-1) @ self.obj_embed
        pos = torch.relu(self.pos_fc(self.pos_bn(center_size(boxes))))
        obj_pre_rep = torch.cat([obj_fmaps, obj_embedded, pos], -1)

        perm, inv_perm, lengths = sort_by_order(self.order, boxes, valid)
        enc = self.obj_ctx_rnn(permute(obj_pre_rep, perm), lengths)
        if self.mode == "predcls":
            obj_preds = obj_labels
            obj_dists = to_onehot(obj_preds, self.num_classes)
        else:
            bpc = None if boxes_per_cls is None else permute(boxes_per_cls, perm)
            forced = None if forced_greedy is None else forced_greedy.gather(1, perm)
            dists, preds = self.decoder_rnn(enc, valid.gather(1, perm), bpc, forced)
            obj_dists, obj_preds = permute(dists, inv_perm), preds.gather(1, inv_perm)
        if forced_preds is not None:
            obj_preds = forced_preds
        obj_ctx = permute(enc, inv_perm)

        inp = torch.cat([self.obj_embed2[obj_preds], obj_ctx], -1)
        perm, inv_perm, lengths = sort_by_order(self.order, boxes, valid)
        out = self.edge_ctx_rnn(permute(inp, perm), lengths)
        return ContextOutput(obj_dists, obj_preds, permute(out, inv_perm))
