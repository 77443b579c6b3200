"""The benchmark's weights: every tensor of a model's state dict drawn on
the device from the run's seed, in one normal draw sliced and scaled a
tensor at a time. The same dict goes to the program (`load_state_dict`)
and to the reference.

The rules are the benchmark's own, by parameter name:
  * conv and fc-tower weights: He normal (std sqrt(2 / fan_in)); the
    RPN's output conv and the box regressor at a tenth of that, so that
    the decoded boxes stay near their priors;
  * other linear maps (torch's [out, in], or the LSTMs' [in, out]):
    std 1 / sqrt(fan_in);
  * embeddings and the frequency bias: N(0, 1);
  * biases 0, the LSTM forget-gate slots 1, the detector's class biases
    N(0, `score_bias_std`^2) (spread priors let detections clear the
    0.01 threshold, as a trained detector's do);
  * BatchNorm scale 1, shift 0, running statistics (0, 1), the position
    BatchNorm's from the pool's GT boxes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SMALL_OUT = ("rpn_head.convs.1.weight", "bbox_fc.weight")
_LSTM_IN = ("_w_i", "input_w")          # [in, 6H]
_LSTM_STATE = ("_w_h", "state_w")       # [H, 5H]


def _rule(name: str, shape: tuple, score_bias_std: float) -> tuple[str, float]:
    """(kind, scale): 'normal' draws scaled by `scale`, 'const' the value
    `scale`, 'forget' zeros with ones in the forget-gate slots."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean",):
        return "const", 0.0
    if leaf in ("running_var",):
        return "const", 1.0
    if ".bns." in name or name.startswith("context.pos_bn."):
        return "const", 1.0 if leaf == "weight" else 0.0
    if name.endswith("score_fc.bias"):
        return "normal", score_bias_std
    if leaf.endswith("_bias") or leaf == "state_b":
        return "forget", 0.0
    if len(shape) == 1:
        return "const", 0.0
    if leaf in ("obj_embed", "obj_embed2", "freq_bias"):
        return "normal", 1.0
    if leaf.endswith(_LSTM_IN) or leaf.endswith(_LSTM_STATE) or leaf == "out_w":
        return "normal", 1.0 / math.sqrt(shape[0])
    fan_in = int(np.prod(shape[1:]))
    if len(shape) == 4 or leaf == "weight" and (".fc0." in name or ".fc1." in name
                                               or ".proj." in name):
        scale = math.sqrt(2.0 / fan_in)
        return "normal", scale * (0.1 if name.endswith(_SMALL_OUT) else 1.0)
    scale = 1.0 / math.sqrt(fan_in)
    return "normal", scale * (0.1 if name.endswith(_SMALL_OUT) else 1.0)


@torch.no_grad()
def make_weights(spec: dict, seed: int, device, score_bias_std: float = 0.0,
                 position_stats: tuple | None = None) -> dict:
    """spec: name -> shape (a state dict's). Returns name -> f32 tensor."""
    spec = {k: spec[k] for k in sorted(spec)}   # the draw does not follow a module's order
    rules = {k: _rule(k, tuple(s), score_bias_std) for k, s in spec.items()}
    total = sum(int(np.prod(s)) for k, s in spec.items() if rules[k][0] == "normal")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, shape in spec.items():
        kind, scale = rules[k]
        n = int(np.prod(shape))
        if kind == "normal":
            out[k] = flat[off:off + n].view(tuple(shape)).mul_(scale)
            off += n
        elif kind == "const":
            out[k] = torch.full(tuple(shape), scale, device=device)
        else:
            t = torch.zeros(tuple(shape), device=device)
            h = shape[0] // 5
            t[h:2 * h] = 1.0
            out[k] = t
    if position_stats is not None and "context.pos_bn.running_mean" in out:
        mean, var = position_stats
        out["context.pos_bn.running_mean"] = torch.as_tensor(mean, dtype=torch.float32,
                                                             device=device)
        out["context.pos_bn.running_var"] = torch.as_tensor(var, dtype=torch.float32,
                                                            device=device)
    return out


def spec_of(module: torch.nn.Module) -> dict:
    """name -> shape of a module's state dict."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
