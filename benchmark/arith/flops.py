"""The floating-point operations that a batch's inputs need, counted from
the configuration's widths and from what the batch holds: valid objects,
valid pairs within the budget, kept proposals, sampled RoIs. Padded slots
count nothing, so a change that stops computing padding raises the share
of the peak and never carries it past 100 %. A multiply-add is 2
operations; convolutions, fc layers and the LSTMs' products are counted,
element-wise work is not."""

from __future__ import annotations

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)


def vgg_trunk(h: int, w: int) -> list[float]:
    """Forward operations of each of VGG16's 13 convs on an h x w image."""
    out, c_in = [], 3
    for v in VGG16_CFG:
        if v == "M":
            h, w = h // 2, w // 2
        else:
            out.append(2.0 * h * w * c_in * v * 9)
            c_in = v
    return out


def fc(n_in: int, n_out: int) -> float:
    return 2.0 * n_in * n_out


def rpn_head(fh: int, fw: int, anchors: int = 20) -> float:
    return 2.0 * fh * fw * 512 * (512 * 9 + anchors * 6)


def roi_tower(obj_dim: int, in_dim: int = 7 * 7 * 512) -> float:
    """The VGG fc tower: fc0 and fc1, one RoI."""
    return fc(in_dim, obj_dim) + fc(obj_dim, obj_dim)


def mask_convs(dim: int = 512) -> float:
    """The union pair-mask convs, one pair: 7x7/2 over 27x27 -> 14x14, then
    a 3x3 conv at 7x7."""
    return 2.0 * 14 * 14 * 2 * (dim // 2) * 49 + 2.0 * 7 * 7 * (dim // 2) * dim * 9


def lstm_layer(d_in: int, hidden: int) -> float:
    """One highway-LSTM step: the input projection (6H) and the recurrent
    one (5H)."""
    return fc(d_in, 6 * hidden) + fc(hidden, 5 * hidden)


def motifnet_eval(conf: dict, mode: str, im: int, objects: int, pairs: int,
                  proposals: int) -> float:
    """One image of MotifNet's eval forward: `objects` valid objects,
    `pairs` valid pairs scored, `proposals` kept proposals (sgdet)."""
    nc, npred = conf["num_classes"], conf["num_predicates"]
    obj, pool, hid = conf["obj_dim"], conf["pooling_dim"], conf["hidden_dim"]
    emb = conf["embed_dim"]
    f = sum(vgg_trunk(im, im))
    if mode == "sgdet":
        f += rpn_head(im // 16, im // 16)
        f += proposals * (roi_tower(obj) + fc(obj, nc) + fc(obj, 4 * nc))
    else:
        f += objects * (roi_tower(obj) + fc(obj, nc))
    f += objects * roi_tower(obj)                               # the object tower
    f += objects * fc(nc, emb)                                  # soft class embedding
    pre = obj + emb + 128
    f += objects * (fc(4, 128) + lstm_layer(pre, hid)
                    + (conf["nl_obj"] - 1) * lstm_layer(hid, hid))
    if mode != "predcls":                                       # the decoder
        f += objects * (lstm_layer(hid + 100, hid) + fc(hid, nc))
    f += objects * (lstm_layer(emb + hid, hid) + (conf["nl_edge"] - 1) * lstm_layer(hid, hid))
    f += objects * fc(hid, 2 * pool)                            # post_lstm
    f += pairs * (mask_convs() + roi_tower(pool) + fc(pool, npred))
    return f


def detector_train(conf: dict, im: int, rois: int) -> float:
    """One image of a detector-training step: the forward, and the backward
    of every tensor that needs a gradient (both operands' gradients of each
    layer, but not the image's)."""
    nc, obj = conf["num_classes"], conf["obj_dim"]
    convs = vgg_trunk(im, im)
    fwd = sum(convs) + rpn_head(im // 16, im // 16)
    bwd = 2 * fwd - convs[0]               # conv1_1: the weights' gradient only
    head = rois * (roi_tower(obj) + fc(obj, nc) + fc(obj, 4 * nc))
    return fwd + bwd + 3 * head
