"""The benchmark's scene generator: a pool of Visual-Genome-like images
with their ground truth, rendered once on the host from a traffic file's
parameters and the run's seed.

The sizes (objects and relations of each pool image) are drawn from the
traffic file's own `sizes_seed`, so every run seed gives the same multiset
of sizes; the run's seed orders them and draws the boxes, classes,
predicates and pixels. Images are uint8 592x592 RGB: a blocky background
with each object's box painted in its class's colour.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BOX_SCALE = 1024   # GT boxes are stored at this scale, as Visual Genome's


class Pool(NamedTuple):
    images: np.ndarray          # [N, S, S, 3] uint8
    gt_boxes: list              # N x [n, 4] float32 at BOX_SCALE
    gt_classes: list            # N x [n] int32, 1..num_classes-1
    relationships: list         # N x [r, 3] int32 (sub, obj, predicate)
    num_classes: int
    num_predicates: int


def zipf_probs(n: int, exponent: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
    return p / p.sum()


def draw_sizes(params: dict) -> tuple[np.ndarray, np.ndarray]:
    """(objects, relations) per pool image, from `sizes_seed` alone."""
    rng = np.random.default_rng(params["sizes_seed"])
    n_img = params["pool_images"]
    o, r = params["objects"], params["relations"]
    p = o["negbin_r"] / (o["negbin_r"] + o["negbin_mean"])
    objs = np.minimum(o["shift"] + rng.negative_binomial(o["negbin_r"], p, n_img), o["max"])
    rels = r["shift"] + rng.poisson(r["poisson_mean"], n_img)
    rels = np.minimum(np.minimum(rels, r["max"]), objs * (objs - 1))
    return objs.astype(np.int64), rels.astype(np.int64)


def make_pool(params: dict, seed: int, num_classes: int, num_predicates: int) -> Pool:
    """The pool of `params["pool_images"]` scenes for `seed`."""
    rng = np.random.default_rng(seed % (1 << 63))
    objs, rels = draw_sizes(params)
    order = rng.permutation(len(objs))
    objs, rels = objs[order], rels[order]
    size = params["image_size"]
    lo, hi = params["box_side"]
    cls_p = zipf_probs(num_classes - 1, params["class_zipf"])
    pred_p = zipf_probs(num_predicates - 1, params["predicate_zipf"])
    palette = rng.integers(0, 256, (num_classes, 3), dtype=np.uint8)

    cells = size // 16
    images = np.repeat(np.repeat(
        rng.integers(0, 256, (len(objs), cells, cells, 3), dtype=np.uint8), 16, 1), 16, 2)
    gt_boxes, gt_classes, relationships = [], [], []
    for i, (n, n_r) in enumerate(zip(objs, rels)):
        side = np.exp(rng.uniform(np.log(lo), np.log(hi), (n, 2))) * BOX_SCALE
        xy = rng.uniform(0.0, 1.0, (n, 2)) * (BOX_SCALE - side)
        boxes = np.concatenate([xy, np.minimum(xy + side, BOX_SCALE - 1)], 1)
        classes = 1 + rng.choice(num_classes - 1, n, p=cls_p)
        pairs = rng.choice(n * (n - 1), n_r, replace=False)
        sub = pairs // (n - 1)
        obj = pairs % (n - 1)
        obj = obj + (obj >= sub)
        pred = 1 + rng.choice(num_predicates - 1, n_r, p=pred_p)
        px = np.round(boxes * size / BOX_SCALE).astype(np.int64)
        shade = rng.uniform(0.6, 1.0, n)
        for (x1, y1, x2, y2), c, s in zip(px, classes, shade):
            images[i, y1:y2 + 1, x1:x2 + 1] = (palette[c] * s).astype(np.uint8)
        gt_boxes.append(boxes.astype(np.float32))
        gt_classes.append(classes.astype(np.int32))
        relationships.append(np.stack([sub, obj, pred], 1).astype(np.int32))
    return Pool(images=images, gt_boxes=gt_boxes, gt_classes=gt_classes,
                relationships=relationships, num_classes=num_classes,
                num_predicates=num_predicates)


class PoolStream:
    """A dataset of `length` images, image i being pool image i mod N under
    the fresh id i, in the port's dataset schema (`__getitem__` entries,
    the GT lists, the taxonomy); `stop()` makes every further read raise
    `Stopped`, which ends the port Loader's prefetch thread."""

    def __init__(self, pool: Pool, length: int):
        self.pool = pool
        self.length = length
        self.n = len(pool.gt_boxes)
        self.ind_to_classes = ["__background__"] + [f"class_{i}" for i in
                                                    range(1, pool.num_classes)]
        self.ind_to_predicates = ["__background__"] + [f"pred_{i}" for i in
                                                       range(1, pool.num_predicates)]
        self.gt_boxes = _Cycle(pool.gt_boxes, length)
        self.gt_classes = _Cycle(pool.gt_classes, length)
        self.relationships = _Cycle(pool.relationships, length)
        self._stopped = False

    @property
    def num_classes(self) -> int:
        return self.pool.num_classes

    @property
    def num_predicates(self) -> int:
        return self.pool.num_predicates

    def __len__(self) -> int:
        return self.length

    def stop(self) -> None:
        self._stopped = True

    def gt_entry(self, idx: int) -> dict:
        """The evaluator's GT of image `idx`."""
        j = idx % self.n
        return {"gt_classes": self.pool.gt_classes[j].copy(),
                "gt_relations": self.pool.relationships[j].copy(),
                "gt_boxes": self.pool.gt_boxes[j].copy()}

    def __getitem__(self, index: int) -> dict:
        if self._stopped:
            raise Stopped()
        j = index % self.n
        size = self.pool.images.shape[1]
        return {"img": self.pool.images[j], "img_size": (size, size, size / BOX_SCALE),
                "gt_boxes": self.pool.gt_boxes[j].copy(),
                "gt_classes": self.pool.gt_classes[j].copy(),
                "gt_relations": self.pool.relationships[j].copy(),
                "scale": size / BOX_SCALE, "index": index, "flipped": False}


class _Cycle:
    def __init__(self, items: list, length: int):
        self.items, self.length = items, length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int):
        return self.items[i % len(self.items)]

    def __iter__(self):
        return (self.items[i % len(self.items)] for i in range(self.length))


class PoolSplit:
    """The pool's GT as a plain split (the frequency counts the port's
    model builder reads)."""

    def __init__(self, stream: PoolStream):
        self.ind_to_classes = stream.ind_to_classes
        self.ind_to_predicates = stream.ind_to_predicates
        self.gt_boxes = stream.pool.gt_boxes
        self.gt_classes = stream.pool.gt_classes
        self.relationships = stream.pool.relationships
        self.num_classes = stream.num_classes
        self.num_predicates = stream.num_predicates

    def __len__(self) -> int:
        return len(self.gt_boxes)


class Stopped(Exception):
    """A read after `PoolStream.stop()`."""


def collate(pool: Pool, first: int, batch: int, max_gt_boxes: int, im_scale: int) -> dict:
    """Pool images first .. first + batch - 1 (mod the pool) as the model's
    inputs, numpy: images [B, S, S, 3] uint8, im_hw [B, 2], GT boxes at the
    network's scale [B, G, 4], classes [B, G], mask [B, G]."""
    n = len(pool.gt_boxes)
    idx = [(first + i) % n for i in range(batch)]
    size = pool.images.shape[1]
    gt_boxes = np.zeros((batch, max_gt_boxes, 4), np.float32)
    gt_classes = np.zeros((batch, max_gt_boxes), np.int64)
    gt_mask = np.zeros((batch, max_gt_boxes), bool)
    for i, j in enumerate(idx):
        g = min(len(pool.gt_boxes[j]), max_gt_boxes)
        gt_boxes[i, :g] = pool.gt_boxes[j][:g] * (im_scale / BOX_SCALE)
        gt_classes[i, :g] = pool.gt_classes[j][:g]
        gt_mask[i, :g] = True
    return {"images": pool.images[idx], "im_hw": np.full((batch, 2), size, np.float32),
            "gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_mask": gt_mask}


def position_stats(pool: Pool, im_scale: int) -> tuple[np.ndarray, np.ndarray]:
    """Mean and variance of the pool's GT boxes' (cx, cy, w, h) at the
    network's scale: the statistics a trained position BatchNorm holds."""
    b = np.concatenate(pool.gt_boxes).astype(np.float64) * im_scale / BOX_SCALE
    wh = b[:, 2:] - b[:, :2] + 1.0
    cs = np.concatenate([b[:, :2] + 0.5 * wh, wh], 1)
    return cs.mean(0), cs.var(0)
