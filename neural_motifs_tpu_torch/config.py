"""Dataset constants, static padding budgets and the typed run config
with its argparse surface.

Copied from neural_motifs_tpu/config.py (the JAX package's config imports
jax through its package __init__, so it cannot be imported here). The flag
names and defaults are the JAX package's, less its parameter dtype (the
port's parameters are always f32). `-remat` recomputes the detector's trunk
in the backward pass (torch.utils.checkpoint), as the JAX flag does.
`-resnet` builds the ResNet-101 C4 detector and MotifNet's ResNet towers,
as the JAX flag does (`-model stanford` and the frequency baseline build
the VGG model whatever it says, as in JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

MODES = ("sgdet", "sgcls", "predcls")

BOX_SCALE = 1024  # scale at which GT boxes are stored
# network input resolution (long side, square-padded). NM_TPU_IM_SCALE
# overrides it for dry runs and tests only: the reference trains and
# evaluates at 592 and every released checkpoint assumes it.
IM_SCALE = int(os.environ.get("NM_TPU_IM_SCALE", 592))
if IM_SCALE != 592:
    print(f"[config] WARNING: NM_TPU_IM_SCALE={IM_SCALE} != 592 — NOT "
          f"reference-comparable; use only for dry runs/tests.", flush=True)

# Proposal assignment thresholds (detector training)
BG_THRESH_HI = 0.5
BG_THRESH_LO = 0.0
RPN_POSITIVE_OVERLAP = 0.7
RPN_NEGATIVE_OVERLAP = 0.3
RPN_FG_FRACTION = 0.5    # fg share of the sampled anchors
FG_FRACTION = 0.25       # fg share of the sampled RoIs

ROIS_PER_IMG = 256
RELS_PER_IMG = 256
RELS_PER_IMG_REFINE = 64
RPN_BATCHSIZE = 256
REL_FG_FRACTION = 0.25   # fg share of the sampled relation pairs

BATCHNORM_MOMENTUM = 0.01
ANCHOR_SIZE = 16

# Learned anchor shapes (4 ratios x 5 scales = 20 anchors per cell)
ANCHOR_RATIOS = (0.23232838, 0.63365731, 1.28478321, 3.15089189)
ANCHOR_SCALES = (2.22152954, 4.12315647, 7.21692515, 12.60263013, 22.7102731)

# aspect buckets for -im_budget auto (landscape / portrait / square),
# 16-aligned so the stride-16 anchor grid tiles exactly
DEFAULT_IM_BUCKETS = (((IM_SCALE * 3 // 4 + 15) // 16 * 16, IM_SCALE),
                      (IM_SCALE, (IM_SCALE * 3 // 4 + 15) // 16 * 16),
                      (IM_SCALE, IM_SCALE))

FEAT_STRIDE = 16
FMAP_SIZE = IM_SCALE // FEAT_STRIDE  # 37
NUM_ANCHORS = len(ANCHOR_RATIOS) * len(ANCHOR_SCALES)  # 20

# Visual Genome "stanford filtered" taxonomy sizes (incl. background)
VG_NUM_CLASSES = 151
VG_NUM_PREDICATES = 51

DATA_PATH = os.environ.get("NM_TPU_DATA",
                           os.path.join(os.path.dirname(__file__), "..", "data"))


def stanford_path(fn: str) -> str:
    return os.path.join(DATA_PATH, "stanford_filtered", fn)


VG_IMAGES = os.environ.get("NM_TPU_VG_IMAGES", os.path.join(DATA_PATH, "vg_images"))
IM_DATA_FN = stanford_path("image_data.json")
VG_SGG_FN = stanford_path("VG-SGG.h5")
VG_SGG_DICT_FN = stanford_path("VG-SGG-dicts.json")
PROPOSAL_FN = stanford_path("proposals.h5")
GLOVE_PATH = os.environ.get("NM_TPU_GLOVE", os.path.join(DATA_PATH, "glove"))
COCO_PATH = os.environ.get("NM_TPU_COCO", os.path.join(DATA_PATH, "mscoco"))


@dataclass(frozen=True)
class PadBudgets:
    """Fixed per-image shape budgets; everything downstream of the input is
    padded to these sizes and masked."""

    max_gt_boxes: int = 64
    max_gt_rels: int = 128
    rois_per_img: int = ROIS_PER_IMG
    objs_per_img: int = 64          # post-NMS objects per image
    rels_per_img: int = RELS_PER_IMG
    rels_per_img_refine: int = RELS_PER_IMG_REFINE
    max_pairs_eval: int = 1024      # eval pair-compaction budget: exact while
                                    # the valid pairs of an image are <= it
    rpn_pre_nms_topn_train: int = 12000
    rpn_post_nms_topn_train: int = 2000
    rpn_pre_nms_topn_test: int = 6000
    rpn_post_nms_topn_test: int = 1000
    rpn_train_anchors: int = RPN_BATCHSIZE
    per_class_nms_topk: int = 256   # per-class NMS candidate budget (None = exact)


# Flags that the JAX package parses and never reads: a run that sets one
# is refused, since there is nothing for it to do. The training flags
# (-lr, -l2, -clip, -adam, -nepoch, -p, -save_dir) are read by
# training/train_rels.py and training/train_detector.py (which also reads
# -remat); the evaluation entry points parse them and leave them unread,
# as the JAX ones do.
_NEVER_READ = {
    "det_ckpt": ("-det_ckpt", "give a detector checkpoint to -ckpt"),
    "coco": ("-coco", "detector training reads Visual Genome; data/mscoco.py's "
                      "CocoDetection is the COCO dataset"),
}

# the width of a ResNet RoI head's features (models/resnet.py)
RESNET_FEAT_DIM = 2048


def resnet_widths_error(pooling_dim: int, limit_vision: bool) -> Optional[str]:
    """Why a ResNet MotifNet with a union tower cannot run at these widths,
    or None where it can. The union tower gives 2048 features, which gate
    the -pooling_dim wide edge features: all of them (the widths must be
    equal; the JAX model fails to broadcast otherwise) or with
    -limit_vision the first 2048 (there must be 2048)."""
    if limit_vision and pooling_dim < RESNET_FEAT_DIM:
        return (f"-resnet -limit_vision needs -pooling_dim >= {RESNET_FEAT_DIM} (the "
                f"ResNet union tower's width), not {pooling_dim}")
    if not limit_vision and pooling_dim != RESNET_FEAT_DIM:
        return (f"-resnet needs -pooling_dim {RESNET_FEAT_DIM} (the ResNet union "
                f"tower's width, which gates every pooling dim), not {pooling_dim}; "
                f"or -limit_vision to gate only the first {RESNET_FEAT_DIM}")
    return None


@dataclass(frozen=True)
class ModelConfig:
    """Typed run config; field names and defaults match the JAX package's
    ModelConfig (and so the reference's flags)."""

    # run control
    mode: str = "sgdet"                 # sgdet | sgcls | predcls
    model: str = "motifnet"             # motifnet | stanford
    ckpt: Optional[str] = None
    det_ckpt: Optional[str] = None
    save_dir: Optional[str] = None
    cache: Optional[str] = None
    coco: bool = False
    test: bool = False
    num_epochs: int = 25
    print_interval: int = 100
    val_size: int = 5000

    # optimization
    lr: float = 1e-3
    batch_size: int = 2                 # per device
    l2: float = 1e-4
    clip: float = 5.0
    adam: bool = False

    # parallelism: -ngpu ranks, each a process under torchrun (WORLD_SIZE)
    num_devices: int = 1
    num_workers: int = 1

    # model topology
    use_resnet: bool = False
    use_proposals: bool = False
    gt_box: bool = False    # parsed but dead, as in the reference
    order: str = "confidence"           # confidence | size | random | leftright
    nl_obj: int = 1
    nl_edge: int = 2
    hidden_dim: int = 256
    pooling_dim: int = 4096
    obj_dim: int = 4096
    embed_dim: int = 200
    pass_in_obj_feats_to_decoder: bool = False
    pass_in_obj_feats_to_edge: bool = False
    rec_dropout: float = 0.1
    use_bias: bool = False
    use_tanh: bool = False
    limit_vision: bool = False
    multi_pred: bool = False
    old_feats: bool = False  # parsed but dead, as in the reference

    compute_dtype: str = "bfloat16"     # dtype of the convs and fc towers
    remat: bool = False     # recompute the detector's trunk in the backward
                            # pass instead of storing its activations
    budgets: PadBudgets = dataclasses.field(default_factory=PadBudgets)
    # image pad budget: None = square IM_SCALE, (pad_h, pad_w), or "auto"
    # (each image in the smallest of DEFAULT_IM_BUCKETS that covers it)
    im_budget: Optional[object] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"Invalid mode {self.mode}; must be in {MODES}")
        if self.model not in ("motifnet", "stanford"):
            raise ValueError(f"Invalid model {self.model}")
        if self.order not in ("size", "confidence", "random", "leftright"):
            raise ValueError(f"Invalid order {self.order}")
        for field, (flag, instead) in _NEVER_READ.items():
            if getattr(self, field):
                raise NotImplementedError(
                    f"{flag}: the JAX package parses this flag and never reads it, so "
                    f"there is nothing to port; {instead}")
        world = int(os.environ.get("WORLD_SIZE", 1))
        if self.num_devices != world:
            raise ValueError(
                f"-ngpu {self.num_devices} needs {self.num_devices} processes, one a "
                f"device, and this run has {world}: launch it as torchrun "
                f"--standalone --nproc_per_node {self.num_devices} -m "
                f"neural_motifs_tpu_torch.training.<entry point> -ngpu "
                f"{self.num_devices} ...")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def setup_parser() -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(description="neural_motifs_tpu_torch")
        p.add_argument("-coco", dest="coco", action="store_true")
        p.add_argument("-ckpt", dest="ckpt", type=str, default="")
        p.add_argument("-det_ckpt", dest="det_ckpt", type=str, default="")
        p.add_argument("-save_dir", dest="save_dir", type=str, default="")
        p.add_argument("-ngpu", "-ndev", dest="num_devices", type=int, default=1)
        p.add_argument("-nwork", dest="num_workers", type=int, default=1)
        p.add_argument("-lr", dest="lr", type=float, default=1e-3)
        p.add_argument("-b", dest="batch_size", type=int, default=2)
        p.add_argument("-val_size", dest="val_size", type=int, default=5000)
        p.add_argument("-l2", dest="l2", type=float, default=1e-4)
        p.add_argument("-clip", dest="clip", type=float, default=5.0)
        p.add_argument("-p", dest="print_interval", type=int, default=100)
        p.add_argument("-m", dest="mode", type=str, default="sgdet")
        p.add_argument("-model", dest="model", type=str, default="motifnet")
        p.add_argument("-old_feats", dest="old_feats", action="store_true")
        p.add_argument("-order", dest="order", type=str, default="confidence")
        p.add_argument("-cache", dest="cache", type=str, default="")
        p.add_argument("-gt_box", dest="gt_box", action="store_true")
        p.add_argument("-adam", dest="adam", action="store_true")
        p.add_argument("-test", dest="test", action="store_true")
        p.add_argument("-multipred", dest="multi_pred", action="store_true")
        p.add_argument("-nepoch", dest="num_epochs", type=int, default=25)
        p.add_argument("-resnet", dest="use_resnet", action="store_true")
        p.add_argument("-proposals", dest="use_proposals", action="store_true")
        p.add_argument("-nl_obj", dest="nl_obj", type=int, default=1)
        p.add_argument("-nl_edge", dest="nl_edge", type=int, default=2)
        p.add_argument("-hidden_dim", dest="hidden_dim", type=int, default=256,
                       help="the context LSTMs' width; on a CUDA device their eval "
                            "kernel takes at most 4 units a SM (528 on an H100 SXM) "
                            "and raises above that")
        p.add_argument("-pooling_dim", dest="pooling_dim", type=int, default=4096)
        p.add_argument("-obj_dim", dest="obj_dim", type=int, default=4096)
        p.add_argument("-embed_dim", dest="embed_dim", type=int, default=200)
        p.add_argument("-max_gt_boxes", dest="max_gt_boxes", type=int,
                       default=PadBudgets.max_gt_boxes)
        p.add_argument("-max_gt_rels", dest="max_gt_rels", type=int,
                       default=PadBudgets.max_gt_rels)
        p.add_argument("-objs_per_img", dest="objs_per_img", type=int,
                       default=PadBudgets.objs_per_img)
        p.add_argument("-max_pairs_eval", dest="max_pairs_eval", type=int,
                       default=None)  # resolved mode-aware in from_args
        p.add_argument("-im_budget", dest="im_budget", type=str, default="",
                       help="HxW rectangular image pad budget, e.g. 448x592, "
                            "or 'auto' for aspect buckets")
        p.add_argument("-pass_in_obj_feats_to_decoder",
                       dest="pass_in_obj_feats_to_decoder", action="store_true")
        p.add_argument("-pass_in_obj_feats_to_edge",
                       dest="pass_in_obj_feats_to_edge", action="store_true")
        p.add_argument("-rec_dropout", dest="rec_dropout", type=float, default=0.1)
        p.add_argument("-use_bias", dest="use_bias", action="store_true")
        p.add_argument("-use_tanh", dest="use_tanh", action="store_true")
        p.add_argument("-limit_vision", dest="limit_vision", action="store_true")
        p.add_argument("-dtype", dest="compute_dtype", type=str, default="bfloat16")
        p.add_argument("-remat", dest="remat", action="store_true")
        return p

    @classmethod
    def from_args(cls, argv=None) -> "ModelConfig":
        args = vars(cls.setup_parser().parse_args(argv))
        for k in ("ckpt", "det_ckpt", "save_dir", "cache"):
            if not args.get(k):
                args[k] = None
        budget_kw = {k: args.pop(k) for k in
                     ("max_gt_boxes", "max_gt_rels", "objs_per_img",
                      "max_pairs_eval")}
        if budget_kw["max_pairs_eval"] is None:
            # sgdet's overlap gate keeps valid pairs well under 1024; the
            # gtbox modes score all ordered GT pairs (~1260 on a VG p99
            # image), so they default to exact
            budget_kw["max_pairs_eval"] = (
                PadBudgets.max_pairs_eval if args.get("mode") == "sgdet"
                else 4096)
        args["budgets"] = PadBudgets(**budget_kw)
        if args.get("im_budget") == "auto":
            args["im_budget"] = "auto"
        elif args.get("im_budget"):
            h, w = args["im_budget"].lower().split("x")
            args["im_budget"] = (int(h), int(w))
        else:
            args["im_budget"] = None
        cfg = cls(**args)
        print("~~~~~~~~ Hyperparameters used: ~~~~~~~")
        for k, v in sorted(dataclasses.asdict(cfg).items()):
            print(f"{k} : {v}")
        return cfg
