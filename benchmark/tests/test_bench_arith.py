"""The benchmark's yardstick: the bounds copied from chip_smoke.py give
chip_smoke's numbers at phase 3's shapes, the FLOP counts match a hand
count and PyTorch's own count at small widths, and padded slots add no
operations."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.arith import flops as F
from benchmark.arith import roofline as R

chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("args", [(4, 37, 37, 512, 1000, 7, 2), (4, 37, 37, 512, 512, 7, 2),
                                  (4, 37, 37, 256, 1000, 7, 2), (4, 37, 37, 1024, 64, 7, 2),
                                  (4, 28, 37, 512, 1000, 7, 2), (4, 37, 37, 512, 1000, 7, 4)])
def test_roi_align_bound_is_chip_smokes(args):
    assert R.roi_align_bound(*args) == chip_smoke.roi_align_bound(*args)


@pytest.mark.parametrize("args", [(6, 37, 37, 512, 256, 7, 2), (6, 37, 37, 256, 256, 7, 2),
                                  (1, 128, 128, 64, 64, 7, 4)])
def test_roi_align_bwd_bound_is_chip_smokes(args):
    assert R.roi_align_bwd_bound(*args) == chip_smoke.roi_align_bwd_bound(*args)


@pytest.mark.parametrize("lanes,n", [(4, 6000), (6, 12000), (604, 64), (4, 2000)])
def test_nms_bounds_are_chip_smokes(lanes, n):
    g = torch.Generator().manual_seed(lanes + n)
    keep = torch.rand(lanes, n, generator=g) < 0.3
    valid = torch.rand(lanes, n, generator=g) < 0.95
    pairs = R.greedy_pairs(keep, valid)
    assert pairs == chip_smoke.greedy_pairs(keep, valid)
    for per_box in (16 + 4 + 1 + 1, 16 + 1 + 1):
        assert R.nms_bound(lanes * n, per_box, pairs) == chip_smoke.nms_bound(lanes * n, per_box,
                                                                              pairs)


def test_peaks():
    assert R.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    assert R.PEAK_F32_OPS_PER_S == chip_smoke.PEAK_F32_OPS_PER_S
    assert R.PEAK_BF16_FLOPS == 989e12


def test_kernel_share():
    assert R.kernel_share(0.5, {"void roi_align_smem_kernel<bf16>": 1e-3, "other": 5.0}) == 50.0
    assert R.kernel_share(0.5, {"other": 1.0}) is None


def test_trunk_by_hand_and_by_torch():
    """VGG16 at 32 x 32: by hand, and PyTorch's flop counter over the
    reference's trunk, forward and forward + backward (the image needs no
    gradient, so conv1_1's input gradient is not computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.backbone import VGG16Features
    hand, h, c_in = [], 32, 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512):
        if v == "M":
            h //= 2
        else:
            hand.append(2 * h * h * c_in * v * 9)
            c_in = v
    assert F.vgg_trunk(32, 32) == hand
    model = VGG16Features(dtype=torch.float32)
    x = torch.randn(1, 32, 32, 3)
    with FlopCounterMode(display=False) as fc:
        model(x)
    assert fc.get_total_flops() == sum(hand)
    with FlopCounterMode(display=False) as fc:
        model(x).sum().backward()
    assert fc.get_total_flops() == 3 * sum(hand) - hand[0]


SMALL = {"num_classes": 5, "num_predicates": 3, "obj_dim": 8, "pooling_dim": 8,
         "hidden_dim": 4, "embed_dim": 2, "nl_obj": 2, "nl_edge": 4}


def _hand_eval(mode, im, objs, pairs, props):
    trunk = sum(F.vgg_trunk(im, im))
    fc0, fc1 = 2 * 7 * 7 * 512 * 8, 2 * 8 * 8
    head = fc0 + fc1
    if mode == "sgdet":
        det = 2 * (im // 16) ** 2 * 512 * (512 * 9 + 120) + props * (head + 2 * 8 * 5
                                                                     + 2 * 8 * 20)
    else:
        det = objs * (head + 2 * 8 * 5)
    lstm = lambda d: 2 * d * 24 + 2 * 4 * 20   # noqa: E731  (6H = 24, 5H = 20)
    per_obj = (head + 2 * 5 * 2 + 2 * 4 * 128 + lstm(8 + 2 + 128) + lstm(4)
               + (lstm(4 + 100) + 2 * 4 * 5 if mode != "predcls" else 0)
               + lstm(2 + 4) + 3 * lstm(4) + 2 * 4 * 16)
    masks = 2 * 14 * 14 * 2 * 256 * 49 + 2 * 7 * 7 * 256 * 512 * 9
    per_pair = masks + head + 2 * 8 * 3
    return trunk + det + objs * per_obj + pairs * per_pair


@pytest.mark.parametrize("mode", ["sgdet", "predcls"])
def test_motifnet_by_hand(mode):
    for objs, pairs, props in ((3, 6, 10), (7, 20, 31)):
        assert F.motifnet_eval(SMALL, mode, 64, objs, pairs, props) == \
            _hand_eval(mode, 64, objs, pairs, props)


def test_detector_training_by_hand():
    conf = {"num_classes": 5, "obj_dim": 8}
    fwd = sum(F.vgg_trunk(64, 64)) + 2 * 4 * 4 * 512 * (512 * 9 + 120)
    bwd = 2 * fwd - F.vgg_trunk(64, 64)[0]
    head = 2 * 7 * 7 * 512 * 8 + 2 * 8 * 8 + 2 * 8 * 5 + 2 * 8 * 20
    assert F.detector_train(conf, 64, 17) == fwd + bwd + 3 * 17 * head


def test_padded_slots_add_nothing():
    """The eval loop's count reads the valid objects and pairs only: the
    same batch padded wider counts the same."""
    from benchmark.drivers.eval_loop import batch_flops

    def pred(o, p):
        obj_valid = np.zeros((2, o), bool)
        obj_valid[0, :5], obj_valid[1, :3] = True, True
        rel_valid = np.zeros((2, p), bool)
        rel_valid[0, :20], rel_valid[1, :6] = True, True
        return {"obj_valid": obj_valid, "rel_valid": rel_valid,
                "num_valid_pairs": np.array([20, 6])}
    for mode in ("predcls", "sgdet"):
        a = batch_flops(SMALL, mode, pred(8, 56), np.array([10, 12]), 1024, 64)
        b = batch_flops(SMALL, mode, pred(64, 4032), np.array([10, 12]), 1024, 64)
        assert a == b > 0


def test_observer_bounds():
    """The kernel observer's sums: each launch's bound from what it kept."""
    from benchmark.lib.kernels import _launch, Observer
    obs = Observer()
    fmap, rois = torch.zeros(4, 37, 37, 512, dtype=torch.bfloat16), torch.zeros(4, 1000, 4)
    obs.launches.append(_launch("roi_align_cuda", (fmap, rois, None, 7, 1 / 16), None))
    g = torch.zeros(6, 256, 7, 7, 512, dtype=torch.bfloat16)
    obs.launches.append(_launch("roi_align_bwd_cuda",
                                (g, torch.zeros(6, 256, 4), None, (6, 37, 37, 512),
                                 torch.bfloat16, 1 / 16), None))
    gen = torch.Generator().manual_seed(0)
    scores, valid = torch.rand(4, 600, generator=gen), torch.rand(4, 600, generator=gen) < 0.9
    keep = torch.rand(4, 600, generator=gen) < 0.3
    obs.launches.append(_launch("greedy_nms_cuda", (None, scores, valid, 0.7), keep))
    kb, vb = torch.rand(2, 5, 64, generator=gen) < 0.3, torch.rand(2, 5, 64, generator=gen) < 0.9
    obs.launches.append(_launch("perclass_nms_cuda", (None, vb, 0.3), kb))
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -1.0)), dim=1,
                       descending=True, stable=True).indices
    want = (chip_smoke.roi_align_bound(4, 37, 37, 512, 1000, 7, 2)[0]
            + chip_smoke.roi_align_bwd_bound(6, 37, 37, 512, 256, 7, 2)[0]
            + chip_smoke.nms_bound(2400, 22, chip_smoke.greedy_pairs(keep.gather(1, order),
                                                                    valid.gather(1, order)))[0]
            + chip_smoke.nms_bound(640, 18, chip_smoke.greedy_pairs(kb, vb))[0])
    assert obs.bound_ms() == pytest.approx(want, rel=1e-12)


def test_profiled_slice_moves_on_without_device_time(monkeypatch):
    """A slice whose trace holds no device time arms the next start; the
    first one that holds some is kept, and the reading's time is counted."""
    from benchmark.lib import profile

    reads = iter([None, {"busy_s": 0.0}, {"busy_s": 0.5}])

    class FakeSlice:
        def start(self):
            pass

        def stop(self):
            pass

        def read(self):
            return next(reads)

    class FakeObserver:
        def install(self):
            pass

        def uninstall(self):
            pass

        def bound_ms(self):
            return 1.5

    monkeypatch.setattr(profile, "Slice", FakeSlice)
    sl = profile.Slices((10, 20, 30, 40), 3, FakeObserver)
    for k in range(60):
        sl.before(k)
        sl.after(k)
    sl.close()
    assert sl.read() == ({"busy_s": 0.5}, 1.5) and sl.read_s >= 0.0
    assert sl.firsts == [40]
