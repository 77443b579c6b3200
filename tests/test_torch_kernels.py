"""The port's CUDA kernels (K1 RoIAlign and its backward, K2 per-class NMS,
K3 greedy NMS, K4 the highway-LSTM layer) against their plain PyTorch versions, and the device dispatch of their
wrappers. Imports torch and numpy only, so the file runs on a GPU host
without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

The tests marked gpu skip where torch.cuda.is_available() is false.
"""

import shutil

import numpy as np
import pytest
import torch

from neural_motifs_tpu_torch.ops import _cuda
from neural_motifs_tpu_torch.ops import highway_lstm as hl
from neural_motifs_tpu_torch.ops import nms
from neural_motifs_tpu_torch.ops import roi_align as ra

T = torch.from_numpy


@pytest.fixture
def np_rng():
    return np.random.RandomState(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rand_boxes(rng, shape, scale):
    xy = rng.uniform(0, scale, shape + (2,))
    wh = rng.uniform(1, scale / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def roi_case(rng, b, r, h=37, w=37, c=512):
    fmap = rng.standard_normal((b, h, w, c)).astype(np.float32)
    rois = rand_boxes(rng, (b, r), 700) - 50.0       # some partly outside
    valid = rng.uniform(0, 1, (b, r)) < 0.9
    return fmap, rois, valid


def test_cpu_tensors_take_the_plain_versions(np_rng):
    """On CPU tensors the public functions run the plain versions and never
    count a launch; the kernel wrappers refuse CPU tensors."""
    counts = (ra.roi_align_cuda.launches, nms.perclass_nms_cuda.launches,
              nms.greedy_nms_cuda.launches)
    fmap, rois, valid = roi_case(np_rng, 1, 5, h=6, w=6, c=4)
    out = ra.roi_align(T(fmap), T(rois), T(valid), 7, 1 / 16)
    assert out.shape == (1, 5, 7, 7, 4)
    boxes = T(rand_boxes(np_rng, (1, 3, 8), 50))
    nms.perclass_nms(boxes, torch.ones(1, 3, 8, dtype=torch.bool), 0.3)
    nms.greedy_nms_mask(boxes[0], torch.rand(3, 8), torch.ones(3, 8, dtype=torch.bool), 0.5)
    assert counts == (ra.roi_align_cuda.launches, nms.perclass_nms_cuda.launches,
                      nms.greedy_nms_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ra.roi_align_cuda(T(fmap), T(rois), T(valid), 7, 1 / 16)
    with pytest.raises(ValueError, match="CUDA"):
        nms.perclass_nms_cuda(boxes, torch.ones(1, 3, 8, dtype=torch.bool), 0.3)


def test_cpu_backward_takes_the_plain_version(np_rng):
    """On the CPU the RoIAlign backward is autograd of the separable form
    (the boxes detached) and counts no launch; the backward kernel's
    wrapper refuses CPU tensors."""
    before = ra.roi_align_bwd_cuda.launches
    fmap, rois, valid = roi_case(np_rng, 2, 9, h=6, w=7, c=4)
    f, r = T(fmap).requires_grad_(True), T(rois).requires_grad_(True)
    g = torch.randn(2, 9, 7, 7, 4, generator=torch.Generator().manual_seed(0))
    ra.roi_align(f, r, T(valid), 7, 1 / 16).backward(g)
    assert r.grad is None and ra.roi_align_bwd_cuda.launches == before
    torch.testing.assert_close(f.grad, ra._roi_align_bwd_plain(g, T(fmap), T(rois),
                                                               T(valid), 1 / 16))
    with pytest.raises(ValueError, match="CUDA"):
        ra.roi_align_bwd_cuda(g, T(rois), T(valid), fmap.shape, torch.float32, 1 / 16)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A host without nvcc gets an error that says so, not a silent fallback."""
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present")
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1000, 64, 512])
def test_roi_align_kernel_matches_plain_f32(np_rng, cuda, r):
    """K1 in f32 at the main path's shapes: max abs error <= 1e-4 against
    the separable form (the same tent weights; the sums differ in order)."""
    fmap, rois, valid = roi_case(np_rng, 4, r)
    f, rr, vv = (T(x).to(cuda) for x in (fmap, rois, valid))
    before = ra.roi_align_cuda.launches
    got = ra.roi_align(f, rr, vv, 7, 1 / 16)
    torch.cuda.synchronize()
    assert ra.roi_align_cuda.launches == before + 1
    exp = ra._roi_align_matmul(f, rr, vv, 7, 1 / 16)
    assert (got - exp).abs().max().item() <= 1e-4
    assert not got[~vv].any(), "invalid RoIs must give zeros"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,r", [(256, 1000), (256, 256), (1024, 64), (1024, 512)])
def test_roi_align_kernel_resnet_shapes(np_rng, cuda, c, r, dtype):
    """K1 at the -resnet paths' shapes: the detector's 256-channel
    compressed map (1000 proposals at eval, 256 sampled RoIs in training)
    and the relation model's 1024-channel trunk map (64 objects, a 512-pair
    union chunk); f32 within 1e-4 of the plain version, bf16 within rtol
    2e-2, invalid RoIs zero."""
    fmap, rois, valid = roi_case(np_rng, 4, r, c=c)
    f, rr, vv = (T(x).to(cuda) for x in (fmap, rois, valid))
    got = ra.roi_align(f.to(dtype), rr, vv, 7, 1 / 16)
    exp = ra._roi_align_matmul(f, rr, vv, 7, 1 / 16)
    assert got.dtype == dtype and got.shape == (4, r, 7, 7, c)
    if dtype == torch.float32:
        assert (got - exp).abs().max().item() <= 1e-4
    else:
        torch.testing.assert_close(got.float(), exp, rtol=2e-2, atol=2e-2)
    assert not got[~vv].any(), "invalid RoIs must give zeros"


@pytest.mark.gpu
def test_roi_align_kernel_bf16(np_rng, cuda):
    """K1 on a bf16 map against the f32 plain form: within rtol 2e-2 (the
    map and the result are each rounded to bf16 once)."""
    fmap, rois, valid = roi_case(np_rng, 4, 512)
    f, rr, vv = (T(x).to(cuda) for x in (fmap, rois, valid))
    got = ra.roi_align(f.bfloat16(), rr, vv, 7, 1 / 16)
    assert got.dtype == torch.bfloat16
    exp = ra._roi_align_matmul(f, rr, vv, 7, 1 / 16)
    torch.testing.assert_close(got.float(), exp, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_perclass_nms_kernel_matches_plain(np_rng, cuda):
    """K2 at [4, 151, 256], threshold 0.3: identical keep masks."""
    boxes = T(rand_boxes(np_rng, (4, 151, 256), 592)).to(cuda)
    valid = T(np.cumsum(np.ones((4, 151, 256)), -1)
              <= np_rng.randint(3, 257, (4, 151, 1))).to(cuda)
    before = nms.perclass_nms_cuda.launches
    got = nms.perclass_nms(boxes, valid, 0.3)
    torch.cuda.synchronize()
    assert nms.perclass_nms_cuda.launches == before + 1
    assert torch.equal(got, nms._perclass_nms_plain(boxes, valid, 0.3))


@pytest.mark.gpu
def test_perclass_nms_kernel_division_band(np_rng, cuda):
    """K2 on pairs whose IoU the FMA signs cannot decide (its exact
    quotient within one f32 ulp above t = 0.3): the IEEE division decides,
    in the tile (inner box at rank 1) and in the later-chunk test (rank
    64), some rounding up (suppressed) and some down (kept)."""
    outer, inner, up = band_pairs(np_rng, 400_000)
    up = up[:48]
    m = len(up)
    assert m == 48 and up.any() and not up.all()
    # 63 far-apart 5x5 fillers, none meeting another box
    fill = np.stack([3000.0 + 20 * np.arange(63), np.zeros(63), 3004.0 + 20 * np.arange(63),
                     np.full(63, 4.0)], 1).astype(np.float32)
    tile = np.stack([np.concatenate([outer[i:i + 1], inner[i:i + 1], fill]) for i in range(m)])
    later = np.stack([np.concatenate([outer[i:i + 1], fill, inner[i:i + 1]]) for i in range(m)])
    boxes = T(np.stack([tile, later])).to(cuda)                  # [2, m, 65, 4]
    valid = torch.ones(2, m, 65, dtype=torch.bool, device=cuda)
    got = assert_perclass_kernel_matches(boxes, valid).cpu()
    assert torch.equal(got[0, :, 1], T(~up)) and torch.equal(got[1, :, 64], T(~up))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [6000, 100])
def test_greedy_nms_kernel_matches_plain(np_rng, cuda, n):
    """K3 at the RPN's [4, 6000] (and one partial 64-box word), threshold
    0.7: identical keep masks."""
    boxes = T(rand_boxes(np_rng, (4, n), 592)).to(cuda)
    scores = torch.rand(4, n, device=cuda)
    valid = torch.rand(4, n, device=cuda) < 0.9
    before = nms.greedy_nms_cuda.launches
    got = nms.greedy_nms_mask(boxes, scores, valid, 0.7)
    torch.cuda.synchronize()
    assert nms.greedy_nms_cuda.launches == before + 1
    assert torch.equal(got, nms._greedy_nms_plain(boxes, scores, valid, 0.7))


def anchor_like_boxes(rng, lanes, n, im=592):
    """Clustered RPN-like proposals: n anchors of an im^2 image per lane,
    decoded with seeded deltas and clipped to the image."""
    from neural_motifs_tpu_torch.ops.anchors import generate_anchors
    from neural_motifs_tpu_torch.ops.boxes import bbox_preds, clip_boxes
    anchors = generate_anchors(im_scale=im).reshape(-1, 4)
    pick = np.stack([rng.permutation(len(anchors))[:n] for _ in range(lanes)])
    deltas = (rng.standard_normal((lanes, n, 4)) * [0.1, 0.1, 0.2, 0.2]).astype(np.float32)
    boxes = bbox_preds(T(anchors[pick]), T(deltas))
    size = torch.full((lanes, 1), float(im))
    return clip_boxes(boxes, size, size)


def at_threshold_boxes(rng, n, sizes=((10, 7), (8, 9), (9, 7))):
    """n/2 nested pairs a 10x10 box holds, the inner box of one of `sizes`:
    by default 10x7 (IoU exactly 0.7 in f32), 8x9 (0.72) or 9x7 (0.63),
    spread so that pairs rarely meet."""
    xy = rng.uniform(0, 400, (n // 2, 2)).astype(np.float32).round()
    a = np.concatenate([xy, xy + 9], 1)
    wh = np.array(sizes, np.float32)[rng.randint(0, len(sizes), n // 2)]
    b = np.concatenate([xy, xy + wh - 1], 1)
    return np.concatenate([a, b], 0)


def assert_perclass_kernel_matches(boxes, valid, thresh=0.3):
    """K2 on the card == the plain rank-sequential pass on the CPU, in one
    launch."""
    before = nms.perclass_nms_cuda.launches
    got = nms.perclass_nms(boxes, valid, thresh)
    torch.cuda.synchronize()
    assert nms.perclass_nms_cuda.launches == before + 1
    assert torch.equal(got.cpu(), nms._perclass_nms_plain(boxes.cpu(), valid.cpu(), thresh))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 256, 2048])
def test_perclass_nms_kernel_chunk_edges(np_rng, cuda, k):
    """K2 at every edge of its 64-rank chunks, up to _MAX_PERCLASS_K, with
    valid flags with holes and one all-invalid lane (which keeps nothing)."""
    boxes = T(rand_boxes(np_rng, (2, 3, k), 592)).to(cuda)
    valid = T(np_rng.uniform(0, 1, (2, 3, k)) < 0.8).to(cuda)
    valid[1, 2] = False
    got = assert_perclass_kernel_matches(boxes, valid)
    assert not got[1, 2].any()


@pytest.mark.gpu
def test_perclass_nms_kernel_full_clustered_lanes(np_rng, cuda):
    """K2 on the request's lane shape [4, 151, 256], every candidate valid,
    RPN-like clustered boxes: identical keep masks, some boxes suppressed."""
    boxes = anchor_like_boxes(np_rng, 4 * 151, 256).reshape(4, 151, 256, 4).to(cuda)
    valid = torch.ones(4, 151, 256, dtype=torch.bool, device=cuda)
    got = assert_perclass_kernel_matches(boxes, valid)
    assert 0 < int(got.sum()) < int(valid.sum()), "clustered boxes must suppress"


@pytest.mark.gpu
def test_perclass_nms_kernel_at_threshold(np_rng, cuda):
    """K2 on nested pairs whose f32 IoU is exactly 0.3 (10x3 in 10x10: kept,
    the test is strictly greater), beside 0.4 (10x4) and 0.2 (10x2) pairs."""
    xy = np.stack(np.meshgrid(np.arange(10), np.arange(10)), -1).reshape(100, 2) * 20.0
    exact = np.concatenate([np.concatenate([xy, xy + 9], 1),     # 10x10 on a grid:
                            np.concatenate([xy, xy + [9, 2]], 1)])  # no two pairs meet
    mixed = [at_threshold_boxes(np_rng, 200, ((10, 3), (10, 4), (10, 2))) for _ in range(3)]
    boxes = np.stack([b[np_rng.permutation(200)] for b in [exact] + mixed]).astype(np.float32)
    boxes = T(boxes).reshape(1, 4, 200, 4).to(cuda)
    valid = torch.ones(1, 4, 200, dtype=torch.bool, device=cuda)
    got = assert_perclass_kernel_matches(boxes, valid)
    assert got[0, 0].all() and not got[0, 1:].all()


def band_pairs(rng, n, t=0.3):
    """Nested box pairs (outer, inner) from n candidates whose exact f32
    quotient inter / union lies in (t, the float after t]: the pairs K2
    decides by the IEEE division, as `open` (csrc/nms.cu k2_hit). Returns
    (outer [m, 4], inner [m, 4], rounds_up [m]): whether the f32 IoU
    rounds above t (the inner box is then suppressed)."""
    f = np.float32
    x2 = (f(900) + rng.randint(0, 2 ** 20, n).astype(f) * f(2.0 ** -14)).astype(f)
    y2 = (f(900) + rng.randint(0, 2 ** 20, n).astype(f) * f(2.0 ** -14)).astype(f)
    iy2 = (f(t) * (y2 + 1) - 1 + rng.randint(-64, 64, n).astype(f) * f(2.0 ** -15)).astype(f)
    zero = np.zeros(n, f)
    outer = np.stack([zero, zero, x2, y2], 1)
    inner = np.stack([zero, zero, x2, iy2], 1)
    area_o = (x2 + f(1)) * (y2 + f(1))
    inter = (x2 + f(1)) * (iy2 + f(1))     # the inner box is the intersection
    uni = np.maximum((area_o + inter) - inter, f(1e-8))
    s = np.nextafter(f(t), f(np.inf))
    exact = lambda x: inter.astype(np.float64) - np.float64(x) * uni.astype(np.float64)
    band = (exact(f(t)) > 0) & ~(exact(s) > 0)
    return outer[band], inner[band], ((inter / uni) > f(t))[band]


def assert_greedy_kernel_matches(boxes, scores, valid, thresh):
    before = nms.greedy_nms_cuda.launches
    got = nms.greedy_nms_mask(boxes, scores, valid, thresh)
    torch.cuda.synchronize()
    assert nms.greedy_nms_cuda.launches == before + 1
    exp = nms._greedy_nms_plain(boxes.cpu(), scores.cpu(), valid.cpu(), thresh)
    assert torch.equal(got.cpu(), exp)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 63, 64, 65, 6000, 9000])
def test_greedy_nms_kernel_chunk_edges(np_rng, cuda, n):
    """K3 at every edge of its 64-box chunks, with one all-invalid lane:
    identical keep masks; the invalid lane keeps nothing. N = 9000 (141
    mask words a row) loads its tiles in column pieces."""
    boxes = T(rand_boxes(np_rng, (3, n), 592)).to(cuda)
    scores = T(np_rng.uniform(0, 1, (3, n)).astype(np.float32)).to(cuda)
    valid = T(np_rng.uniform(0, 1, (3, n)) < 0.9).to(cuda)
    valid[1] = False
    got = assert_greedy_kernel_matches(boxes, scores, valid, 0.7)
    assert not got[1].any()


@pytest.mark.gpu
def test_greedy_nms_kernel_clustered(np_rng, cuda):
    """K3 on RPN-like clustered boxes at [4, 6000], t = 0.7."""
    boxes = anchor_like_boxes(np_rng, 4, 6000).to(cuda)
    scores = T(np_rng.uniform(0, 1, (4, 6000)).astype(np.float32)).to(cuda)
    valid = T(np_rng.uniform(0, 1, (4, 6000)) < 0.95).to(cuda)
    got = assert_greedy_kernel_matches(boxes, scores, valid, 0.7)
    assert 0 < int(got.sum()) < int(valid.sum()), "clustered boxes must suppress"


@pytest.mark.gpu
def test_greedy_nms_kernel_at_threshold(np_rng, cuda):
    """K3 on box pairs whose f32 IoU equals the threshold exactly: kept
    (the test is strictly greater), as in the plain version."""
    boxes = T(np.stack([at_threshold_boxes(np_rng, 400) for _ in range(2)])).to(cuda)
    scores = T(np_rng.uniform(0, 1, (2, 400)).astype(np.float32)).to(cuda)
    valid = torch.ones(2, 400, dtype=torch.bool, device=cuda)
    assert_greedy_kernel_matches(boxes, scores, valid, 0.7)


@pytest.mark.gpu
def test_per_class_nms_exact_route(np_rng, cuda):
    """per_class_nms_mask(per_class_topk=None): 604 lanes of 256 through K3."""
    b, n, c = 4, 256, 151
    boxes = T(rand_boxes(np_rng, (b, n, c), 592))
    probs = T(np_rng.dirichlet(np.ones(c), (b, n)).astype(np.float32))
    valid = T(np_rng.uniform(0, 1, (b, n)) < 0.9)
    before = nms.greedy_nms_cuda.launches
    got = nms.per_class_nms_mask(boxes.to(cuda), probs.to(cuda), valid.to(cuda), 0.3,
                                 0.0, per_class_topk=None)
    torch.cuda.synchronize()
    assert nms.greedy_nms_cuda.launches == before + 1
    exp = nms.per_class_nms_mask(boxes, probs, valid, 0.3, 0.0, per_class_topk=None)
    assert torch.equal(got.cpu(), exp)


def assert_roi_kernel_matches(fmap, rois, valid, tol):
    """K1 on the card against the plain form on the same (f32) values."""
    before = ra.roi_align_cuda.launches
    got = ra.roi_align(fmap, rois, valid, 7, 1 / 16)
    torch.cuda.synchronize()
    assert ra.roi_align_cuda.launches == before + 1
    assert got.dtype == fmap.dtype and got.is_contiguous()
    exp = ra._roi_align_matmul(fmap.float(), rois, valid, 7, 1 / 16)
    if fmap.dtype == torch.float32:
        assert (got - exp).abs().max().item() <= tol
    else:
        torch.testing.assert_close(got.float(), exp, rtol=tol, atol=tol)
    return got


DTYPE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [512, 20])
def test_roi_align_kernel_channels(np_rng, cuda, c, dtype):
    """K1's shared-memory path with full 16-byte channel vectors (C=512)
    and with a channel tail (C=20)."""
    fmap, rois, valid = roi_case(np_rng, 2, 300, c=c)
    f = T(fmap).to(cuda).to(dtype)
    assert_roi_kernel_matches(f, T(rois).to(cuda), T(valid).to(cuda), DTYPE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_unaligned_map(np_rng, cuda, dtype):
    """A contiguous map view whose data pointer is not 16-byte aligned
    (a flat buffer at an odd element offset) takes element copies."""
    fmap, rois, valid = roi_case(np_rng, 2, 200, c=64)
    flat = torch.zeros(fmap.size + 1, dtype=dtype, device=cuda)
    f = flat[1:].view(fmap.shape)
    f.copy_(T(fmap))
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    assert_roi_kernel_matches(f, T(rois).to(cuda), T(valid).to(cuda), DTYPE_TOL[dtype])


@pytest.mark.gpu
def test_roi_align_kernel_edge_rois(np_rng, cuda):
    """RoIs wholly outside the map, zero-width RoIs and invalid RoIs."""
    fmap = T(np_rng.standard_normal((1, 37, 37, 512)).astype(np.float32)).to(cuda)
    rois = torch.tensor([[[700, 700, 900, 800],     # right of / below the map
                          [-300, -200, -100, -50],  # left of / above it
                          [100, 50, 100, 300],      # zero width
                          [64, 64, 352, 576],       # samples on G-1 exactly
                          [10, 20, 300, 400]]], dtype=torch.float32, device=cuda)
    valid = torch.tensor([[True, True, True, True, False]], device=cuda)
    got = assert_roi_kernel_matches(fmap, rois, valid, 1e-4)
    assert not got[0, [0, 1, 4]].any()
    assert got[0, 2].abs().sum() > 0 and got[0, 3].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_kernel_large_map(np_rng, cuda, dtype):
    """A 128x128 map, whose 8-channel slice does not fit in shared memory,
    takes the device-memory gather of the same entry point."""
    fmap, rois, valid = roi_case(np_rng, 2, 50, h=128, w=128, c=64)
    rois = rois * (128 / 37)
    f = T(fmap).to(cuda).to(dtype)
    assert_roi_kernel_matches(f, T(rois).to(cuda), T(valid).to(cuda), DTYPE_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_backward_kernel_matches_plain(np_rng, cuda, dtype):
    """K1's backward at detector training's shape ([6, 37, 37, 512], 256 RoIs
    an image, some partly or wholly outside the map, ~10% invalid), through
    the autograd Function: one launch, the boxes no gradient, and the map's
    gradient against the plain version (autograd of the separable form in
    f32 on the same values): f32 within 1e-5 of its largest magnitude (f32
    atomics sum in another order), bf16 within rtol 1e-2 (one rounding of
    the f32 sums to bf16) plus 1e-3 of the largest magnitude."""
    fmap, rois, valid = roi_case(np_rng, 6, 256)
    f = T(fmap).to(cuda).to(dtype).requires_grad_(True)
    r = T(rois).to(cuda).requires_grad_(True)
    v = T(valid).to(cuda)
    g = torch.randn(6, 256, 7, 7, 512, generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda).to(dtype)
    before = (ra.roi_align_cuda.launches, ra.roi_align_bwd_cuda.launches)
    ra.roi_align(f, r, v, 7, 1 / 16).backward(g)
    torch.cuda.synchronize()
    assert (ra.roi_align_cuda.launches, ra.roi_align_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert r.grad is None and f.grad.dtype == dtype
    exp = ra._roi_align_bwd_plain(g.float(), f.detach().float(), r, v, 1 / 16)
    scale = exp.abs().max().item()
    assert scale > 0
    if dtype == torch.float32:
        assert (f.grad - exp).abs().max().item() <= 1e-5 * scale
    else:
        torch.testing.assert_close(f.grad.float(), exp, rtol=1e-2, atol=1e-3 * scale)


@pytest.mark.gpu
def test_roi_align_backward_kernel_edge_rois(np_rng, cuda):
    """The backward of RoIs wholly outside the map, of zero width, sampling
    on G-1 exactly, and invalid: nothing from the first two sides' outside
    samples or the invalid one, the rest as the plain version."""
    fmap = T(np_rng.standard_normal((1, 37, 37, 64)).astype(np.float32)).to(cuda)
    rois = torch.tensor([[[700, 700, 900, 800], [-300, -200, -100, -50],
                          [100, 50, 100, 300], [64, 64, 352, 576],
                          [10, 20, 300, 400]]], dtype=torch.float32, device=cuda)
    valid = torch.tensor([[True, True, True, True, False]], device=cuda)
    g = torch.randn(1, 5, 7, 7, 64, device=cuda)
    got = ra.roi_align_bwd_cuda(g, rois, valid, tuple(fmap.shape), torch.float32, 1 / 16)
    exp = ra._roi_align_bwd_plain(g, fmap, rois, valid, 1 / 16)
    assert (got - exp).abs().max().item() <= 1e-5 * exp.abs().max().item()
    only_out = ra.roi_align_bwd_cuda(g[:, :2], rois[:, :2], valid[:, :2],
                                     tuple(fmap.shape), torch.float32, 1 / 16)
    assert not only_out.any()


# K1's backward cases: (B, H, W, C, R) and the path the dispatch must take
BWD_CASES = {
    "train": ((6, 37, 37, 512, 256), "smem"),     # detector training's shape
    "resnet_train": ((6, 37, 37, 256, 256), "smem"),  # -resnet: the compressed map
    "resnet_c1024": ((4, 37, 37, 1024, 64), "smem"),  # -resnet: the trunk's map
    "b1": ((1, 37, 37, 512, 64), "smem"),
    "c20": ((2, 37, 37, 20, 100), "smem"),        # C not a multiple of 16 bytes
    "large": ((1, 128, 128, 64, 100), "scatter"),  # no accumulator fits
    "wide": ((1, 8, 160, 64, 50), "scatter"),      # rows over 128 cells
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", ["dispatch", "scatter"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_roi_align_backward_paths_match_plain(np_rng, cuda, case, path, dtype):
    """Both paths of K1's backward, the one the dispatch takes and the
    scatter path forced (`_scatter=True`), against the plain version, with the
    tolerances of test_roi_align_backward_kernel_matches_plain: the
    shared-memory kernel wherever its accumulator fits (37x37 maps at
    B = 6 and 1, C = 20: a slice narrower than the kernel's, not a multiple
    of 16 bytes in bf16), the scatter path for a 128x128 map and for rows
    wider than the kernel's locks cover; g and the map's gradient in
    `dtype`."""
    (b, h, w, c, r), taken = BWD_CASES[case]
    assert ra._bwd_smem_fits(h, w, 7) == (taken == "smem")
    fmap = T(np_rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda)
    rois = T(rand_boxes(np_rng, (b, r), 16 * max(h, w)) - 50.0).to(cuda)
    valid = T(np_rng.uniform(0, 1, (b, r)) < 0.9).to(cuda)
    g = T(np_rng.standard_normal((b, r, 7, 7, c)).astype(np.float32)).to(cuda).to(dtype)
    before = ra.roi_align_bwd_cuda.launches
    got = ra.roi_align_bwd_cuda(g, rois, valid, (b, h, w, c), dtype, 1 / 16,
                                _scatter=path == "scatter")
    torch.cuda.synchronize()
    assert ra.roi_align_bwd_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    exp = ra._roi_align_bwd_plain(g.float(), fmap, rois, valid, 1 / 16)
    scale = exp.abs().max().item()
    assert scale > 0
    if dtype == torch.float32:
        assert (got - exp).abs().max().item() <= 1e-5 * scale
    else:
        torch.testing.assert_close(got.float(), exp, rtol=1e-2, atol=1e-3 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_align_backward_smem_kernel_edge_rois(np_rng, cuda, dtype):
    """The shared-memory kernel on RoIs of every kind: random ones, boxes
    with x2 < x1 or y2 < y1 (their samples walk the map backwards), of zero
    width or height, wholly outside, sampling on G-1 exactly, tiny ones whose samples share cells, and invalid ones;
    C = 40 (a slice of 32 leaves a tail of 8), against the plain version
    within the tolerances of test_roi_align_backward_kernel_matches_plain."""
    b, h, w, c = 2, 37, 37, 40
    rois = rand_boxes(np_rng, (b, 120), 700) - 50.0
    rois[:, :10, [0, 2]] = rois[:, :10, [2, 0]]          # x2 < x1
    rois[:, 10:20, [1, 3]] = rois[:, 10:20, [3, 1]]      # y2 < y1
    rois[:, 20:25, 2] = rois[:, 20:25, 0]                # zero width
    rois[:, 25:30, 3] = rois[:, 25:30, 1]                # zero height
    rois[:, 30:35] = [700, 700, 900, 800]                # outside
    rois[:, 35:40] = [64, 64, 576, 576]                  # samples on G-1
    rois[:, 40:60, 2:] = rois[:, 40:60, :2] + np_rng.uniform(0, 20, (b, 20, 2))  # tiny
    valid = np_rng.uniform(0, 1, (b, 120)) < 0.9
    fmap = T(np_rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cuda)
    r, v = T(rois).to(cuda), T(valid).to(cuda)
    g = T(np_rng.standard_normal((b, 120, 7, 7, c)).astype(np.float32)).to(cuda).to(dtype)
    assert ra._bwd_smem_fits(h, w, 7)
    got = ra.roi_align_bwd_cuda(g, r, v, (b, h, w, c), dtype, 1 / 16)
    exp = ra._roi_align_bwd_plain(g.float(), fmap, r, v, 1 / 16)
    scale = exp.abs().max().item()
    assert scale > 0
    if dtype == torch.float32:
        assert (got - exp).abs().max().item() <= 1e-5 * scale
    else:
        torch.testing.assert_close(got.float(), exp, rtol=1e-2, atol=1e-3 * scale)


@pytest.mark.gpu
def test_greedy_nms_kernel_rpn_training_budget(np_rng, cuda):
    """The RPN's training proposals: nms_topk over [6, 12000] RPN-like
    clustered boxes at 0.7, keeping 2000 (188 mask words a row: the scan's
    column-piece path). The same indices and valid flags as on the CPU."""
    boxes = anchor_like_boxes(np_rng, 6, 12000)
    scores = T(np_rng.uniform(0, 1, (6, 12000)).astype(np.float32))
    valid = T(np_rng.uniform(0, 1, (6, 12000)) < 0.95)
    before = nms.greedy_nms_cuda.launches
    idx, ok = nms.nms_topk(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.7, 12000, 2000)
    torch.cuda.synchronize()
    assert nms.greedy_nms_cuda.launches == before + 1
    exp_idx, exp_ok = nms.nms_topk(boxes, scores, valid, 0.7, 12000, 2000)
    assert torch.equal(ok.cpu(), exp_ok) and torch.equal(idx.cpu()[exp_ok], exp_idx[exp_ok])
    assert 0 < int(exp_ok.sum()) <= 6 * 2000


# the spans the tracer gives a device time
DEVICE_SPANS = {"detector", "detector.trunk", "detector.rpn", "detector.head",
                "detector.decode", "relhead", "step", "step.forward", "step.backward",
                "step.update"}


@pytest.mark.gpu
def test_spans_add_no_sync_and_time_the_device(cuda, monkeypatch):
    """A tiny MotifNet sgdet forward and a tiny detector train step in a
    run of the tracer (utils/observe.py) make no more synchronizing calls
    (torch.cuda.set_sync_debug_mode("warn")) than with the spans stubbed
    out, and every span given the device has a device time once the run
    closes."""
    import collections
    import os
    import warnings

    from neural_motifs_tpu_torch.data.batching import to_device
    from neural_motifs_tpu_torch.training.build import batch_kwargs
    from neural_motifs_tpu_torch.utils import observe
    # the tiny models of the CPU tests beside this file (a sibling module
    # under pytest's default import mode)
    from test_torch_observe import detector_step, eval_model

    model, loader = eval_model("sgdet", cuda)
    kw = to_device(batch_kwargs(next(iter(loader))), cuda)
    _, step, det_loader, prepare = detector_step(cuda)
    det_kw = prepare(next(iter(det_loader)))

    def forward():
        with torch.no_grad():
            model(**kw)

    def train_step():
        step(det_kw, torch.Generator(device=cuda).manual_seed(1))

    def syncs(fn) -> collections.Counter:
        """Where `fn`'s synchronizing calls are, by file and line (the
        warning the mode itself gives once a process does not count)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                   if "called a synchronizing CUDA operation" in str(w.message))

    # warm-up of both: the kernels built, the allocator and the event pool warm
    with observe.run("eval"):
        forward()
        train_step()
    forward()
    train_step()
    torch.cuda.synchronize()
    with observe.run("eval") as run:
        traced = (syncs(forward), syncs(train_step))
    with monkeypatch.context() as m:
        m.setattr(observe, "span", lambda *a, **k: observe._NULL)
        plain = (syncs(forward), syncs(train_step))
    for t, p in zip(traced, plain):
        assert sum(t.values()) <= sum(p.values()), (t, p)
    timed = {r.name for r in run.records if r.device_s is not None}
    assert timed == DEVICE_SPANS, sorted(timed ^ DEVICE_SPANS)
    assert all(r.device_s > 0 for r in run.records if r.name in DEVICE_SPANS), \
        [(r.name, r.device_s) for r in run.records if r.name in DEVICE_SPANS]
    assert not run.pending


def lstm_case(rng, b, t, d, h, layers, lengths, dropout=False, device="cpu"):
    """A highway-LSTM stack's params (fan-in scaled, forget bias 1), inputs
    [B, T, D] ~ N(0, 1), lengths [B] int64 and per layer a [B, H] dropout
    mask scaled by 1 / 0.9 (or None)."""
    def t32(a):
        return T(np.asarray(a, np.float32)).to(device)
    params = []
    for layer in range(layers):
        d_in = d if layer == 0 else h
        bias = rng.uniform(-0.1, 0.1, 5 * h)
        bias[h:2 * h] += 1.0
        params.append({"w_i": t32(rng.uniform(-1, 1, (d_in, 6 * h)) / np.sqrt(d_in)),
                       "w_h": t32(rng.uniform(-1, 1, (h, 5 * h)) / np.sqrt(h)),
                       "bias": t32(bias)})
    x = t32(rng.standard_normal((b, t, d)))
    masks = ([t32((rng.uniform(0, 1, (b, h)) < 0.9) / 0.9) for _ in range(layers)]
             if dropout else None)
    return params, x, T(np.asarray(lengths, np.int64)).to(device), masks


@pytest.fixture
def no_lstm_kernel(monkeypatch):
    """`_cuda.lib()` raises: nothing under test may reach the kernel library."""
    def refuse():
        raise AssertionError("reached _cuda.lib()")
    monkeypatch.setattr(_cuda, "lib", refuse)


def test_cpu_highway_lstm_takes_the_plain_loop(np_rng, no_lstm_kernel):
    """CPU tensors run the eager loop whether autograd records or not, never
    reach the kernel library and count no launch; the kernel's wrapper
    refuses CPU tensors."""
    before = hl.highway_lstm_cuda.launches
    params, x, lengths, masks = lstm_case(np_rng, 3, 7, 10, 6, 3, [7, 0, 4], dropout=True)
    exp = hl._alternating(params, x, lengths, masks, kernel=False)
    with torch.no_grad():
        torch.testing.assert_close(hl.alternating_highway_lstm(params, x, lengths, masks),
                                   exp, rtol=0, atol=0)
    for p in params:
        for v in p.values():
            v.requires_grad_(True)
    got = hl.alternating_highway_lstm(params, x, lengths, masks)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), exp, rtol=0, atol=0)
    assert hl.highway_lstm_cuda.launches == before
    p = params[0]
    with pytest.raises(ValueError, match="CUDA"):
        hl.highway_lstm_cuda((x @ p["w_i"]).detach(), p["w_h"].detach(),
                             p["bias"].detach(), lengths)


@pytest.mark.parametrize("bad", ["gi_width", "w_h", "bias", "lengths", "mask", "f64"])
def test_highway_lstm_cuda_checks_its_inputs(np_rng, no_lstm_kernel, bad):
    """The wrapper raises on a shape or type the kernel does not take,
    before it reaches the kernel library."""
    b, t, h = 2, 5, 8
    gi = torch.zeros(b, t, 6 * h)
    w_h, bias = torch.zeros(h, 5 * h), torch.zeros(5 * h)
    lengths, mask = torch.tensor([5, 3]), torch.ones(b, h)
    if bad == "gi_width":
        gi = torch.zeros(b, t, 5 * h)
    elif bad == "w_h":
        w_h = torch.zeros(h, 6 * h)
    elif bad == "bias":
        bias = torch.zeros(6 * h)
    elif bad == "lengths":
        lengths = torch.tensor([5, 3, 1])
    elif bad == "mask":
        mask = torch.ones(b, h + 1)
    else:
        gi = gi.double()
    with pytest.raises(TypeError if bad == "f64" else ValueError):
        hl.highway_lstm_cuda(gi, w_h, bias, lengths, mask)


@pytest.mark.parametrize("mode,param_grad,x_grad,records", [
    ("grad", True, False, True), ("grad", False, True, True),
    ("grad", False, False, False), ("no_grad", True, True, False),
    ("inference", True, False, False)])
def test_highway_lstm_dispatch_follows_autograd(np_rng, mode, param_grad, x_grad, records):
    """The kernel path is taken unless autograd records the call: grad mode
    on and the input or a parameter requiring a gradient."""
    params, x, _, _ = lstm_case(np_rng, 2, 3, 4, 4, 2, [3, 1])
    for p in params:
        for v in p.values():
            v.requires_grad_(param_grad)
    x.requires_grad_(x_grad)
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    with ctx():
        assert hl._records_grad(params, x) is records


def mixed_lengths(rng, b, t):
    """Lengths T, 0 and 1 (as many as B holds) among uniform draws in [0, T]."""
    lengths = rng.randint(0, t + 1, b)
    lengths[:3] = [t, 0, 1][:b]
    return lengths


def assert_lstm_kernel_matches(params, x, lengths, masks):
    """The stack through the kernel (autograd off) against the eager loop on
    the same CUDA inputs: within 1e-4 at outputs of magnitude ~1 (f32 FMAs in
    the kernel's fixed order against cuBLAS's f32 GEMM, ~1e-6 a step, carried
    through the recurrence), exactly 0 at every padded position, one launch
    a layer."""
    before = hl.highway_lstm_cuda.launches
    with torch.no_grad():
        got = hl.alternating_highway_lstm(params, x, lengths, masks)
        torch.cuda.synchronize()
        assert hl.highway_lstm_cuda.launches == before + len(params)
        exp = hl._alternating(params, x, lengths, masks, kernel=False)
    assert got.shape == exp.shape and got.dtype == torch.float32
    pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
    assert not got[pad].any(), "padded positions must be exactly 0"
    assert (got - exp).abs().max().item() <= 1e-4
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("d,layers", [(4424, 2), (4808, 4)], ids=["obj", "edge"])
def test_highway_lstm_kernel_matches_plain(np_rng, cuda, d, layers, dropout):
    """K4 at the sgdet cell's shapes (B 16, T 64, H 512; the object stack's
    4424 inputs and 2 layers, the edge stack's 4808 and 4), both directions,
    lengths 0, 1, 64 and random, with and without dropout masks."""
    params, x, lengths, masks = lstm_case(np_rng, 16, 64, d, 512, layers,
                                          mixed_lengths(np_rng, 16, 64), dropout, cuda)
    assert_lstm_kernel_matches(params, x, lengths, masks)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,d", [(1, 37, 256, 300), (3, 13, 16, 24),
                                     (40, 9, 512, 64), (5, 11, 102, 7)])
def test_highway_lstm_kernel_other_shapes(np_rng, cuda, b, t, h, d):
    """K4 at predict's B 1 with the default hidden 256, a tiny H, a batch of
    three row tiles (40), an H that is no multiple of 4; T of 37, 13, 9, 11."""
    params, x, lengths, masks = lstm_case(np_rng, b, t, d, h, 3, mixed_lengths(np_rng, b, t),
                                          device=cuda)
    assert_lstm_kernel_matches(params, x, lengths, masks)


@pytest.mark.gpu
def test_highway_lstm_kernel_all_empty(np_rng, cuda):
    """Every length 0: no step runs, the output is all zeros."""
    params, x, lengths, _ = lstm_case(np_rng, 4, 6, 8, 32, 2, [0, 0, 0, 0], device=cuda)
    got = assert_lstm_kernel_matches(params, x, lengths, None)
    assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1024, 2048])
def test_highway_lstm_kernel_refuses_large_hidden(cuda, h):
    """A hidden size that needs more blocks of 4 units than the card has
    SMs raises, before any launch."""
    gi = torch.zeros(2, 3, 6 * h, device=cuda)
    w_h, bias = torch.zeros(h, 5 * h, device=cuda), torch.zeros(5 * h, device=cuda)
    before = hl.highway_lstm_cuda.launches
    with pytest.raises(ValueError, match="does not fit"):
        hl.highway_lstm_cuda(gi, w_h, bias, torch.tensor([3, 2], device=cuda))
    assert hl.highway_lstm_cuda.launches == before


@pytest.mark.gpu
def test_highway_lstm_under_autograd_takes_plain_loop(np_rng, cuda):
    """With parameters requiring gradients and grad mode on, CUDA tensors
    run the eager loop: no launch, and the same outputs and gradients as
    the plain loop called directly."""
    params, x, lengths, masks = lstm_case(np_rng, 4, 9, 12, 16, 2, [9, 0, 5, 1],
                                          dropout=True, device=cuda)
    for p in params:
        for v in p.values():
            v.requires_grad_(True)
    before = hl.highway_lstm_cuda.launches
    got = hl.alternating_highway_lstm(params, x, lengths, masks)
    grads = torch.autograd.grad(got.square().sum(), [p["w_h"] for p in params])
    assert hl.highway_lstm_cuda.launches == before
    exp = hl._alternating(params, x, lengths, masks, kernel=False)
    exp_grads = torch.autograd.grad(exp.square().sum(), [p["w_h"] for p in params])
    assert torch.equal(got, exp)
    assert all(torch.equal(a, e) for a, e in zip(grads, exp_grads))
