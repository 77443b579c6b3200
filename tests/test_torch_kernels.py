"""The port's CUDA kernels (K1 RoIAlign and its backward, K2 per-class NMS,
K3 greedy NMS) against their plain PyTorch versions, and the device dispatch of their
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
