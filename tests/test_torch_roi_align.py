"""The port's RoIAlign (neural_motifs_tpu_torch.ops.roi_align) against the JAX
separable form and the Pallas kernel in interpret mode, on the CPU in f32.
The CUDA kernel is held against this plain version in
tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neural_motifs_tpu.ops.roi_align import _roi_align_matmul as jax_roi_align_matmul
from neural_motifs_tpu.ops.roi_align import interp_matrix as jax_interp_matrix
from neural_motifs_tpu_torch.ops import roi_align as port


def make_case(rng, b=2, h=19, w=23, c=8, r=21):
    """RoIs partly outside the map (negative and beyond 16*dim) and an
    invalid tail in image 1."""
    fmap = rng.standard_normal((b, h, w, c)).astype(np.float32)
    xy = rng.uniform(-20, 300, (b, r, 2)).astype(np.float32)
    wh = rng.uniform(1, 200, (b, r, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh], -1)
    valid = np.ones((b, r), bool)
    valid[1, 15:] = False
    return fmap, rois, valid


def test_interp_matrix_matches_jax(rng):
    lo = rng.uniform(-3, 20, (5,)).astype(np.float32)
    hi = lo + rng.uniform(0, 15, (5,)).astype(np.float32)
    got = port.interp_matrix(torch.from_numpy(lo), torch.from_numpy(hi), 7, 19)
    exp = jax_interp_matrix(jnp.asarray(lo), jnp.asarray(hi), 7, 19)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [0, 8])
def test_roi_align_matches_jax_matmul(rng, chunk):
    """The CPU path (chunked and not) == the JAX separable form, rtol = atol
    = 1e-5 (f32, summation order only)."""
    fmap, rois, valid = make_case(rng)
    got = port.roi_align(torch.from_numpy(fmap), torch.from_numpy(rois),
                         torch.from_numpy(valid), 7, 1.0 / 16.0, chunk=chunk)
    exp = jax_roi_align_matmul(jnp.asarray(fmap), jnp.asarray(rois),
                               jnp.asarray(valid), 7, 1.0 / 16.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)
    assert not got.numpy()[1, 15:].any(), "invalid RoIs must give zeros"


def test_roi_align_matches_pallas_interpret(rng):
    """The port == the Pallas TPU kernel run in Mosaic interpret mode,
    rtol = atol = 1e-5."""
    from jax.experimental.pallas import tpu as pltpu
    from neural_motifs_tpu.ops.pallas_roi_align import pallas_roi_align

    fmap, rois, valid = make_case(rng)
    with pltpu.force_tpu_interpret_mode():
        exp = pallas_roi_align(jnp.asarray(fmap), jnp.asarray(rois),
                               jnp.asarray(valid), 7, 1.0 / 16.0)
    got = port.roi_align(torch.from_numpy(fmap), torch.from_numpy(rois),
                         torch.from_numpy(valid), 7, 1.0 / 16.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)


EDGE_ROIS = {
    # x1 * s = 4 and x2 * s = 22: step 3, the last x sample exactly on G-1
    # (the right neighbour does not exist); y likewise on 18 = H-1
    "sample_on_last_cell": [64.0, 16.0, 352.0, 288.0],
    "zero_width": [100.0, 40.0, 100.0, 200.0],
    "wholly_outside": [400.0, 350.0, 600.0, 500.0],
}


@pytest.mark.parametrize("case", sorted(EDGE_ROIS))
def test_roi_align_edge_rois_match_jax(rng, case):
    """Edge RoIs of the plain form against the JAX separable form: a sample
    exactly at G-1, a zero-width RoI, a RoI wholly outside the map (zeros)."""
    fmap = rng.standard_normal((1, 19, 23, 8)).astype(np.float32)
    rois = np.array([[EDGE_ROIS[case], [10.0, 20.0, 150.0, 170.0]]], np.float32)
    valid = np.ones((1, 2), bool)
    got = port.roi_align(torch.from_numpy(fmap), torch.from_numpy(rois),
                         torch.from_numpy(valid), 7, 1.0 / 16.0).numpy()
    exp = np.asarray(jax_roi_align_matmul(jnp.asarray(fmap), jnp.asarray(rois),
                                          jnp.asarray(valid), 7, 1.0 / 16.0))
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    if case == "wholly_outside":
        assert not got[0, 0].any()
    else:
        assert np.abs(got[0, 0]).sum() > 0
    if case == "sample_on_last_cell":   # the corner sample is the corner cell
        np.testing.assert_allclose(got[0, 0, 6, 6], fmap[0, 18, 22], rtol=1e-6)
