"""Port parity, dense layer (Algorithm 1): the port's ``ops.support_dense``
(its plain version on the CPU) equals the JAX package's
``repro.kernels.ops.support_dense`` (the Pallas kernel in interpret mode)
exactly, and the dense and numpy oracles equal the reference's.

Inputs are made with numpy from fixed seeds and handed to both packages.
Every value is an integer count held exactly in float32, so every
comparison is exact: same dtype, same shape, same values."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as rcore
import repro.kernels.ops as rops
import repro.kernels.ref as rref
import repro_torch.core as tcore
import repro_torch.kernels.ops as tops
import repro_torch.kernels.ref as tref
from _torch_parity import assert_same, small_pairs


def _sym(v, seed, density=0.1):
    """A seeded symmetric 0/1 float32 adjacency with an empty diagonal."""
    rng = np.random.default_rng(seed)
    u = np.triu((rng.random((v, v)) < density).astype(np.float32), 1)
    return u + u.T


def _dense_adjacency(g):
    u = g.dense_upper()
    return u + u.T


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("v", [96, 200])
def test_support_dense_matches_pallas_kernel(block, v):
    u = _sym(v, block + v)
    want = rops.support_dense(jnp.asarray(u), block=block)
    got = tops.support_dense(torch.from_numpy(u), block=block)
    assert_same(want, got, (block, v))


@pytest.mark.parametrize(
    "block,v", [(64, 96), (64, 128), (64, 200), (32, 128), (128, 128), (48, 130)]
)
def test_support_dense_matches_dense_ref(block, v):
    """The rest of the reference's block × V grid (and a block that is not
    a divisor of the kernel's 128 tile), against ``support_dense_ref``."""
    u = _sym(v, block + v)
    want = rref.support_dense_ref(jnp.asarray(u))
    got = tops.support_dense(torch.from_numpy(u), block=block)
    assert_same(want, got, (block, v))
    assert_same(want, tref.support_dense_ref(torch.from_numpy(u)), "port support_dense_ref")


def test_support_dense_asymmetric_input():
    """The function is defined for any square 0/1 matrix: nothing may
    assume symmetry."""
    rng = np.random.default_rng(7)
    u = (rng.random((96, 96)) < 0.2).astype(np.float32)
    assert not np.array_equal(u, u.T)
    want = rops.support_dense(jnp.asarray(u), block=32)
    got = tops.support_dense(torch.from_numpy(u), block=32)
    assert_same(want, got, "asymmetric")
    np.testing.assert_array_equal(got.numpy(), (u @ u) * u)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.int64, torch.float64])
def test_support_dense_accepts_any_real_or_bool_dtype(dtype):
    u = _sym(100, 3)
    want = tops.support_dense(torch.from_numpy(u))
    got = tops.support_dense(torch.from_numpy(u).to(dtype))
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_support_dense_refuses_bad_inputs():
    u = torch.from_numpy(_sym(64, 1))
    for bad in (2.0, -1.0, 0.5, float("nan")):
        x = u.clone()
        x[3, 5] = bad
        with pytest.raises(ValueError, match="0/1"):
            tops.support_dense(x)
    with pytest.raises(ValueError, match="square"):
        tops.support_dense(u[:, :10])
    with pytest.raises(ValueError, match="block"):
        tops.support_dense(u, block=0)


def test_ktruss_dense_matches_reference():
    gr, gt = small_pairs()[0]
    u = _dense_adjacency(gr)
    adj_r, s_r = rcore.ktruss_dense(jnp.asarray(u), 3)
    adj_t, s_t = tcore.ktruss_dense(torch.from_numpy(u), 3)
    assert_same(adj_r, adj_t, "adj")
    assert_same(s_r, s_t, "support")
    alive_ref, s_ref = tcore.ktruss_numpy(gt, 3)
    rows, cols = gt.row_of_edge(), gt.colidx
    assert np.array_equal(adj_t.numpy()[rows, cols] > 0, alive_ref)
    assert np.array_equal(s_t.numpy()[rows, cols], s_ref)


def test_support_dense_oracle_matches_reference():
    gr, _ = small_pairs()[1]
    u = _dense_adjacency(gr)
    assert_same(rcore.support_dense(jnp.asarray(u)), tcore.support_dense(torch.from_numpy(u)))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_kmax_numpy_matches_reference(i):
    gr, gt = small_pairs()[i]
    assert tcore.kmax_numpy(gt) == rcore.kmax_numpy(gr)
    assert tcore.kmax_numpy(gt, k_start=4) == rcore.kmax_numpy(gr, k_start=4)
