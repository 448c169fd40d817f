"""Port parity, ``repro_torch.configs.shapes``: the shape registry, and
``materialize`` giving the reference's values from one seed."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro_torch.configs as tc
from repro.configs.shapes import materialize as ref_materialize
from repro_torch.configs.shapes import materialize

Pair = collections.namedtuple("Pair", "a b")


def _specs(struct):
    """One spec tree (int32 and float32 leaves, dict, list, namedtuple,
    a scalar) in either package's struct form."""
    return {
        "tokens": struct((4, 9), "int32"),
        "embeds": struct((2, 3, 5), "float32"),
        "step": struct((), "int32"),
        "cube": struct((2, 2, 3), "int32"),
        "rest": [struct((7,), "float32"), Pair(struct((3, 3), "int32"), None)],
    }


def _jax_struct(shape, dtype):
    return jax.ShapeDtypeStruct(shape, getattr(jnp, dtype))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


@pytest.mark.parametrize("seed", [0, 5])
def test_materialize_matches_reference(seed):
    want = ref_materialize(_specs(_jax_struct), seed=seed)
    got = materialize(_specs(_meta), seed=seed, device="cpu")
    assert list(got) == sorted(got) == list(want)
    assert isinstance(got["rest"][1], Pair) and got["rest"][1].b is None
    flat_w = jax.tree.leaves(want)
    flat_g = [got[k] for k in ("cube", "embeds")] + [got["rest"][0], got["rest"][1].a] + [
        got["step"], got["tokens"]
    ]
    assert len(flat_w) == len(flat_g) == 6
    for w, g in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert g.device.type == "cpu" and str(g.dtype) == f"torch.{w.dtype}"
        assert np.array_equal(w, g.numpy())


def test_shape_registry_matches_reference():
    assert set(tc.__all__) == set(rc.__all__)
    assert {k: tuple(v.__dict__.values()) for k, v in tc.SHAPES.items()} == {
        k: tuple(v.__dict__.values()) for k, v in rc.SHAPES.items()
    }
    assert [f.name for f in dataclasses.fields(tc.ShapeSpec)] == [
        f.name for f in dataclasses.fields(rc.ShapeSpec)
    ]
