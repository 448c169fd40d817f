"""The hand-written CUDA support kernel against its plain version, on the
card.  Marked ``gpu``: each test decides inside itself whether a CUDA device
is present and skips otherwise (run them on a machine with an H100:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``)."""

import numpy as np
import pytest
import torch

import repro_torch.graphs as tg
from repro_torch.api import bucket_for
from repro_torch.core import prepare_fine, support_fine_owner, support_numpy
from repro_torch.kernels import support_fine, support_fine_cuda

pytestmark = pytest.mark.gpu

GRAPHS = [
    lambda: tg.erdos(120, 8.0, seed=0),
    lambda: tg.clustered(3, 18, 0.7, seed=1),
    lambda: tg.rmat(7, 5, seed=2),
    lambda: tg.barabasi(400, 4, seed=3),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("make", GRAPHS, ids=["erdos", "clustered", "rmat", "barabasi"])
def test_kernel_matches_plain_version_on_random_masks(cuda, make):
    g = make()
    w = bucket_for(g, chunk=64).window
    p = prepare_fine(g, chunk=64, device=cuda)
    real = (p.colidx != 0).cpu().numpy()
    rng = np.random.default_rng(5)
    for keep in (1.0, 0.8, 0.5, 0.1):
        alive = torch.from_numpy(real & (rng.random(real.shape[0]) < keep)).to(cuda)
        before = support_fine_cuda.launches
        got = support_fine_cuda(p, alive)
        torch.cuda.synchronize()
        assert support_fine_cuda.launches == before + 1
        want = support_fine_owner(p, alive, window=w, chunk=64)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (g.name, keep)
    full = support_fine_cuda(p, torch.from_numpy(real).to(cuda))
    assert np.array_equal(full.cpu().numpy()[: g.nnz], support_numpy(g))


def test_kernel_on_aligned_pack_with_pad_lanes_between_rows(cuda):
    gs = [f() for f in GRAPHS[:3]]
    pp = tg.pack_problems(
        gs, slot_n=128, slot_nnz=1024, slots=4, chunk=64, layout="aligned", device=cuda
    )
    alive = pp.problem.colidx != 0
    w = max(bucket_for(g, chunk=64).window for g in gs)
    got = support_fine(pp.problem, alive, window=w, chunk=64)  # the CUDA branch
    want = support_fine_owner(pp.problem, alive, window=w, chunk=64)
    assert torch.equal(got, want)
    for g, (a, b) in zip(gs, pp.edge_ranges):
        assert np.array_equal(got[a:b].cpu().numpy(), support_numpy(g)), g.name


def test_kernel_refuses_wrong_inputs(cuda):
    g = GRAPHS[0]()
    p = prepare_fine(g, chunk=64, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        support_fine_cuda(p, (p.colidx != 0).to(torch.int32))
