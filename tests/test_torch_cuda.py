"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on a CUDA device (every test here is marked ``cuda`` and skips
without one).  This file imports only torch, numpy and the port, so it runs
on a machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.nsga2_torch import nondominated_rank  # noqa: E402
from repro_torch.kernels import ops, pareto_rank, ref  # noqa: E402

SIZES = (33, 97, 130, 4096)


def population(n, m=3, infeas=0.3, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return F, CV


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("infeas", (0.0, 0.3, 1.0))
def test_kernels_match_plain_versions(cuda_device, n, infeas):
    F, CV = (torch.from_numpy(a).to(cuda_device)
             for a in population(n, infeas=infeas, seed=n))
    alive = torch.from_numpy(np.random.default_rng(n).random(n) < 0.5).to(
        cuda_device)
    for block in (32, 64, 2048):
        got = pareto_rank.packed_domination(F, CV, F, CV,
                                            bp=ops._row_tile(block))
        assert torch.equal(got, ref.packed_domination(F, CV, F, CV, block))
    for mask in (torch.ones_like(alive), alive):
        assert torch.equal(pareto_rank.domination_counts(F, CV, mask),
                           ref.domination_counts(F, CV, mask))


@pytest.mark.cuda
def test_kernels_count_launches_and_reject_bad_inputs(cuda_device):
    F, CV = (torch.from_numpy(a).to(cuda_device) for a in population(64))
    before = pareto_rank.packed_domination.launches
    pareto_rank.packed_domination(F, CV, F, CV, bp=32)
    assert pareto_rank.packed_domination.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        pareto_rank.packed_domination(F.double(), CV, F, CV)
    with pytest.raises(ValueError, match="contiguous"):
        pareto_rank.packed_domination(F.t().contiguous().t(), CV, F, CV)
    with pytest.raises(ValueError, match="multiple of 32"):
        pareto_rank.packed_domination(F, CV, F, CV, bp=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        pareto_rank.packed_domination(F, CV, F, CV, bq=2048)
    with pytest.raises(ValueError, match="objectives exceed"):
        G = torch.zeros((64, 9), device=cuda_device)
        pareto_rank.packed_domination(G, CV, G, CV)


@pytest.mark.cuda
def test_tiled_rank_on_card_equals_dense_rank_on_cpu(cuda_device):
    F, CV = population(1500, seed=7)
    want = nondominated_rank(torch.from_numpy(F), torch.from_numpy(CV), 700)
    got = nondominated_rank(torch.from_numpy(F).to(cuda_device),
                            torch.from_numpy(CV).to(cuda_device), 700,
                            rank_block=256).cpu()
    assert torch.equal(got, want)
