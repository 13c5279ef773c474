"""The port's kernels (``repro_torch.kernels``) through their plain PyTorch
versions: the Pareto-domination pair against the JAX package's
``ops.packed_domination`` / ``ops.domination_counts`` (its ``ref`` and
Pallas-interpret impls) and the dense ``nsga2_jax.domination_matrix``, bit
for bit, at ragged sizes, with duplicated rows, all-infeasible populations
and alive masks; sliding-window attention against the JAX package's Pallas
kernel in interpret mode; the dispatch rules; the build's library names.
The CUDA kernels themselves
are held against these plain versions in ``test_torch_cuda.py`` (on a card
only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import nsga2_jax  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.window_attn import window_attn as pl_window_attn  # noqa: E402
from repro_torch.core import nsga2_torch  # noqa: E402
from repro_torch.kernels import ops, pareto_rank, ref, window_attn  # noqa: E402

torch.set_num_threads(2)

JAX_IMPLS = ("ref", "pallas")
SIZES = (33, 97, 130)     # deliberately ragged vs the 32/64-row tiles


def population(n, m=3, infeas=0.3, dup=False, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m)).astype(np.float32)
    if dup:                      # duplicated objective vectors share fronts
        F[n // 2:] = F[rng.integers(0, n // 2, n - n // 2)]
    CV = np.where(rng.random(n) < infeas, (rng.random(n) * 3).round(1),
                  0.0).astype(np.float32)
    return F, CV


def words_u32(t):
    return t.numpy().view(np.uint32)


# -- plain versions vs the JAX package ----------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_packed_domination_matches_jax(n):
    F, CV = population(n, dup=True, seed=n)
    got = words_u32(ops.packed_domination(torch.from_numpy(F),
                                          torch.from_numpy(CV), block=32,
                                          impl="ref"))
    dense = np.asarray(nsga2_jax._pack_bits(nsga2_jax.domination_matrix(
        jnp.asarray(F), jnp.asarray(CV))))
    assert got.shape == dense.shape
    assert (got == dense).all()
    for impl in JAX_IMPLS:
        want = np.asarray(jops.packed_domination(
            jnp.asarray(F), jnp.asarray(CV), block=32, impl=impl))
        assert (got == want).all(), impl


def test_packed_domination_all_infeasible_and_all_feasible():
    rng = np.random.default_rng(9)
    F = rng.random((97, 2)).astype(np.float32)
    for CV in ((rng.random(97) * 2 + 0.1).round(1).astype(np.float32),
               np.zeros(97, np.float32)):
        got = words_u32(ops.packed_domination(
            torch.from_numpy(F), torch.from_numpy(CV), block=64, impl="ref"))
        for impl in JAX_IMPLS:
            want = np.asarray(jops.packed_domination(
                jnp.asarray(F), jnp.asarray(CV), block=64, impl=impl))
            assert (got == want).all(), impl


@pytest.mark.parametrize("n", SIZES)
def test_domination_counts_match_jax(n):
    F, CV = population(n, dup=True, seed=n + 1)
    alive = np.random.default_rng(n).random(n) < 0.5
    D = np.asarray(nsga2_jax.domination_matrix(jnp.asarray(F),
                                               jnp.asarray(CV)))
    Ft, CVt = torch.from_numpy(F), torch.from_numpy(CV)
    got = ops.domination_counts(Ft, CVt, block=32, impl="ref").numpy()
    got_alive = ops.domination_counts(Ft, CVt, torch.from_numpy(alive),
                                      block=32, impl="ref").numpy()
    assert (got == D.sum(axis=0)).all()
    assert (got_alive == D[alive].sum(axis=0)).all()
    for impl in JAX_IMPLS:
        assert (got == np.asarray(jops.domination_counts(
            jnp.asarray(F), jnp.asarray(CV), block=32, impl=impl))).all()
        assert (got_alive == np.asarray(jops.domination_counts(
            jnp.asarray(F), jnp.asarray(CV), jnp.asarray(alive), block=32,
            impl=impl))).all()


def test_padding_rows_dominate_nothing():
    Fr, cvr = ref._pad_rows(torch.zeros((5, 2)), torch.zeros(5), 32)
    assert Fr.shape == (32, 2) and torch.isinf(cvr[5:]).all()
    tile = ref.dominates_tile(Fr, cvr, torch.ones((7, 2)), torch.zeros(7))
    assert tile[:5].all() and not tile[5:].any()


def test_nan_compares_false():
    F = torch.tensor([[0.0, float("nan")], [1.0, 1.0], [0.5, 0.5]])
    CV = torch.tensor([0.0, 0.0, float("nan")])
    tile = ref.dominates_tile(F, CV, F, CV)
    want = np.asarray(nsga2_jax.domination_matrix(jnp.asarray(F.numpy()),
                                                  jnp.asarray(CV.numpy())))
    assert (tile.numpy() == want).all()


# -- dispatch -----------------------------------------------------------------

def test_resolve_impl_rules():
    x = torch.zeros(3)
    assert ops.resolve_impl("auto", x) == "ref"
    assert ops.resolve_impl("ref", x) == "ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.resolve_impl("cuda", x)
    with pytest.raises(ValueError, match="valid choices"):
        ops.resolve_impl("pallas", x)
    F, CV = population(40, seed=2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.packed_domination(torch.from_numpy(F), torch.from_numpy(CV),
                              impl="cuda")


def test_kernel_wrappers_run_plain_version_on_cpu():
    F, CV = population(70, dup=True, seed=5)
    Ft, CVt = torch.from_numpy(F), torch.from_numpy(CV)
    before = (pareto_rank.packed_domination.launches,
              pareto_rank.domination_counts.launches)
    words = pareto_rank.packed_domination(Ft, CVt, Ft, CVt)
    counts = pareto_rank.domination_counts(Ft, CVt,
                                           torch.ones(70, dtype=torch.int32))
    assert (words_u32(words) == words_u32(ref.packed_domination(
        Ft, CVt, Ft, CVt, 32))).all()
    assert (counts == ref.domination_counts(Ft, CVt)).all()
    assert (pareto_rank.packed_domination.launches,
            pareto_rank.domination_counts.launches) == before


# -- window_attn --------------------------------------------------------------

def qkv(b, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32))


# the shapes of the JAX package's own window_attn sweep, at its tolerance
@pytest.mark.parametrize("t,w,bq", [(256, 128, 64), (256, 64, 64),
                                    (512, 256, 128)])
@pytest.mark.parametrize("h,kv,hd", [(4, 2, 64), (4, 4, 32)])
def test_window_attn_plain_matches_pallas(t, w, bq, h, kv, hd):
    q, k, v = qkv(2, t, h, kv, hd, seed=t + w + h)
    got = ops.window_attn(*map(torch.from_numpy, (q, k, v)), w, impl="ref")
    want = pl_window_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=w, bq=bq, bk=bq, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# off the TPU kernel's 128 grid the reference dispatch takes its plain
# version, so these ragged shapes compare the two plain versions
@pytest.mark.parametrize("t,w", [(1, 1), (100, 64), (100, 1000), (130, 1)])
def test_window_attn_plain_matches_reference_off_grid(t, w):
    q, k, v = qkv(1, t, 6, 2, 32, seed=t)
    got = ops.window_attn(*map(torch.from_numpy, (q, k, v)), w, impl="ref")
    want = jref.window_attn(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 3, 2),
                            jnp.repeat(jnp.asarray(v), 3, 2), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_window_attn_dispatch_and_cpu_wrapper():
    q, k, v = map(torch.from_numpy, qkv(2, 96, 6, 2, 32, seed=1))
    before = window_attn.window_attn.launches
    want = ops.window_attn(q, k, v, 40, impl="ref")
    assert torch.equal(ops.window_attn(q, k, v, 40), want)      # auto -> ref
    assert torch.equal(window_attn.window_attn(q, k, v, 40), want)
    assert window_attn.window_attn.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.window_attn(q, k, v, 40, impl="cuda")
    with pytest.raises(ValueError, match="no kernel for device"):
        window_attn.window_attn(q.to("meta"), k.to("meta"), v.to("meta"), 40)


# -- build --------------------------------------------------------------------

def test_build_target_name_hashes_the_included_headers(tmp_path):
    """An edited header (here one the source reaches through another)
    gives a new library name, so the edit is rebuilt; the same contents
    give the same name."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    names = []
    for body in ("int b = 1;\n", "int b = 2;\n", "int b = 1;\n"):
        (tmp_path / "b.cuh").write_text(body)
        names.append(_build._target("k.cu", tmp_path).name)
    assert names[0] != names[1] and names[0] == names[2]
    assert all(n.startswith("k_") and n.endswith(".so") for n in names)
    assert [h.name for h in _build._headers("k.cu", tmp_path)] == [
        "a.cuh", "b.cuh"]
    # the port's two tensor-core kernels share the 3xTF32 header
    for source in ("window_attn.cu", "ssd_scan.cu"):
        assert [h.name for h in _build._headers(source)] == [
            "mma_tf32x3.cuh"]
    assert _build._headers("pareto_rank.cu") == []


def test_kernel_names_from_the_sass_listing():
    from repro_torch.kernels import _build
    assert _build._kernel_name(
        "_ZN47_GLOBAL__N__6b3ac481_14_window_attn_cu_b8087fe218window_attn_"
        "kernelILi64EEEvPKfS2_S2_Pfiiii") == "window_attn_kernel<64>"
    assert _build._kernel_name(
        "_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_18d893fe16ssd_state_kernel"
        "ILb1ELi8EEEvPKfS2_S2_S2_Pfiiii") == "ssd_state_kernel<1,8>"
    assert _build._kernel_name(
        "_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_18d893fe17ssd_cumsum_"
        "kernelEPKfS1_Pfxii") == "ssd_cumsum_kernel"
    assert _build._kernel_name("not_mangled") == "not_mangled"


# -- popcount -----------------------------------------------------------------

def test_sass_listing_parsed_by_kernel():
    from repro_torch.kernels import _build
    listing = """
\t\tFunction : _ZN12_GLOBAL__N_124packed_domination_kernelILi3EEEvPKfS2_iS2_S2_iiiiPj
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   FSETP.GTU.AND P0, PT, R2, RZ, PT ;      /* 0x000000ff0200720b */
        /*0020*/              @!P0 VOTE.ANY R4, PT, P1 ;                   /* 0x0000000000048806 */
        /*0030*/               @P0 BRA 0x10 ;                              /* 0xffffffd000000947 */
        /*0040*/                   EXIT ;                                  /* 0x000000000000794d */
\t\tFunction : _Z9round_cvtPKfPj
        /*0000*/                   FSETP.NEU.AND P0, PT, R2, R2, PT ;      /* 0x0000000202007a0b */
"""
    got = _build.parse_sass(listing)
    assert list(got) == ["packed_domination_kernel<3>", "_Z9round_cvtPKfPj"]
    assert got["packed_domination_kernel<3>"] == [
        (0x0, "LDC", "R1, c[0x0][0x28]"), (0x10, "FSETP", "P0, PT, R2, RZ, PT"),
        (0x20, "VOTE", "R4, PT, P1"), (0x30, "BRA", "0x10"), (0x40, "EXIT", "")]
    assert got["_Z9round_cvtPKfPj"] == [(0x0, "FSETP", "P0, PT, R2, R2, PT")]


def test_variant_recipes_match_the_shipped_sources_once(monkeypatch):
    """Each ``chip_variants.py`` recipe replaces text that its shipped
    source holds exactly once (that script asserts it on the card)."""
    from pathlib import Path
    from repro_torch.kernels import _build
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_variants
    assert {s for _, s, _ in chip_variants.VARIANTS} >= {
        "pareto_rank.cu", "window_attn.cu", "ssd_scan.cu"}
    for name, _, edits in chip_variants.VARIANTS:
        for f, subs in edits.items():
            text = (_build.CSRC / f).read_text()
            for old, new in subs:
                assert text.count(old) == 1 and old != new, (name, old)


def test_popcount32_matches_numpy_including_bit31():
    rng = np.random.default_rng(0)
    u = np.concatenate([
        rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64),
        np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1, 2 ** 31 + 1,
                  0x80000001, 0xAAAAAAAA, 0x55555555], dtype=np.uint64),
    ]).astype(np.uint32)
    got = ref.popcount32(torch.from_numpy(u.view(np.int32))).numpy()
    want = np.array([bin(int(v)).count("1") for v in u])
    assert (got == want).all()
    assert (got == np.bitwise_count(u)).all()
