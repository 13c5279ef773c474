"""Checkpoints across the two packages on the CPU: the port's ``save`` /
``restore`` / ``latest_step`` round-trip parameters and optimizer state bit
for bit, a checkpoint the port writes (``models.convert.reference_params``:
block leaves stacked again, Dense weights transposed back) loads in
``repro.checkpoint.restore``, and one the reference writes loads in the
port through ``load_reference_params``, with the forwards equal within the
LM tests' 2e-5 on logits of magnitude ~1.5 (float32, summed in other
orders by XLA and by torch), for the dense, ssm, hybrid and moe families
(a moe model's two stacks and DeepSeek-V3's MTP stack); a ``None`` leaf is
an empty subtree in both packages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.cnn.zoo import reduced_cnn as jreduced  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.cnn.zoo import reduced_cnn  # noqa: E402
from repro_torch.models.convert import (load_reference_cnn,  # noqa: E402
                                        load_reference_params,
                                        reference_params)
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.training import train_lib as ttl  # noqa: E402

torch.set_num_threads(2)

ATOL = 2e-5
ARCHS = ("smollm-360m", "mamba2-370m", "zamba2-2.7b", "deepseek-moe-16b",
         "deepseek-v3-671b")


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def trained_port(arch):
    """The reduced ``arch`` after two AdamW steps (a state worth saving)."""
    cfg = registry.get_config(arch).reduced()
    tm = registry.build_model(cfg, device="cpu")
    opt = topt.adamw(1e-3)
    step = ttl.make_train_step(tm, cfg, opt)
    state = opt.init(ttl.init_params(tm))
    for i in range(2):
        state, _ = step(state, make_batch_for(cfg, 2, 16, seed=i))
    return tm, cfg, state


def leaves(tree, prefix=""):
    """(``/``-joined key, leaf) of a tree of dicts and sequences."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}#{i}/")
    else:
        yield prefix[:-1], tree


def tokens(vocab):
    return np.random.default_rng(0).integers(0, vocab, (2, 24)).astype(
        np.int32)


def test_round_trip_is_bit_exact(tmp_path):
    tm, _, state = trained_port("smollm-360m")
    tree = {"params": reference_params(tm), "opt": state,
            "extra": [np.arange(3, dtype=np.int64),
                      torch.full((2,), 1.5, dtype=torch.bfloat16)]}
    assert tckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path), tree)
    f = tckpt.save(str(tmp_path), tree, step=7)
    assert f.endswith("ckpt_00000007.npz") and tckpt.latest_step(
        str(tmp_path)) == 7
    tckpt.save(str(tmp_path), tree, step=3)
    assert tckpt.latest_step(str(tmp_path)) == 7
    back = tckpt.restore(str(tmp_path), tree)
    got, want = dict(leaves(back)), dict(leaves(tree))
    assert set(got) == set(want) and "opt/m/blocks_dense/attn/wq" in got
    with np.load(f) as data:
        assert set(data.files) == set(want)
    for k, b in want.items():
        a = got[k]
        assert type(a) is type(b) and a.dtype == b.dtype, k
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), k
        else:
            np.testing.assert_array_equal(a, b)
    # a fresh model restored from the checkpoint equals the saved one
    fresh = registry.build_model(tm.cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    back = tckpt.restore(str(tmp_path), {"params": reference_params(fresh)},
                         step=7)
    load_reference_params(fresh, {k: v.numpy() for k, v in
                                  back["params"].items()})
    for (n, a), (_, b) in zip(tm.named_parameters(), fresh.named_parameters()):
        assert torch.equal(a, b), n


def test_none_leaf_round_trips_and_crosses(tmp_path):
    """A ``None`` is an empty subtree, as in the reference's
    ``tree_flatten_with_path``: nothing is written for it, and restore gives
    ``None`` back, in the port and in the reference alike."""
    tree = {"s": torch.ones(3), "n": None}
    f = tckpt.save(str(tmp_path), tree, step=1)
    with np.load(f) as data:
        assert data.files == ["s"]
    back = tckpt.restore(str(tmp_path), tree, step=1)
    assert back["n"] is None and torch.equal(back["s"], tree["s"])
    jback = jckpt.restore(str(tmp_path), {"s": jnp.zeros(3), "n": None},
                          step=1)
    assert jback["n"] is None
    np.testing.assert_array_equal(np.asarray(jback["s"]), np.ones(3))
    jckpt.save(str(tmp_path), {"s": jnp.full((3,), 2.0), "n": None}, step=2)
    back = tckpt.restore(str(tmp_path), tree, step=2)
    assert back["n"] is None and torch.equal(back["s"], torch.full((3,), 2.0))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_loads_in_the_reference(tmp_path, arch):
    """Parameters and AdamW state written by the port restore into the
    reference's own pytrees (keys and shapes are the reference's), and the
    reference's forward on them equals the port's."""
    tm, cfg, state = trained_port(arch)
    tckpt.save(str(tmp_path), {"params": reference_params(tm), "opt": state},
               step=2)
    jcfg = jreg.get_config(arch).reduced()
    jm = jreg.build_model(jcfg)
    like, _ = jm.init(jax.random.PRNGKey(1))
    jo = jopt.adamw(1e-3)
    back = jckpt.restore(str(tmp_path), {"params": like,
                                         "opt": jo.init(like)})
    assert int(back["opt"]["step"]) == 2
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(back["opt"]["m"])[0]),
        state["m"][sorted(state["m"])[0]].numpy())
    toks = tokens(cfg.vocab)
    want = np.asarray(jm.apply(back["params"], {}, {"tokens": jnp.asarray(
        toks)})[0])
    with torch.no_grad():
        got = tm({"tokens": torch.from_numpy(toks)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_loads_in_the_port(tmp_path, arch):
    jcfg = jreg.get_config(arch).reduced()
    jm = jreg.build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(2))
    jckpt.save(str(tmp_path), params, step=11)
    tm = registry.build_model(dataclasses.replace(
        registry.get_config(arch).reduced()), device="cpu")
    flat = tckpt.restore(str(tmp_path), {k: v.numpy() for k, v in
                                         reference_params(tm).items()})
    load_reference_params(tm, flat)
    toks = tokens(jcfg.vocab)
    want = np.asarray(jm.apply(params, {}, {"tokens": jnp.asarray(toks)})[0])
    with torch.no_grad():
        got = tm({"tokens": torch.from_numpy(toks)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert flat_params(params).keys() == flat.keys()


def test_cnn_parameters_cross_with_dense_weights_transposed(tmp_path):
    """A CNN's Dense weight is (out, in) in the port and (in, out) in the
    reference: ``reference_params`` transposes it back, so the reference
    restores the port's parameters into its own tree unchanged."""
    like, state = jax.eval_shape(jreduced("vgg16").init,
                                 jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(lambda a: np.ones(a.shape, a.dtype), state)
    tm = reduced_cnn("vgg16").init_weights(torch.Generator().manual_seed(3),
                                           device="cpu")
    ref = reference_params(tm)
    assert ref["cls/fc0/w"].shape == like["cls"]["fc0"]["w"].shape
    tckpt.save(str(tmp_path), ref, step=1)
    back = jckpt.restore(str(tmp_path), like)
    fresh = reduced_cnn("vgg16").init_weights(device="cpu")
    load_reference_cnn(fresh, back, state)
    for (n, a), (_, b) in zip(tm.named_parameters(), fresh.named_parameters()):
        assert torch.equal(a, b), n
