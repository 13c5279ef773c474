"""The port's audio (musicgen-large) and vlm (qwen2-vl-7b) families against
the JAX package on the CPU, on the same weights (the reference's pytree
carried over by ``repro_torch.models.convert``) and the same numpy inputs:
M-RoPE (``apply_mrope``, ``GQAAttention``'s ``sdpa`` and cache branches,
whose masks read the temporal ids), the reduced models' forwards (port
``"auto"`` — the window kernel's plain version — against the reference's
Pallas kernel in interpret mode, and ``"ref"`` against ``"ref"``), decode
steps, the partitioned runner (float and quantized), train steps,
checkpoints both ways and the train launcher.

The vlm model is qwen2-vl-7b reduced (2 layers, d 256, 4 heads over 2 KV
heads, M-RoPE sections (8, 12, 12)) with ``window=128`` and 256 positions
(16 vision patches + 240 tokens): at the reduced window of 64 the
reference's dispatch falls back to its plain version and the Pallas kernel
never runs.  Vision positions are Qwen2-VL's grid (t = 0, h = row, w =
col of a 4 x 4 grid, text from 4 on all three axes), so the three axes
differ.  Tolerance of float results: 2e-5 absolute (float32, summed in
other orders by XLA and by torch), as ``tests/test_torch_lm.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core.quant import QuantSpec as JQuantSpec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn import attention as ja  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.serving import pipeline as jpipeline  # noqa: E402
from repro.training import train_lib as jtl  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_params)
from repro_torch.nn import attention as ta  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.serving import PartitionedLMRunner  # noqa: E402
from repro_torch.training import train_lib as ttl  # noqa: E402

torch.set_num_threads(2)

ATOL = 2e-5
VLM, AUDIO = "qwen2-vl-7b", "musicgen-large"
SIDE = 4                      # the reduced config's 16 patches as 4 x 4
T = 256                       # the vlm's positions: 16 patches + 240 tokens
LOSS_REL, PARAM_TOL = 1e-5, 1e-5


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=atol,
                               atol=atol)


def reduced(get_config, arch, **replace):
    cfg = get_config(arch).reduced()
    if arch == VLM:
        replace.setdefault("window", 128)
    return dataclasses.replace(cfg, **replace)


def pair(arch, seed=0, **replace):
    """(reference model, its params, port model on the same weights)."""
    jm = jreg.build_model(reduced(jreg.get_config, arch, **replace))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = registry.build_model(reduced(registry.get_config, arch, **replace),
                              device="cpu")
    load_reference_params(tm, flat_params(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def vlm():
    return pair(VLM)


@pytest.fixture(scope="module")
def audio():
    return pair(AUDIO)


def grid_positions(b, side, n_text):
    """Qwen2-VL's M-RoPE ids of ``side * side`` patches then ``n_text``
    tokens: (3, b, side**2 + n_text) int32."""
    rows, cols = np.divmod(np.arange(side * side), side)
    text = side + np.arange(n_text)
    pos = np.stack([np.concatenate([np.zeros(side * side, int), text]),
                    np.concatenate([rows, text]),
                    np.concatenate([cols, text])])
    return np.ascontiguousarray(np.broadcast_to(
        pos[:, None], (3, b, pos.shape[1]))).astype(np.int32)


def vlm_batch(cfg, b, n_text, seed=0, side=SIDE):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, n_text)).astype(
                np.int32),
            "vision_embeds": rng.standard_normal(
                (b, side * side, cfg.d_model)).astype(np.float32),
            "positions3": grid_positions(b, side, n_text)}


def audio_batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    return {"codes": rng.integers(0, cfg.vocab, (b, cfg.n_codebooks, t))
            .astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# -- M-RoPE ------------------------------------------------------------------

@pytest.mark.parametrize("sections,hd", [((8, 12, 12), 64),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_reference(sections, hd):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos = grid_positions(2, 5, 15)
    pos[:, 1] += 7                          # a second row at other ids
    got = ta.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                         sections, 1e6)
    want = ja.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    close(got, want, 1e-5)
    # the three axes differ, so M-RoPE is not RoPE of any one of them
    for axis in range(3):
        rope = ta.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[axis]),
                             1e6)
        assert float((rope - got).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="sum"):
        ta.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (8, 8, 8))


def attn_pair(window, hd=64, seed=3):
    """A reference and a port ``GQAAttention`` with M-RoPE on the same
    weights (qkv biases drawn, so they matter)."""
    sections = (8, 12, 12) if hd == 64 else (16, 24, 24)
    kw = dict(qkv_bias=True, window=window, rope_theta=1e6,
              mrope_sections=sections)
    jattn = ja.GQAAttention(128, 4, 2, hd, **kw)
    params, _ = jattn.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(
        np.float32) * 0.1) if k.startswith("b") else v)
        for k, v in params.items()}
    tattn = ta.GQAAttention(128, 4, 2, hd, **kw, device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(tattn, k).copy_(torch.from_numpy(np.array(v)))
    return jattn, params, tattn


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_gqa_mrope_sdpa_branch_masks_by_temporal_ids(window, hd):
    """The ``sdpa`` branch (t < 2048, no cache) masks by ``positions[0]``:
    the 16 patches share t = 0 and see each other."""
    jattn, params, tattn = attn_pair(window, hd)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 36, 128)).astype(np.float32)
    pos = grid_positions(2, 4, 20)
    want, _ = jattn.apply(params, {}, jnp.asarray(x),
                          positions=jnp.asarray(pos))
    got, cache = tattn(torch.from_numpy(x), positions=torch.from_numpy(pos))
    assert cache is None
    close(got, want)
    # by the row index instead, the patches would not see later patches
    by_row, _ = tattn(torch.from_numpy(x), positions=torch.from_numpy(
        np.broadcast_to(np.arange(36), (3, 2, 36)).copy()))
    assert float((by_row - got).abs().max()) > 1e-3
    with pytest.raises(ValueError, match=r"\(3, B, T\)"):
        tattn(torch.from_numpy(x), positions=torch.from_numpy(pos[0]))


@pytest.mark.parametrize("window", [None, 24])
def test_gqa_mrope_cache_branch_masks_by_temporal_ids(window):
    """A prefill into a cache, then two decode steps: the cached mask
    compares slot positions with ``positions[0]``, as the reference's."""
    jattn, params, tattn = attn_pair(window)
    rng = np.random.default_rng(5)
    jc = ja.init_cache(2, 2, 40, 64, dtype=jnp.float32)
    tc = ta.init_cache(2, 2, 40, 64, dtype=torch.float32)
    pos = grid_positions(2, 4, 22)
    for sl in (slice(0, 36), slice(36, 37), slice(37, 38)):
        x = rng.standard_normal((2, sl.stop - sl.start, 128)).astype(
            np.float32)
        want, jc = jattn.apply(params, {}, jnp.asarray(x),
                               positions=jnp.asarray(pos[:, :, sl]),
                               cache=jc)
        got, tc = tattn(torch.from_numpy(x),
                        positions=torch.from_numpy(pos[:, :, sl]), cache=tc)
        close(got, want)
        for name in ("k", "v", "pos"):
            close(tc[name], jc[name])


# -- the reduced models -------------------------------------------------------

def test_models_match_reference_parameters(vlm, audio):
    """Embedding rows and head columns are ``vocab * n_codebooks``; the vlm
    model has ``vis_proj`` (D, D); every leaf loads."""
    for jm, params, tm in (vlm, audio):
        cfg = tm.cfg
        rows = cfg.vocab * max(cfg.n_codebooks, 1)
        assert tm.embed.shape == (rows, cfg.d_model)
        assert tm.head.shape == (cfg.d_model, rows)
        assert hasattr(tm, "vis_proj") == (cfg.family == "vlm")
        got = reference_params(tm)
        want = flat_params(params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("ref", "ref")])
@pytest.mark.parametrize("vision", [True, False])
def test_vlm_forward_matches_reference(vlm, jimpl, timpl, vision):
    jm, params, tm = vlm
    if vision:
        b = vlm_batch(tm.cfg, 2, T - SIDE * SIDE, seed=6)
    else:
        b = {"tokens": np.random.default_rng(6).integers(
            0, tm.cfg.vocab, (2, T)).astype(np.int32)}
    want, _ = jm.apply(params, {}, jbatch(b), impl=jimpl)
    got = tm(tbatch(b), impl=timpl)
    assert got.shape == (2, T, tm.cfg.vocab) and torch.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("ref", "ref")])
def test_vlm_forward_at_head_dim_128_matches_reference(jimpl, timpl):
    """qwen2-vl-7b's own head dim, 3584 / 28 = 128, with its sections."""
    jm, params, tm = pair(VLM, seed=1, head_dim=128,
                          mrope_sections=(16, 24, 24))
    assert tm.blocks[0].attn.hd == 128
    b = vlm_batch(tm.cfg, 2, T - SIDE * SIDE, seed=7)
    want, _ = jm.apply(params, {}, jbatch(b), impl=jimpl)
    close(tm(tbatch(b), impl=timpl), want)


def test_audio_forward_matches_reference(audio):
    jm, params, tm = audio
    b = audio_batch(tm.cfg, 2, 48, seed=8)
    want, _ = jm.apply(params, {}, jbatch(b))
    got = tm(tbatch(b))
    assert got.shape == (2, 48, tm.cfg.n_codebooks, tm.cfg.vocab)
    close(got, want)
    # each codebook's rows of the table are its own
    one = dict(b, codes=b["codes"].copy())
    one["codes"][:, 3] = (one["codes"][:, 3] + 1) % tm.cfg.vocab
    assert float((tm(tbatch(one)) - got).abs().max()) > 1e-3


def test_audio_decode_step_matches_reference(audio):
    """Prefill 20 frames of codes, then three frames one at a time."""
    jm, params, tm = audio
    codes = audio_batch(tm.cfg, 3, 23, seed=9)["codes"]
    jc = jm.init_caches(3, 32, jnp.float32)
    tc = tm.init_caches(3, 32, torch.float32)
    for sl in (slice(0, 20), slice(20, 21), slice(21, 22), slice(22, 23)):
        want, jc = jm.decode_step(params, jc, {"codes": jnp.asarray(
            codes[:, :, sl])})
        got, tc = tm.decode_step(tc, {"codes": torch.from_numpy(
            codes[:, :, sl])})
        assert got.shape == (3, sl.stop - sl.start, 4, tm.cfg.vocab)
        close(got, want)
    close(tc["dense"]["k"], jc["dense"]["k"])
    assert (tc["dense"]["pos"].numpy() == 23).all()
    close(got[:, -1], tm({"codes": torch.from_numpy(codes)})[:, -1])


def test_vlm_decode_step_after_a_vision_prefill_matches_reference(vlm):
    """A prefill of 16 patches + 8 tokens at grid positions, then text
    tokens: one with its M-RoPE ids given, two at the cache's write
    position (stacked x3), as the reference's ``decode_step`` takes it."""
    jm, params, tm = vlm
    b = vlm_batch(tm.cfg, 2, 8, seed=10)
    jc = jm.init_caches(2, 64, jnp.float32)
    tc = tm.init_caches(2, 64, torch.float32)
    want, jc = jm.decode_step(params, jc, jbatch(b))
    got, tc = tm.decode_step(tc, tbatch(b))
    close(got, want)
    # the cached mask compares slot indices with the temporal ids, the
    # forward's compares temporal ids with each other: at grid positions
    # the prefill is not the forward, in the reference as here
    assert float((got - tm(tbatch(b))).abs().max()) > 1e-3
    rng = np.random.default_rng(11)
    steps = [{"tokens": rng.integers(0, 512, (2, 1)).astype(np.int32),
              "positions3": np.full((3, 2, 1), SIDE + 8, np.int32)}]
    steps += [{"tokens": rng.integers(0, 512, (2, 1)).astype(np.int32)}
              for _ in range(2)]
    for s in steps:
        want, jc = jm.decode_step(params, jc, jbatch(s))
        got, tc = tm.decode_step(tc, tbatch(s))
        close(got, want)
    assert (tc["dense"]["pos"].numpy() == 27).all()
    close(tc["dense"]["v"], jc["dense"]["v"])


# -- the partitioned runner ---------------------------------------------------

def runner_batch(tm, seed):
    if tm.cfg.family == "audio":
        return audio_batch(tm.cfg, 2, 40, seed)
    return vlm_batch(tm.cfg, 2, 48, seed)


@pytest.mark.parametrize("family", ["vlm", "audio"])
@pytest.mark.parametrize("cuts", [[0], []])
def test_partitioned_runner_matches_reference(vlm, audio, family, cuts):
    jm, params, tm = vlm if family == "vlm" else audio
    b = runner_batch(tm, seed=12)
    runner = PartitionedLMRunner(tm, cuts)
    got, rep = runner.forward(tbatch(b))
    want, jrep = jpipeline.PartitionedLMRunner(jm, params, cuts).forward(
        jbatch(b))
    close(got, want)
    assert torch.equal(got, tm(tbatch(b)))
    assert rep.link_bytes == jrep.link_bytes
    with pytest.raises(NotImplementedError, match="dense"):
        runner.stage_step_fn(0)


# quantized stages: the weights (biases and norm scales of the stacked
# leaves too) are the reference's bit for bit, so with float links the
# logits differ by summation order only (2e-5); as tests/test_torch_lm.py
@pytest.mark.parametrize("family", ["vlm", "audio"])
@pytest.mark.parametrize("bits,per_channel", [((16, 8), False),
                                              ((4, 8), True)])
def test_quantized_runner_matches_reference(vlm, audio, family, bits,
                                            per_channel):
    jm, params, tm = vlm if family == "vlm" else audio
    b = runner_batch(tm, seed=13)
    specs = [QuantSpec(x, per_channel=per_channel) for x in bits]
    jspecs = [JQuantSpec(x, per_channel=per_channel) for x in bits]
    jr = jpipeline.PartitionedLMRunner(jm, params, [0], jspecs)
    want, _ = jr.forward(jbatch(b))
    runner = PartitionedLMRunner(tm, [0], specs)
    got, _ = runner.forward(tbatch(b))
    close(got, want)
    with torch.no_grad():
        mono = tm(tbatch(b))
    assert float((got - mono).abs().max()) > 1e-3 * float(mono.abs().max())
    for si in range(runner.n_stages):
        jw, tw = jr.stage_weights(si), runner.stage_weights(si)
        jb = flat_params(jw["blocks"])
        if family == "vlm":
            assert "attn/bq" in jb
        for key, leaf in jb.items():
            name = key.replace("/", ".")
            stacked = torch.stack([blk.params[name] for blk in tw["blocks"]])
            np.testing.assert_array_equal(stacked.numpy(), leaf, err_msg=key)


# -- training -----------------------------------------------------------------

def train_batch(arch, b, t, seed=0):
    cfg = reduced(registry.get_config, arch)
    return make_batch_for(cfg, b, t, seed=seed)


def run_ref(arch, opt, batch, **kw):
    jm = jreg.build_model(reduced(jreg.get_config, arch))
    params, state = jm.init(jax.random.PRNGKey(0))
    step = jax.jit(jtl.make_train_step(jm, jm.cfg, opt, **kw))
    params, _, _, m = step(params, opt.init(params), state, jbatch(batch))
    return params, float(m["loss"])


def run_port(arch, opt, batch, **kw):
    _, _, tm = pair(arch)
    step = ttl.make_train_step(tm, tm.cfg, opt, **kw)
    _, m = step(opt.init(ttl.init_params(tm)), batch)
    return tm, float(m["loss"])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_one_sgd_step_matches_reference(arch):
    """SGD, momentum 0, no clip: the loss within 1e-5 (relative) and every
    leaf within 1e-5, as ``tests/test_torch_train.py``; the vlm batch
    carries vision embeddings and labels masked over the patches."""
    batch = train_batch(arch, 4, 32)
    jp, jl = run_ref(arch, jopt.sgd(0.1, momentum=0.0), batch,
                     clip_norm=None)
    tm, tl = run_port(arch, topt.sgd(0.1, momentum=0.0), batch,
                      clip_norm=None)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    got, want = reference_params(tm), flat_params(jp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)


def test_vlm_grad_accum_matches_one_batch_and_reference():
    """Four microbatches (``positions3`` split on its batch axis 1) against
    the reference's four, and against the port's one batch within the
    reference's bound for this model, 1e-4 (tests/test_grad_accum.py)."""
    batch = train_batch(VLM, 8, 16)
    sgd = dict(clip_norm=None)
    jp, jl = run_ref(VLM, jopt.sgd(0.1, momentum=0.0), batch, grad_accum=4,
                     **sgd)
    four, tl = run_port(VLM, topt.sgd(0.1, momentum=0.0), batch,
                        grad_accum=4, **sgd)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    a, want = reference_params(four), flat_params(jp)
    for k in want:
        np.testing.assert_allclose(a[k].numpy(), want[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
    one, _ = run_port(VLM, topt.sgd(0.1, momentum=0.0), batch, **sgd)
    b = reference_params(one)
    assert max(float((a[k] - b[k]).abs().max()) for k in a) < 1e-4


# -- checkpoints and the launcher ---------------------------------------------

def forward_batch(cfg, seed=0):
    if cfg.family == "audio":
        return audio_batch(cfg, 2, 24, seed)
    return vlm_batch(cfg, 2, 24, seed)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_checkpoints_cross_both_ways(tmp_path, arch):
    """Two AdamW steps in the port, saved, restored into the reference's
    pytrees (the optimizer state too) and forwarded there; then the
    reference's own checkpoint loaded into a fresh port model."""
    cfg = reduced(registry.get_config, arch)
    tm = registry.build_model(cfg, device="cpu")
    opt = topt.adamw(1e-3)
    step = ttl.make_train_step(tm, cfg, opt)
    state = opt.init(ttl.init_params(tm))
    for i in range(2):
        state, _ = step(state, make_batch_for(cfg, 2, 16, seed=i))
    tckpt.save(str(tmp_path / "port"), {"params": reference_params(tm),
                                        "opt": state}, step=2)
    jm = jreg.build_model(reduced(jreg.get_config, arch))
    like, _ = jm.init(jax.random.PRNGKey(1))
    back = jckpt.restore(str(tmp_path / "port"),
                         {"params": like, "opt": jopt.adamw(1e-3).init(like)})
    assert int(back["opt"]["step"]) == 2
    b = forward_batch(cfg, seed=14)
    with torch.no_grad():
        got = tm(tbatch(b))
    close(got, jm.apply(back["params"], {}, jbatch(b))[0])

    params, _ = jm.init(jax.random.PRNGKey(2))
    jckpt.save(str(tmp_path / "ref"), params, step=11)
    fresh = registry.build_model(cfg, device="cpu")
    flat = tckpt.restore(str(tmp_path / "ref"), {
        k: v.numpy() for k, v in reference_params(fresh).items()})
    assert flat.keys() == flat_params(params).keys()
    load_reference_params(fresh, flat)
    with torch.no_grad():
        got = fresh(tbatch(b))
    close(got, jm.apply(params, {}, jbatch(b))[0])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_launcher_runs_both_families(tmp_path, capsys, arch):
    out = ttrain.run(["--arch", arch, "--reduced", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--ckpt", str(tmp_path)])
    assert f"[train] {arch} (reduced)" in capsys.readouterr().out
    assert len(out.metrics) == 3
    assert all(np.isfinite(float(m["loss"])) for m in out.metrics)
    assert out.ckpt == str(tmp_path / "ckpt_00000003.npz")
