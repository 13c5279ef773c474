"""The port's training side against the JAX package on the CPU, on the same
weights (the reference's pytree carried over by ``repro_torch.models.convert``)
and the same numpy batches: ``cross_entropy`` and ``lm_loss``'s branches,
one SGD step and a 3-step AdamW loss trajectory of reduced smollm-360m and
mamba2-370m, one SGD step of the hybrid zamba2-2.7b, gradient accumulation, remat, BatchNorm in training mode, the
classifier train step of three reduced CNNs, QAT, the ``cnn_fakequant``
oracle and both launchers in-process (the serve path recording no autograd
graph after its warm training).  The classifier train steps of the reduced
CNNs and QAT are ``tests/test_torch_train_cnn.py``.

Tolerances: LM losses 1e-5 (relative; float32, summed in other orders by
XLA and by torch) and parameters after one SGD step 1e-5 absolute (the
port's differences measured at <= 1.2e-7).  AdamW is compared by loss
only: after its first step ``m / sqrt(v) = g / |g|``, so a gradient that
is 0 up to rounding flips sign and a parameter can move 2 x lr apart
(measured 5.5e-5 at lr 1e-3), while the losses agree within 1e-4.
BatchNorm in training mode: output within 1e-5, running statistics within
1e-6."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data.synthetic import SyntheticImages as JImages  # noqa: E402
from repro.data.synthetic import batch_iterator as jbatch_iterator  # noqa: E402
from repro.data.synthetic import make_batch_for as jmake_batch  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.nn.layers import BatchNorm2d as JBatchNorm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.training import train_lib as jtl  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.partition import Platform, SystemConfig  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.data.synthetic import (SyntheticImages,  # noqa: E402
                                        batch_iterator, make_batch_for)
from repro_torch.explore import AccuracySpec  # noqa: E402
from repro_torch.core.hwmodel.arch import EYERISS_LIKE, SIMBA_LIKE  # noqa: E402
from repro_torch.core.link import get_link  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.cnn.zoo import reduced_cnn  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_params)
from repro_torch.nn.layers import BatchNorm2d  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.quantize.evaluate import cnn_measured_accuracy  # noqa: E402
from repro_torch.serving import (GenerationEngine,  # noqa: E402
                                 PartitionedLMRunner)
from repro_torch.serving.engine import SlotDecoder  # noqa: E402
from repro_torch.training import train_lib as ttl  # noqa: E402

torch.set_num_threads(2)

LOSS_REL, PARAM_TOL = 1e-5, 1e-5


def flat_params(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in leaves}


def params_close(model, jparams, atol):
    got, want = reference_params(model), flat_params(jparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# -- losses -----------------------------------------------------------------------

def test_cross_entropy_masks_ignored_labels():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = ttl.IGNORE
    labels[2, 4] = ttl.IGNORE
    want = float(jtl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(ttl.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels)))
    assert ttl.IGNORE == jtl.IGNORE == -100
    np.testing.assert_allclose(got, want, rtol=1e-6)
    everything = np.full_like(labels, ttl.IGNORE)      # no label: 0, not NaN
    assert float(ttl.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(everything))) == 0.0


@pytest.mark.parametrize("family,aux_keys", [
    ("dense", ()), ("moe", ("lb_loss",)), ("dense", ("mtp_logits",)),
    ("moe", ("lb_loss", "mtp_logits")), ("audio", ())])
def test_lm_loss_branches(family, aux_keys):
    """The balance/z-loss and MTP terms on a synthetic ``aux`` (the moe
    models' own are held in ``tests/test_torch_moe.py`` and
    ``tests/test_torch_mla.py``), and the audio family's (B, K, T)
    labels."""
    rng = np.random.default_rng(1)
    b, t, v, k = 2, 6, 13, 3
    shape = (b, t, k, v) if family == "audio" else (b, t, v)
    logits = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, v, (b, k, t) if family == "audio" else (b, t))
    labels = labels.astype(np.int32)
    aux = {}
    if "lb_loss" in aux_keys:
        aux.update(lb_loss=np.float32(1.7), z_loss=np.float32(3.1),
                   dropped=np.float32(0.25))
    if "mtp_logits" in aux_keys:
        aux["mtp_logits"] = rng.normal(size=(b, t, v)).astype(np.float32)
    jt, jm = jtl.lm_loss(JModelConfig(arch_id="x", family=family, n_layers=1,
                                      d_model=4, vocab=v), jnp.asarray(
        logits), {"labels": jnp.asarray(labels)},
        {k2: jnp.asarray(v2) for k2, v2 in aux.items()})
    tt, tm = ttl.lm_loss(ModelConfig(arch_id="x", family=family, n_layers=1,
                                     d_model=4, vocab=v),
                         torch.from_numpy(logits),
                         {"labels": torch.from_numpy(labels)},
                         {k2: torch.as_tensor(v2) for k2, v2 in aux.items()})
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)


# -- LM train steps ----------------------------------------------------------------

_LMS = {}


def lm(arch, remat=False):
    """(reference model, config, params, state) of the reduced ``arch``
    (whose config turns ``remat`` off) with ``remat`` set."""
    if (arch, remat) not in _LMS:
        jcfg = dataclasses.replace(jreg.get_config(arch).reduced(),
                                   remat=remat)
        jm = jreg.build_model(jcfg)
        params, state = jm.init(jax.random.PRNGKey(0))
        _LMS[arch, remat] = (jm, jcfg, params, state)
    return _LMS[arch, remat]


def port_lm(arch, **replace):
    """The port's reduced ``arch`` on the reference's weights."""
    cfg = dataclasses.replace(registry.get_config(arch).reduced(), **replace)
    tm = registry.build_model(cfg, device="cpu")
    load_reference_params(tm, flat_params(lm(arch)[2]))
    return tm, cfg


def run_ref(arch, opt, batches, remat=False, **kw):
    jm, jcfg, params, state = lm(arch, remat)
    step = jax.jit(jtl.make_train_step(jm, jcfg, opt, **kw))
    opt_state, losses = opt.init(params), []
    for b in batches:
        params, opt_state, state, m = step(params, opt_state, state, jbatch(b))
        losses.append(float(m["loss"]))
    return params, losses


def run_port(tm, cfg, opt, batches, **kw):
    step = ttl.make_train_step(tm, cfg, opt, **kw)
    opt_state, losses = opt.init(ttl.init_params(tm)), []
    for b in batches:
        opt_state, m = step(opt_state, b)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
@pytest.mark.parametrize("remat", [False, True])
def test_one_sgd_step_matches_reference(arch, remat):
    """SGD, momentum 0, no clip: loss within 1e-5, parameters within 1e-5
    (measured <= 1.2e-7), with the blocks checkpointed (the full-size
    configs' ``remat``) on both sides and not."""
    cfg = lm(arch, remat)[1]
    batches = [make_batch_for(cfg, 4, 32, seed=0)]
    jp, jl = run_ref(arch, jopt.sgd(0.1, momentum=0.0), batches,
                     remat=remat, clip_norm=None)
    tm, tcfg = port_lm(arch, remat=remat)
    tl = run_port(tm, tcfg, topt.sgd(0.1, momentum=0.0), batches,
                  clip_norm=None)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    params_close(tm, jp, PARAM_TOL)


def test_hybrid_sgd_step_matches_reference():
    """The hybrid (reduced zamba2-2.7b: six Mamba2 blocks and the shared
    attention block) on the reference's weights: one SGD step gives the
    reference's loss and every leaf within 1.3e-7, as measured when the
    port's hybrid training was first held to the reference."""
    arch = "zamba2-2.7b"
    cfg = lm(arch)[1]
    batches = [make_batch_for(cfg, 4, 32, seed=0)]
    jp, jl = run_ref(arch, jopt.sgd(0.1, momentum=0.0), batches,
                     clip_norm=None)
    tm, tcfg = port_lm(arch)
    tl = run_port(tm, tcfg, topt.sgd(0.1, momentum=0.0), batches,
                  clip_norm=None)
    assert tl == jl
    got, want = reference_params(tm), flat_params(jp)
    assert set(got) == set(want) and len(want) == 21
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1.3e-7, err_msg=k)


def test_adamw_loss_trajectory_matches_reference():
    arch = "smollm-360m"
    batches = [make_batch_for(lm(arch)[1], 4, 32, seed=i) for i in range(3)]
    _, jl = run_ref(arch, jopt.adamw(1e-3), batches)
    tm, tcfg = port_lm(arch)
    tl = run_port(tm, tcfg, topt.adamw(1e-3), batches)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl[0] != tl[1]


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_grad_accum_matches_reference(arch):
    """Four microbatches against the reference's four (tests/
    test_grad_accum.py's setting), and against the port's single batch
    within that test's 1e-4."""
    cfg = lm(arch)[1]
    batches = [make_batch_for(cfg, 8, 16, seed=0)]
    jp, jl = run_ref(arch, jopt.sgd(0.1, momentum=0.0), batches,
                     clip_norm=None, grad_accum=4)
    tm, tcfg = port_lm(arch)
    tl = run_port(tm, tcfg, topt.sgd(0.1, momentum=0.0), batches,
                  clip_norm=None, grad_accum=4)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL)
    params_close(tm, jp, PARAM_TOL)
    one, _ = port_lm(arch)
    run_port(one, tcfg, topt.sgd(0.1, momentum=0.0), batches, clip_norm=None)
    a, b = reference_params(tm), reference_params(one)
    assert max(float((a[k] - b[k]).abs().max()) for k in a) < 1e-4


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b"])
def test_remat_on_equals_off(arch):
    """Checkpointed blocks recompute the same forward: one SGD step gives
    the same loss and parameters bit for bit on the CPU."""
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                                  remat=remat)
        tm = registry.build_model(cfg, device="cpu")
        loss = run_port(tm, cfg, topt.sgd(0.1, momentum=0.0),
                        [make_batch_for(cfg, 2, 16, seed=3)], clip_norm=None)
        out.append((loss, reference_params(tm)))
    (la, pa), (lb, pb) = out
    assert la == lb
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_train_step_reads_nothing_back_and_keeps_metrics_on_device():
    tm, cfg = port_lm("smollm-360m")
    step = ttl.make_train_step(tm, cfg, topt.adamw(1e-3))
    state, m = step(topt.adamw(1e-3).init(ttl.init_params(tm)),
                    make_batch_for(cfg, 2, 16))
    assert set(m) == {"ce", "loss", "grad_norm"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               and v.grad_fn is None for v in m.values())
    assert all(p.grad is None and p.requires_grad for p in tm.parameters())
    assert int(state["step"]) == 1


# -- BatchNorm and the CNN classifier step -----------------------------------------

def test_batchnorm_training_follows_the_reference_rule():
    """Biased batch variance, running statistics 0.9 * old + 0.1 * batch
    (biased too); eval mode unchanged.  Output within 1e-5, statistics
    within 1e-6."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(6, 5, 4, 3)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
         "bias": rng.normal(size=5).astype(np.float32)}
    s = {"mean": rng.normal(size=5).astype(np.float32),
         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    jy, js = JBatchNorm(5).apply({k: jnp.asarray(v) for k, v in p.items()},
                                 {k: jnp.asarray(v) for k, v in s.items()},
                                 jnp.asarray(x), train=True)
    bn = BatchNorm2d(5)
    bn.to_empty(device="cpu")
    with torch.no_grad():
        for k, v in {**p, **s}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    y = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(js[k]),
                                   rtol=0, atol=1e-6)
    biased = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.var.numpy(), 0.9 * s["var"] + 0.1 * biased,
                               rtol=1e-6)
    before = bn.mean.clone()
    jy, _ = JBatchNorm(5).apply({k: jnp.asarray(v) for k, v in p.items()},
                                {"mean": jnp.asarray(before.numpy()),
                                 "var": jnp.asarray(bn.var.numpy())},
                                jnp.asarray(x), train=False)
    y = bn.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    assert torch.equal(bn.mean, before)


def test_cnn_fakequant_oracle_trains_and_caches():
    """The registered ``cnn_fakequant`` oracle at ``w`` 0.25, 3 steps, eval
    set 16, through the declarative spec on the device it is built for:
    scores in [0, 1], cached, and those of the model it carries."""
    graph_model = reduced_cnn("efficientnet_b0")
    graph = graph_model.to_graph()
    schedule = linearize(graph)
    system = SystemConfig([Platform("A", EYERISS_LIKE, QuantSpec(bits=16)),
                           Platform("B", SIMBA_LIKE, QuantSpec(bits=8))],
                          [get_link("eth10")])
    acc = AccuracySpec(kind="measured", measure="cnn_fakequant", options=dict(
        name="efficientnet_b0", in_hw=32, w=0.25, n_classes=10, steps=3,
        eval_size=16)).build(graph, schedule, system, device="cpu")
    n = len(schedule)
    cuts = ((-1,), (5,), (n // 2,), (n - 2,))
    scores = [acc(c) for c in cuts]
    assert all(0.0 <= a <= 1.0 for a in scores)
    assert all(a * 16 == int(a * 16) for a in scores)
    assert acc((5,)) == scores[1] and len(acc._cache) == 4
    model, ds = acc.measure.model, acc.measure.dataset
    assert model.device == torch.device("cpu")
    vx, vy = ds.eval_set(16)
    fresh = cnn_measured_accuracy(model, schedule, vx, vy,
                                  [p.quant for p in system.platforms])
    assert [fresh(c) for c in cuts] == scores


def test_make_batch_for_and_iterator_are_the_reference_copies():
    for arch in ("smollm-360m", "qwen2-vl-7b", "musicgen-large"):
        jcfg, tcfg = jreg.get_config(arch).reduced(), registry.get_config(
            arch).reduced()
        want, got = jmake_batch(jcfg, 3, 9, seed=4), make_batch_for(tcfg, 3,
                                                                    9, seed=4)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    a, b = jbatch_iterator(JImages(), 4, start_seed=3), batch_iterator(
        SyntheticImages(), 4, start_seed=3)
    for _ in range(2):
        (xa, ya), (xb, yb) = next(a), next(b)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# -- the launchers -------------------------------------------------------------------

def test_train_launcher_in_process(tmp_path, capsys):
    out = ttrain.run(["--arch", "smollm-360m", "--reduced", "--steps", "4",
                      "--batch", "2", "--seq", "16", "--log-every", "2",
                      "--device", "cpu", "--ckpt", str(tmp_path)])
    log = capsys.readouterr().out
    assert "[train] smollm-360m (reduced)" in log and "step     4" in log
    assert out.ckpt == str(tmp_path / "ckpt_00000004.npz")
    assert len(out.metrics) == 4
    assert all(np.isfinite(float(m["loss"])) for m in out.metrics)
    assert ttrain.main(["--reduced", "--steps", "1", "--batch", "1",
                        "--seq", "8", "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            ttrain.main(["--reduced", "--steps", "1"])
        else:
            raise RuntimeError("no CUDA device (a card is present)")


def test_serve_launcher_in_process_serves_without_autograd(capsys):
    """The serve launcher warm-trains, searches and serves on the CPU; the
    trained model's parameters take gradients, yet nothing the serve path
    returns carries an autograd graph."""
    out = tserve.run(["--device", "cpu", "--warm-steps", "2", "--requests",
                      "4", "--prompt-len", "6", "--max-new", "3"])
    log = capsys.readouterr().out
    assert "[serve] warm-trained smollm-360m reduced" in log
    assert not out.dropped and np.isfinite(out.warm_loss)
    tokens = [{r.rid: r.tokens for r in rep.records}
              for rep in (out.async_report, out.serial_report)]
    assert tokens[0] == tokens[1] and all(len(t) == 3
                                          for t in tokens[0].values())
    model = out.model
    assert all(p.requires_grad for p in model.parameters())
    prompts = np.arange(12).reshape(2, 6)
    logits, caches = GenerationEngine(model, max_seq=16).prefill(prompts)
    runner = PartitionedLMRunner(model, out.cuts)
    piped, _ = runner.forward({"tokens": torch.from_numpy(prompts)})
    fn = runner.stage_step_fn(0)
    act, stage_caches = fn(runner.stage_weights(0),
                           runner.init_stage_caches(0, 2, 16),
                           torch.from_numpy(prompts))
    served = [logits, piped, act, *jax.tree_util.tree_leaves(caches),
              *jax.tree_util.tree_leaves(stage_caches)]
    assert all(t.grad_fn is None and not t.requires_grad for t in served)
    sd = SlotDecoder(model, n_slots=2, max_seq=16)
    assert isinstance(sd.prefill(0, prompts[0]), np.ndarray)
    assert all(t.grad_fn is None for t in
               jax.tree_util.tree_leaves(sd.caches))
    assert tserve.main(["--device", "cpu", "--warm-steps", "1", "--requests",
                        "2", "--prompt-len", "4", "--max-new", "2",
                        "--replicas", "1"]) == 0
