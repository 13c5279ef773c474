"""The mixed family (IBM Granite 4.0-H, ``granite-4.0-h-micro``) on the
port, against the benchmark's plain reference
``bench/reference/granite_hybrid.py`` (plain torch, no kernel), at ``ModelConfig.reduced()`` size on the CPU: the
forward, the partitioned, fake-quantized forward over cut vectors at the
search's positions, the stages against the cost model's platforms,
``run_spec`` with the ``lm_fakequant`` oracle, the runner's spans and
counters, the config's new fields and the eps of every RMSNorm, and the
benchmark cell ``oracle.granite-h-micro-4plat.t8192`` at a tiny size.

Tolerances: logits within 1e-5 of the largest |logit| (float32 sums in
other orders: the port's chunked SSD and attention against the
reference's blocks; on the CPU the two agree bit for bit at these sizes,
so the bound leaves room for kernels' orders without hiding a missing
term, which moves the logits by 1e-2 or more); the top-1 equal at every
position.  The TF32 control (the reference with its products' operands
rounded to TF32) reads 3e-4 to 2e-3 at the same sizes.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.reference import granite_hybrid as plain  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import layers as GL  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.quant import QuantSpec, quantize_leaf  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import decoder as decoder_mod  # noqa: E402
from repro_torch.models import ssm_lm as ssm_lm_mod  # noqa: E402
from repro_torch.models.ssm_lm import MixedLM  # noqa: E402
from repro_torch.nn import attention as attention_mod  # noqa: E402
from repro_torch.nn import ssm as ssm_mod  # noqa: E402
from repro_torch.nn.attention import GQAAttention  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.quantize import lm_measured_accuracy  # noqa: E402
from repro_torch.serving import PartitionedLMRunner  # noqa: E402
from repro_torch.serving.pipeline import quantized_units  # noqa: E402

ARCH = "granite-4.0-h-micro"
CELL = "oracle.granite-h-micro-4plat.t8192"
REL = 1e-5
BITS = (16, 16, 8, 8)
SPECS = [QuantSpec(bits=b) for b in BITS]
# the chain of the reduced model (mamba, attention, mamba): 8 positions
CUTS = [(-1, -1, -1), (0, 1, 5), (1, 2, 7), (2, 2, 2), (3, 4, 4), (7, 7, 7),
        (-1, 4, 6), (0, 0, 0), (1, 3, 5)]


def catalog(cfg: ModelConfig) -> dict:
    """The published config.json's keys of a port config."""
    return dict(
        num_hidden_layers=cfg.n_layers, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, layer_types=list(cfg.layer_types),
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv,
        mamba_n_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
        mamba_d_head=cfg.ssm_headdim, mamba_d_state=cfg.ssm_state,
        mamba_n_groups=1, mamba_d_conv=4, mamba_chunk_size=cfg.ssm_chunk,
        mamba_expand=cfg.ssm_expand, vocab_size=cfg.vocab,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling,
        attention_multiplier=cfg.attention_scale,
        rms_norm_eps=cfg.norm_eps)


@pytest.fixture(scope="module")
def lm():
    """The reduced model on weights drawn as the benchmark draws them
    (every leaf random, norm scales and D spread), and its catalog."""
    from bench.lib import granite, weights
    cfg = registry.get_config(ARCH).reduced()
    cat = catalog(cfg)
    w = weights.draw(granite.leaves(cat), 20261018, torch.device("cpu"))
    model = MixedLM(cfg, device="meta")
    model.load_state_dict(w, assign=True)
    return model, cat, w


def tokens(cfg, b=2, t=80, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, t), generator=g)


def close_logits(got, want):
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= REL, err


# -- the configuration ----------------------------------------------------------

def test_published_widths_and_layer_types():
    cfg = registry.get_config(ARCH)
    assert cfg.family == "mixed" and ARCH in registry.PORT_ARCH_IDS
    assert ARCH not in registry.ARCH_IDS      # the reference's grid
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.ssm_chunk) == (
        2048, 8192, 100_352, 256)
    assert cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim == 64
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_scale, cfg.rope,
            cfg.norm_eps) == (12.0, 0.22, 8.0, 0.015625, False, 1e-5)
    assert cfg.param_count() == 3_191_230_208
    model = MixedLM(cfg, device="meta")
    # the graph counts no norm scale: 2 a layer and the final norm
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + (2 * 40 + 1) * 2048


def test_reduced_keeps_both_mixer_kinds():
    cfg = registry.get_config(ARCH).reduced()
    assert cfg.family == "mixed" and cfg.n_layers == 3
    assert cfg.layer_types == ("mamba", "attention", "mamba")
    g = registry.model_graph(cfg, 64)
    assert list(g.nodes) == ["Embed_0", "SSM_0", "Mlp_0", "Attention_1",
                             "Mlp_1", "SSM_2", "Mlp_2", "Head_0"]


@pytest.mark.parametrize("kw,match", [
    (dict(family="mixed"), "layer_types"),
    (dict(family="dense", layer_types=("mamba",)), "layer_types"),
    (dict(family="mixed", layer_types=("mamba", "conv")), "layer_types"),
    (dict(family="dense", residual_multiplier=0.5), "multipliers"),
])
def test_config_fields_are_checked(kw, match):
    with pytest.raises(ValueError, match=match):
        ModelConfig(arch_id="x", n_layers=2, d_model=8, vocab=8, **kw)


def test_graph_counts_conv_bias_and_d_only_when_asked():
    base = GL.ssm_layer("s", 64, 16, 8, 2, headdim=32)
    both = GL.ssm_layer("s", 64, 16, 8, 2, headdim=32, conv_bias=True,
                        d_skip=True)
    assert both.params - base.params == (128 + 32) + 4
    assert both.macs == base.macs


# -- the forward and the partitioned forward against the plain reference --------

@pytest.mark.parametrize("t", [80, 2048])
def test_forward_matches_plain(lm, t):
    """At 80 tokens (the SSD's chunk padding, attention's ``sdpa``) and at
    2048 (attention's ``chunked_sdpa``)."""
    model, cat, w = lm
    tok = tokens(model.cfg, b=2 if t < 2048 else 1, t=t)
    got = model({"tokens": tok})
    n = got.shape[0] * got.shape[1]
    keep = torch.arange(n)
    top1, want = plain.forward(cat, w, tok, keep=keep)
    close_logits(got.reshape(n, -1), want)
    assert torch.equal(got.argmax(-1), top1)


@pytest.mark.parametrize("cuts", CUTS, ids=str)
def test_partitioned_fake_quant_matches_plain(lm, cuts):
    model, cat, w = lm
    tok = tokens(model.cfg)
    got, rep = PartitionedLMRunner(model, cuts, SPECS,
                                   link_quant=True).forward({"tokens": tok})
    n = got.shape[0] * got.shape[1]
    top1, want = plain.forward(cat, w, tok, cuts, BITS,
                               keep=torch.arange(n))
    close_logits(got.reshape(n, -1), want)
    assert torch.equal(got.argmax(-1), top1)
    assert len(rep.latency_s) == len(plain.layout(3, cuts, BITS))


def test_float_partition_is_the_model(lm):
    model, _, _ = lm
    tok = tokens(model.cfg)
    want = model({"tokens": tok})
    for cuts in CUTS:
        got, _ = PartitionedLMRunner(model, cuts).forward({"tokens": tok})
        assert torch.equal(got, want), cuts


def test_quantization_moves_the_logits(lm):
    """The fake-quantized stages are not the float model (the comparison
    above would pass a runner that ignored its specs otherwise)."""
    model, _, _ = lm
    tok = tokens(model.cfg)
    want = model({"tokens": tok})
    got, _ = PartitionedLMRunner(model, (1, 2, 7), SPECS,
                                 link_quant=True).forward({"tokens": tok})
    assert float((got - want).abs().max() / want.abs().max()) > 1e-3


@pytest.mark.parametrize("cuts", CUTS, ids=str)
def test_stages_hold_the_cost_models_nodes(lm, cuts):
    """Stage i holds exactly the nodes the cost model puts on the i-th
    platform that holds any (``PartitionEvaluator``'s bounds), a cut after
    a mixer putting its MLP on the next stage."""
    model, _, _ = lm
    schedule = linearize(model.to_graph(64), "insertion")
    names = [layer.name for layer in schedule]
    bounds = [-1] + list(cuts) + [len(schedule) - 1]
    want = [names[a + 1:b + 1] for a, b in zip(bounds, bounds[1:]) if b > a]
    runner = PartitionedLMRunner(model, cuts, SPECS)
    units = model.units()
    got = []
    for si, (a, b) in enumerate(runner.ranges):
        held = ["Embed_0"] if si == 0 else []
        held += [names[1 + i] for i in range(a, b)]
        held += ["Head_0"] if si == runner.n_stages - 1 else []
        got.append(held)
        for blk, i in zip(runner._blocks[si], range(a, b)):
            assert blk.block is units[i]
    assert got == want
    assert len(runner.quant_specs) == len(want)


def test_runner_checks_its_cuts(lm):
    model, _, _ = lm
    with pytest.raises(ValueError, match="not sorted"):
        PartitionedLMRunner(model, (3, 1, 5), SPECS)
    with pytest.raises(ValueError, match="not sorted"):
        PartitionedLMRunner(model, (0, 1, 8), SPECS)
    with pytest.raises(ValueError, match="3 quant specs for 4 platforms"):
        PartitionedLMRunner(model, (0, 1, 2), SPECS[:3])


def test_quantized_units_stack_each_kind(lm):
    """Each leaf stacked over the stage's units of one kind and quantized
    whole: a per-tensor range spans the kind's units, the stacked norm
    scales quantized too."""
    model, _, _ = lm
    units = model.units()[:5]          # mamba, mlp, attention, mlp, mamba
    q = quantized_units(units, QuantSpec(bits=8))
    for name, idx in (("mixer.w_in", [0, 4]), ("ln", [1, 3]),
                      ("mlp.w_up", [1, 3])):
        want = quantize_leaf(torch.stack(
            [dict(units[i].named_parameters())[name] for i in idx]),
            QuantSpec(bits=8))
        for j, i in enumerate(idx):
            assert torch.equal(q[i].params[name], want[j])
    assert torch.equal(q[2].params["ln"], quantize_leaf(
        units[2].ln[None], QuantSpec(bits=8))[0])


# -- the oracle -------------------------------------------------------------------

def test_lm_measured_accuracy_scores_keeps_and_caches(lm):
    model, cat, w = lm
    tok = tokens(model.cfg)
    labels = plain.forward(cat, w, tok)[0][:, :-1]
    schedule = linearize(model.to_graph(80), "insertion")
    measure = lm_measured_accuracy(model, schedule, tok, labels, SPECS)
    assert measure((-1, -1, -1)) == measure((-1, -1, -1))
    keep = torch.tensor([0, 7, 100, 159])
    for cuts in ((0, 1, 5), (3, 4, 4)):
        acc = measure(cuts, keep=keep)
        top1, want = plain.forward(cat, w, tok, cuts, BITS, keep=keep)
        agree = int((top1[:, :-1] == labels).sum())
        assert acc * labels.numel() == pytest.approx(agree, abs=1e-3)
        kept = measure.kept[cuts]
        close_logits(kept["logits"], want)
        assert torch.equal(kept["top1"], top1)
    assert 0.0 < measure((1, 2, 7)) <= 1.0
    with pytest.raises(ValueError, match="next-token"):
        lm_measured_accuracy(model, schedule, tok, labels[:, 1:], SPECS)
    with pytest.raises(ValueError, match="chain"):
        lm_measured_accuracy(model, schedule[::-1], tok, labels, SPECS)


def test_lm_measured_accuracy_takes_the_mixed_family_only():
    dense = registry.build_model(registry.get_config(
        "smollm-360m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="mixed family"):
        lm_measured_accuracy(dense, [], torch.zeros(1, 4, dtype=torch.long),
                             torch.zeros(1, 3, dtype=torch.long), SPECS)


def test_run_spec_with_lm_fakequant():
    """A reduced granite spec whose accuracy the ``lm_fakequant`` oracle
    measures runs through ``run_spec``: its front's accuracies are those
    of the oracle's partitioned, fake-quantized runs."""
    from repro_torch.explore import (AccuracySpec, ExplorationSpec, ModelRef,
                                     PlatformSpec, SearchSettings,
                                     SystemSpec, run_spec)
    seq = 48
    opts = {"seq": seq, "reduced": True}
    spec = ExplorationSpec(
        model=ModelRef(kind="registry", name=ARCH, options=opts),
        system=SystemSpec(
            platforms=(PlatformSpec("cam0", "eyr", 16),
                       PlatformSpec("cam1", "eyr", 16),
                       PlatformSpec("edge", "smb", 8),
                       PlatformSpec("central", "smb", 8)),
            links=("gige", "gige", "gige")),
        objectives=("latency", "accuracy"),
        search=SearchSettings(strategy="nsga2", pop_size=8, n_gen=2,
                              seed=0),
        schedule_policy="insertion",
        accuracy=AccuracySpec(kind="measured", measure="lm_fakequant",
                              options=dict(name=ARCH, batch=2, **opts)))
    res = run_spec(spec, device="cpu")
    assert [layer.name for layer in res.schedule] == list(
        registry.model_graph(registry.get_config(ARCH).reduced(),
                             seq).nodes)
    assert res.pareto and all(0.0 <= p.accuracy <= 1.0 for p in res.pareto)
    assert all(p.accuracy * 2 * (seq - 1) == pytest.approx(
        round(p.accuracy * 2 * (seq - 1)), abs=1e-3) for p in res.pareto)


# -- spans and counters ---------------------------------------------------------

def test_runner_spans_and_counters(lm):
    model, cat, w = lm
    tok = tokens(model.cfg)
    labels = plain.forward(cat, w, tok)[0][:, :-1]
    schedule = linearize(model.to_graph(80), "insertion")
    obs = Obs.on()
    measure = lm_measured_accuracy(model, schedule, tok, labels, SPECS,
                                   obs=obs)
    measure((0, 3, 4))           # stages: embed; mamba + mlp + attention;
    #                              mlp; mamba + mlp + head
    spans = obs.tracer.spans()
    stages = [s.args for s in spans if s.name == "oracle.stage"]
    assert stages == [
        {"stage": 0, "mamba": 0, "attention": 0, "tokens": 160},
        {"stage": 1, "mamba": 1, "attention": 1, "tokens": 160},
        {"stage": 2, "mamba": 0, "attention": 0, "tokens": 160},
        {"stage": 3, "mamba": 1, "attention": 0, "tokens": 160}]
    quant = [s.args for s in spans if s.name == "oracle.quantize"]
    assert [a["bits"] for a in quant] == list(BITS)
    assert quant[0]["tensors"] == 0 and quant[1]["tensors"] == 9 + 4 + 5
    links = [s.args["bytes"] for s in spans if s.name == "oracle.link"]
    assert links == [160 * 256 * 2, 160 * 256 * 2, 160 * 256]  # 16, 16, 8 bits
    assert sum(s.name == "oracle.measure" for s in spans) == 1
    assert sum(s.name == "oracle.read" for s in spans) == 1
    snap = obs.metrics.snapshot()
    assert snap["ssm_scan_calls.ref"] == 2 and "ssm_scan_calls.cuda" not in snap
    assert snap["oracle_positions"] == 2 * 79
    measure((0, 3, 4))            # cached
    assert [s.args["cached"] for s in obs.tracer.spans()
            if s.name == "oracle.measure"] == [False, True]


def test_runner_counts_stacked_leaves_and_links_fake_quantized(lm):
    """The mixed runner counts each stage's stacked leaves (one a
    parameter of each unit kind it holds) and each link it fake-quantizes,
    by route: on the CPU all take the chain (``fake_quant_tensors.ref``)."""
    model, _, _ = lm
    obs = Obs.on()
    runner = PartitionedLMRunner(model, (0, 3, 4), SPECS, link_quant=True,
                                 obs=obs)
    runner.forward({"tokens": tokens(model.cfg)})
    units = model.units()
    leaves = sum(len(dict(next(units[i] for i in range(a, b)
                               if units[i].kind == kind).named_parameters()))
                 for a, b in runner.ranges
                 for kind in {u.kind for u in units[a:b]})
    assert leaves == 9 + 4 + 5 + 4 + 9 + 4
    snap = obs.metrics.snapshot()
    assert snap["fake_quant_tensors.ref"] == leaves + 3
    assert "fake_quant_tensors.cuda" not in snap


def test_runner_records_nothing_off(lm):
    model, _, _ = lm
    runner = PartitionedLMRunner(model, (0, 3, 4), SPECS, link_quant=True)
    runner.forward({"tokens": tokens(model.cfg)})
    assert runner.obs.tracer.spans() == [] and not runner.obs.enabled


# -- attention and mixer options ----------------------------------------------------

def test_attention_without_rope_and_with_a_scale():
    g = torch.Generator().manual_seed(0)
    att = GQAAttention(64, 4, 2, 16, rope=False, scale=0.1, device="cpu",
                       generator=g)
    x = torch.randn(2, 12, 64, generator=g)
    y, _ = att(x)
    q = (x @ att.wq).reshape(2, 12, 2, 2, 16)
    k = (x @ att.wk).reshape(2, 12, 2, 16)
    v = (x @ att.wv).reshape(2, 12, 2, 16)
    s = torch.einsum("btkgh,bskh->bkgts", q, k) * 0.1
    s = s.masked_fill(~torch.ones(12, 12, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bkgts,bskh->btkgh", torch.softmax(s, -1), v)
    want = o.reshape(2, 12, 64) @ att.wo
    assert float((y - want).abs().max()) < 1e-5
    shifted, _ = att(x, positions=torch.arange(12)[None].expand(2, 12) + 7)
    assert torch.equal(shifted, y)          # no positional encoding
    with pytest.raises(ValueError, match="window"):
        GQAAttention(64, 4, 2, 16, window=8, scale=0.1, device="cpu")


def test_scan_impl():
    x = torch.zeros(1, 4)
    assert ssm_mod.Mamba2Mixer.scan_impl(x, "auto") == "ref"
    assert ssm_mod.Mamba2Mixer.scan_impl(x, "ref") == "ref"
    with pytest.raises(ValueError):
        ssm_mod.Mamba2Mixer.scan_impl(x, "cuda")


# -- the eps of every RMSNorm ----------------------------------------------------------

LMS = ["smollm-360m", "mamba2-370m", "zamba2-2.7b", ARCH]
NORM_SITES = (decoder_mod, ssm_lm_mod, ssm_mod, attention_mod)


def _record_eps(monkeypatch, seen, drop=False):
    """Patch ``rms_norm`` where the LM modules call it: record each eps,
    or (``drop``) compute at the default eps whatever is passed."""
    real = decoder_mod.rms_norm

    def rec(x, scale, eps=1e-6):
        seen.append(eps)
        return real(x, scale) if drop else real(x, scale, eps)
    for mod in NORM_SITES:
        monkeypatch.setattr(mod, "rms_norm", rec)


@pytest.mark.parametrize("arch", LMS)
def test_norm_eps_reaches_every_rms_norm(arch, monkeypatch):
    cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                              norm_eps=3e-5)
    model = registry.build_model(cfg, device="cpu")
    seen = []
    _record_eps(monkeypatch, seen)
    model({"tokens": tokens(cfg, t=32)})
    assert seen and set(seen) == {3e-5}


@pytest.mark.parametrize("arch", LMS[:3])
def test_default_eps_is_bit_identical(arch, monkeypatch):
    """At the default eps (1e-6) every existing LM computes what it did
    when ``rms_norm`` took no eps from the config."""
    cfg = registry.get_config(arch).reduced()
    assert cfg.norm_eps == 1e-6
    model = registry.build_model(cfg, device="cpu")
    tok = tokens(cfg, t=32)
    got = model({"tokens": tok})
    seen = []
    _record_eps(monkeypatch, seen, drop=True)
    assert torch.equal(model({"tokens": tok}), got) and seen


# -- the benchmark's cell at a tiny size ---------------------------------------------

TINY = {"config": {"hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 3,
                   "layer_types": ["mamba", "attention", "mamba"],
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "mamba_n_heads": 4, "mamba_d_head": 32,
                   "mamba_d_state": 16, "mamba_chunk_size": 32,
                   "vocab_size": 512},
        "cell": {"traffic": {"name": "t8192", "loop": "closed",
                             "sequences": 2, "tokens": 80,
                             "link_quant": True, "warmup_vectors": 1,
                             "traced_vectors": 1, "check_vectors": 2,
                             "check_among": 3, "kept_positions": 16},
                 # at this size the program reads 0 against the reference
                 # (bit for bit on the CPU), the control 7.8e-4 to 5.8e-3
                 # over six seeds and two sizes, its median position
                 # 5.3e-4 to 5.6e-4; the cell's own limits, set at full
                 # size on the card, are 4e-3 and 2.2e-3
                 "limits": {"logit_rel_err": 1e-4,
                            "logit_median_rel_err": 1e-4,
                            "agree_gap_positions": 16}}}

SCRIPT = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
torch.set_num_threads(2)
from bench.lib import harness
from bench.lib.trace import TraceWindow
ov = json.loads({ov!r})
out = {{}}
for key, control in (("sound", False), ("control", True)):
    r = harness.run_cell({cell!r}, 20261018, 0.5, False, "cpu",
                         overrides=ov, control=control)
    out[key] = {{"correct": r["correct"], "checks": r["checks"],
                 "attempted": r["attempted"]}}
# the traced path: the driver's spans and counters, and the readers of
# the program's spans (the profiler's metrics need a card)
w, cell, config = harness.cell_files({cell!r})
cell.update(ov["cell"]); config.update(ov["config"])
run = harness.Run({cell!r}, cell, config, 7, 0.3, torch.device("cpu"),
                  TraceWindow(False, torch.device("cpu")), True)
drv = harness.driver_module(cell["driver"])
st = drv.setup(run)
o = drv.window(st, run)
ctx = harness.MetricContext(run, o, None, None)
out["traced"] = {{m: harness.metric_module(m).read(ctx) for m in (
    "stage_ms.granite", "weight_quant_ms.granite", "mfu.granite",
    "k4_roofline.granite", "device_idle.granite")}}
out["counters"] = o["counters"]
# a planted fault the kept logits cannot see: the top-1 read one position
# late wherever no logit is kept, the score that of the faulty top-1
assert st.measure.kept
for c, got in st.measure.kept.items():
    flat = got["top1"].view(-1)
    late = torch.roll(got["top1"], 1, dims=1).reshape(-1)
    unkept = torch.ones_like(flat, dtype=torch.bool)
    unkept[st.keep] = False
    flat[unkept] = late[unkept]
    st.accs[c] = float((got["top1"][:, :-1] == st.labels).double().mean())
out["fault"] = {{c.name: c.value for c in drv.check(st, run, o)}}
out["forbidden"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def test_cell_at_a_tiny_size_on_the_cpu():
    """The cell's driver, check and control through the harness (in a
    fresh interpreter: the harness refuses a process that loaded JAX),
    sound ``correct`` and control not, by both logit checks; the traced
    path's span metrics; a fault at the positions whose logits are not
    kept fails by ``agree_gap_positions`` alone."""
    code = SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT),
                         ov=json.dumps(TINY), cell=CELL)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["sound"]["correct"], out["sound"]
    assert not out["control"]["correct"], out["control"]
    for name in ("logit_rel_err", "logit_median_rel_err"):
        ctl = out["control"]["checks"][name]
        assert ctl["value"] > ctl["limit"], (name, ctl)
        assert out["sound"]["checks"][name]["value"] == 0
    fault = out["fault"]
    assert fault["logit_rel_err"] == fault["logit_median_rel_err"] == 0
    assert 16 < fault["agree_gap_positions"] < float("inf"), fault
    assert out["sound"]["attempted"] >= 1
    tr = out["traced"]
    assert tr["stage_ms.granite"] > 0 and tr["weight_quant_ms.granite"] > 0
    assert tr["mfu.granite"] is None and tr["k4_roofline.granite"] is None
    assert tr["device_idle.granite"] is None
    assert out["counters"]["ssm_scan_calls.ref"] == 2
    assert "ssm_scan_calls.cuda" not in out["counters"]
    assert out["counters"]["oracle_positions"] == 2 * 79
    assert out["forbidden"] == []


@pytest.mark.parametrize("key,value", [
    ("mamba_conv_bias", False), ("mamba_n_groups", 2), ("mamba_d_conv", 3),
    ("mamba_n_heads", 63)])
def test_port_config_refuses_what_the_mixer_cannot_take(key, value):
    """The benchmark's configuration file is read into the port's
    ``ModelConfig`` only where the port's Mamba2 mixer computes what the
    file states: one group, a convolution of 4 with bias, and expand x
    hidden / head dim heads."""
    from bench.lib import granite
    cfg = json.loads((ROOT / "bench" / "configs" /
                      "granite-h-micro-4plat.json").read_text())
    assert granite.port_config(cfg).layer_types == registry.get_config(
        ARCH).layer_types
    with pytest.raises(ValueError, match="Mamba2 mixer"):
        granite.port_config({**cfg, key: value})


def test_work_counts_by_hand():
    from bench.lib import granite
    # one chunk of 2, b = h = p = n = 1: C.B^T 3, intra 3, states 2,
    # inter 2, carry 1 multiply-adds
    w = granite.ssd_work(1, 2, 1, 1, 1, 2)
    assert w["ops"] == 2 * (3 + 3 + 2 + 2 + 1)
    assert w["bytes"] == 4 * (2 * 2 + 2 + 1 + 2 * 2 + 1)
    cfg = json.loads((ROOT / "bench" / "configs" /
                      "granite-h-micro-4plat.json").read_text())
    t = 256
    scans = 36 * granite.ssd_work(1, t, 64, 64, 128, 256)["ops"]
    attention = 4 * 2 * 2 * 32 * 64 * t * (t + 1) // 2
    per_token = (granite.forward_flops(cfg, 1, t) - scans - attention) / 2 / t
    # multiply-adds a token: 36 Mamba2 projections (2048 x 8512 in, 4096 x
    # 2048 out), 40 MLPs (3 x 2048 x 8192), 4 attention projections (2048 x
    # 3072 in, 2048 x 2048 out), the head (2048 x 100352): 3.19 G
    d = 2048
    assert per_token == 36 * (d * 8512 + 4096 * d) + 40 * 3 * d * 8192 \
        + 4 * (d * 3072 + 2048 * d) + d * 100_352 == 3_190_292_480
