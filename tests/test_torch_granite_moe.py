"""The mixed family with experts (IBM Granite 4.0-H Small,
``granite-4.0-h-small``) on the port, against the benchmark's plain
reference ``bench/reference/granite_moe_hybrid.py`` (plain torch, no
kernel), at ``ModelConfig.reduced()`` size on the CPU with a held share of
the experts (experts 1-2 of 4, as a device of an expert-parallel
deployment holds its share): the forward, the partitioned, fake-quantized
forward over cut vectors at the search's positions (one boundary between
a mixer and its expert layer), the shares of the expert layer adding up
to the whole layer, the dropless route under routing skewed onto one
expert, the capacity route planted in its place failing the comparison,
the stages against the cost model's nodes and ``moe_layer``'s held counts,
the runner's spans and counters, and the benchmark cell
``oracle.granite-h-small-4plat.t8192`` at a tiny size.

Tolerances: logits within 1e-5 of the largest |logit|, as
``tests/test_torch_granite.py`` holds granite-micro (the port and the
reference take their sums in the same order here and agree bit for bit on
the CPU; the bound leaves room for other orders without hiding a missing
term, and a dropped expert choice moves the logits by 1e-2 or more); the
top-1 equal at every position.
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

from bench.reference import granite_hybrid  # noqa: E402
from bench.reference import granite_moe_hybrid as plain  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import layers as GL  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.hwmodel.mapper import decompose  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.ssm_lm import MixedLM, MoeUnit  # noqa: E402
from repro_torch.nn.moe import MoEFFN  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.quantize import lm_measured_accuracy  # noqa: E402
from repro_torch.serving import PartitionedLMRunner  # noqa: E402

ARCH = "granite-4.0-h-small"
CELL = "oracle.granite-h-small-4plat.t8192"
REL = 1e-5
BITS = (16, 16, 8, 8)
SPECS = [QuantSpec(bits=b) for b in BITS]
HELD = (1, 2)
# the chain of the reduced model (mamba, attention, mamba): 8 positions,
# 1, 3, 5 the mixers and 2, 4, 6 the expert layers; (0, 1, 5), (3, 4, 4)
# and (1, 3, 5) end a stage between a mixer and its expert layer
CUTS = [(-1, -1, -1), (0, 1, 5), (1, 2, 7), (3, 4, 4), (7, 7, 7),
        (-1, 4, 6), (1, 3, 5)]


def reduced(held=HELD) -> ModelConfig:
    return dataclasses.replace(registry.get_config(ARCH).reduced(),
                               experts_held=held)


def config_keys(cfg: ModelConfig) -> dict:
    """The published config.json's keys of a port config, with the held
    share as the benchmark's configuration file states it."""
    first, count = cfg.experts_held or (0, cfg.n_experts)
    return dict(
        num_hidden_layers=cfg.n_layers, hidden_size=cfg.d_model,
        intermediate_size=cfg.moe_d_ff, shared_intermediate_size=cfg.d_ff,
        layer_types=list(cfg.layer_types),
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv,
        mamba_n_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
        mamba_d_head=cfg.ssm_headdim, mamba_d_state=cfg.ssm_state,
        mamba_n_groups=1, mamba_d_conv=4, mamba_chunk_size=cfg.ssm_chunk,
        mamba_expand=cfg.ssm_expand, vocab_size=cfg.vocab,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling,
        attention_multiplier=cfg.attention_scale,
        rms_norm_eps=cfg.norm_eps, experts_published=cfg.n_experts,
        experts_first=first, num_local_experts=count,
        num_experts_per_tok=cfg.top_k)


def build(cfg, seed=20261018):
    """The model on weights drawn as the benchmark draws them, its
    configuration keys and the weights."""
    from bench.lib import granite_moe, weights
    cat = config_keys(cfg)
    w = weights.draw(granite_moe.leaves(cat), seed, torch.device("cpu"))
    model = MixedLM(cfg, device="meta")
    model.load_state_dict(w, assign=True)
    return model, cat, w


@pytest.fixture(scope="module")
def lm():
    return build(reduced())


def tokens(cfg, b=2, t=80, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, t), generator=g)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def moe_units(model):
    return [u for u in model.units() if u.kind == "moe"]


# -- the configuration ----------------------------------------------------------

def test_published_widths():
    cfg = registry.get_config(ARCH)
    assert cfg.family == "mixed" and ARCH in registry.PORT_ARCH_IDS
    assert ARCH not in registry.ARCH_IDS
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.d_model, cfg.vocab, cfg.ssm_chunk, cfg.n_heads,
            cfg.n_kv) == (4096, 100_352, 256, 32, 8)
    assert cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim == 128
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared, cfg.moe_d_ff,
            cfg.d_ff, cfg.experts_held) == (72, 10, 1, 768, 1536, None)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_scale, cfg.rope,
            cfg.norm_eps) == (12.0, 0.22, 16.0, 0.0078125, False, 1e-5)
    # 32 B parameters whole; the cell's cut (20 layers, 9 of 72 experts
    # held) 4.42 B
    assert cfg.param_count() == 32_207_006_208
    cut = dataclasses.replace(cfg, n_layers=20, layer_types=cfg.layer_types[
        :20], experts_held=(0, 9))
    assert cut.param_count() == 4_418_172_160
    model = MixedLM(cut, device="meta")
    # the graph counts no norm scale: 2 a layer and the final norm
    assert sum(p.numel() for p in model.parameters()) == \
        cut.param_count() + (2 * 20 + 1) * 4096


def test_reduced_graph_has_an_expert_node_a_layer():
    cfg = reduced()
    assert (cfg.n_layers, cfg.n_experts, cfg.top_k) == (3, 4, 2)
    g = registry.model_graph(cfg, 64)
    assert list(g.nodes) == ["Embed_0", "SSM_0", "Moe_0", "Attention_1",
                             "Moe_1", "SSM_2", "Moe_2", "Head_0"]
    assert [type(u) for u in MixedLM(cfg, device="meta").units()][1::2] \
        == [MoeUnit] * 3


@pytest.mark.parametrize("kw,match", [
    (dict(family="mixed", layer_types=("mamba",), n_layers=1,
          n_experts=4, top_k=0, moe_d_ff=8), "top_k"),
    (dict(family="mixed", layer_types=("mamba",), n_layers=1,
          n_experts=4, top_k=2), "moe_d_ff"),
    (dict(family="mixed", layer_types=("mamba",), n_layers=1,
          n_experts=4, top_k=2, moe_d_ff=8, experts_held=(3, 2)),
     "experts_held"),
    (dict(family="mixed", layer_types=("mamba",), n_layers=1,
          experts_held=(0, 1)), "experts_held"),
    (dict(family="moe", n_layers=2, n_experts=4, top_k=2, moe_d_ff=8,
          experts_held=(0, 2)), "experts_held"),
])
def test_expert_fields_are_checked(kw, match):
    with pytest.raises(ValueError, match=match):
        ModelConfig(arch_id="x", d_model=8, vocab=8, **kw)


# -- the forward and the partitioned forward against the plain reference --------

@pytest.mark.parametrize("held", [HELD, None], ids=["held", "all"])
def test_forward_matches_plain(held):
    model, cat, w = build(reduced(held))
    tok = tokens(model.cfg)
    got = model({"tokens": tok})
    n = got.shape[0] * got.shape[1]
    top1, want = plain.forward(cat, w, tok, keep=torch.arange(n))
    assert rel_err(got.reshape(n, -1), want) <= REL
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
    assert rel_err(got.reshape(n, -1), want) <= REL
    assert torch.equal(got.argmax(-1), top1)
    assert len(rep.latency_s) == len(granite_hybrid.layout(3, cuts, BITS))


def test_quantization_moves_the_logits(lm):
    model, _, _ = lm
    tok = tokens(model.cfg)
    want = model({"tokens": tok})
    got, _ = PartitionedLMRunner(model, (1, 2, 7), SPECS,
                                 link_quant=True).forward({"tokens": tok})
    assert rel_err(got, want) > 1e-3


# -- the expert layer -------------------------------------------------------------

def expert_layer(held=None, cap=None, e=4, k=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return MoEFFN(32, 16, e, k, 1, capacity_factor=cap, held=held,
                  shared_d_ff=24, device="cpu", generator=g)


def take_share(full: MoEFFN, held, cap=None) -> MoEFFN:
    """The layer of ``held`` on ``full``'s router, held experts and shared
    expert."""
    part = expert_layer(held, cap)
    first, count = held
    with torch.no_grad():
        for name, p in full.named_parameters():
            q = getattr(part, name)
            q.copy_(p[first:first + count] if name in (
                "w_gate", "w_up", "w_down") else p)
    return part


def shared(layer: MoEFFN, x):
    from repro_torch.nn.moe import gated_ffn
    return gated_ffn(x, layer.sh_gate, layer.sh_up, layer.sh_down)


@pytest.mark.parametrize("cap", [None, 1.25], ids=["dropless", "capacity"])
def test_expert_shares_add_up_to_the_whole_layer(cap):
    """Each device's share computes its experts' part; the shares' routed
    parts, the shared expert counted once, add up to the uncut layer (the
    capacity route too: it ranks every choice over all experts, so a
    share drops what the whole layer drops)."""
    full = expert_layer(None, cap)
    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(1))
    want, _ = full(x)
    s = shared(full, x)
    total = s.clone()
    for held in ((0, 1), (1, 2), (3, 1)):
        y, _ = take_share(full, held, cap)(x)
        total += y - s
    assert float((total - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_dropless_under_skewed_routing():
    """Every token's first choice is expert 1 (held): the dropless route
    drops none of the 64 rows and equals the reference's layer, while the
    capacity route (1.25, 40 slots an expert) drops 24 of them."""
    layer = expert_layer(HELD)
    x = torch.rand(1, 64, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        layer.router[:, 1] = 10.0
    y, aux = layer(x)
    idx = torch.topk(x @ layer.router, 2, -1).indices
    assert bool((idx[..., 0] == 1).all())
    held_choices = int(((idx >= 1) & (idx < 3)).sum())
    assert aux["rows"] == held_choices >= 64
    p = {n: t for n, t in layer.named_parameters()}
    cfg = {"num_experts_per_tok": 2, "experts_first": HELD[0]}
    want = plain.moe(cfg, p, x, granite_hybrid._Products(False))
    assert rel_err(y, want) <= REL
    capped = take_share(layer, HELD, cap=1.25)
    yc, auxc = capped(x)
    assert float(auxc["dropped"]) * 128 >= 24
    assert rel_err(yc, want) > 1e-2


def test_capacity_route_planted_fails_the_comparison():
    """The capacity route (factor 1.25: choices past an expert's slots
    dropped) in the dropless route's place: the forward leaves the
    reference by more than the tolerance.  The documents hold 4 distinct
    tokens, so that the routing concentrates as a trained model's does
    (on ids uniform over the reduced vocabulary no expert of this tiny
    model overflows its slots)."""
    model, cat, w = build(reduced())
    tok = torch.randint(0, 4, (2, 160),
                        generator=torch.Generator().manual_seed(3))
    n = tok.numel()
    _, want = plain.forward(cat, w, tok, keep=torch.arange(n))
    assert rel_err(model({"tokens": tok}).reshape(n, -1), want) <= REL
    dropped = []
    for u in moe_units(model):
        u.moe.cap_f = 1.25
        u.moe.register_forward_hook(
            lambda m, a, out: dropped.append(float(out[1]["dropped"])))
    got = model({"tokens": tok}).reshape(n, -1)
    assert max(dropped) > 0
    assert rel_err(got, want) > 100 * REL


def test_expert_layer_keeps_the_capacity_route_with_every_expert():
    """Without a held share the capacity route is the reference's: every
    expert's slots, nothing sliced or padded."""
    layer = expert_layer(None, 1.25)
    assert layer.held == (0, 4) and layer.w_gate.shape == (4, 32, 16)
    with pytest.raises(ValueError, match="share"):
        expert_layer((3, 2))
    with pytest.raises(ValueError, match="softmax"):
        MoEFFN(8, 4, 4, 2, capacity_factor=None, sigmoid_gate=True,
               device="cpu")


# -- the graph and the stages -------------------------------------------------------

def test_moe_layer_counts_the_held_share():
    d, ff, seq, e, k = 4096, 768, 8, 72, 10
    whole = GL.moe_layer("m", d, ff, seq, e, k, 2)
    per = 3 * d * ff
    assert whole.params == (e + 2) * per + d * e          # as before
    assert whole.macs == seq * ((k + 2) * per + d * e)
    assert "held" not in whole.attrs and "shared_d_ff" not in whole.attrs
    held = GL.moe_layer("m", d, ff, seq, e, k, 1, held=9, shared_d_ff=1536)
    shared_p = 3 * d * 1536
    assert held.params == 9 * per + shared_p + d * e
    # 10 x 9 / 72 = 1.25 held experts a token
    assert held.macs == seq * k * 9 * per // e + seq * (shared_p + d * e)
    assert held.attrs["active_params"] == per * 5 // 4 + shared_p
    # the cost model's expert rows: 1.25 a token, the shared expert's
    # width two experts' (1536 / 768)
    gemms, elems = decompose(held)
    assert [a.p for a in gemms] == [seq, 26, 26, 26]
    assert elems == 26 * ff * 2
    assert [a.p for a in decompose(whole)[0]] == [seq] + [seq * 12] * 3


@pytest.mark.parametrize("cuts", CUTS, ids=str)
def test_stages_hold_the_cost_models_nodes(lm, cuts):
    """Stage i holds exactly the nodes the cost model puts on the i-th
    platform that holds any; each expert node's parameters are its unit's
    held experts, shared expert and router (its norm scale aside)."""
    model, _, _ = lm
    graph = model.to_graph(64)
    schedule = linearize(graph, "insertion")
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
            if units[i].kind == "moe":
                node = graph.nodes[names[1 + i]]
                assert node.attrs["held"] == HELD[1]
                assert node.params == sum(
                    p.numel() for p in units[i].parameters()) - 256
    assert got == want


# -- the oracle, spans and counters ----------------------------------------------------

def held_rows_hook(model):
    """Counts, at each expert layer's input, the choices that fall on its
    held experts (the router on the parameters the call runs on)."""
    seen = []

    def hook(mod, args, out):
        idx = torch.topk(args[0] @ mod.router, mod.k, -1).indices
        first, count = mod.held
        seen.append(int(((idx >= first) & (idx < first + count)).sum()))
    handles = [u.moe.register_forward_hook(hook) for u in moe_units(model)]
    return seen, handles


def test_runner_spans_and_counters(lm):
    model, cat, w = lm
    tok = tokens(model.cfg)
    labels = plain.forward(cat, w, tok)[0][:, :-1]
    schedule = linearize(model.to_graph(80), "insertion")
    obs = Obs.on()
    measure = lm_measured_accuracy(model, schedule, tok, labels, SPECS,
                                   obs=obs)
    seen, handles = held_rows_hook(model)
    try:
        measure((0, 3, 4))       # stages: embed; mamba + moe + attention;
        #                          moe; mamba + moe + head
    finally:
        for h in handles:
            h.remove()
    stages = [s.args for s in obs.tracer.spans() if s.name == "oracle.stage"]
    assert [{k: a[k] for k in ("stage", "mamba", "attention", "moe",
                               "tokens")} for a in stages] == [
        {"stage": 0, "mamba": 0, "attention": 0, "moe": 0, "tokens": 160},
        {"stage": 1, "mamba": 1, "attention": 1, "moe": 1, "tokens": 160},
        {"stage": 2, "mamba": 0, "attention": 0, "moe": 1, "tokens": 160},
        {"stage": 3, "mamba": 1, "attention": 0, "moe": 1, "tokens": 160}]
    assert stages[0]["moe_ms"] == 0
    assert all(a["moe_ms"] > 0 for a in stages[1:])
    snap = obs.metrics.snapshot()
    assert len(seen) == 3 and snap["moe_rows.held"] == sum(seen) > 0
    assert snap["moe_rows.routed"] == 3 * 160 * 2
    assert snap["ssm_scan_calls.ref"] == 2


def test_runner_records_nothing_off(lm):
    model, _, _ = lm
    runner = PartitionedLMRunner(model, (0, 3, 4), SPECS, link_quant=True)
    runner.forward({"tokens": tokens(model.cfg)})
    assert runner.obs.tracer.spans() == [] and not runner.obs.enabled
    assert runner.obs.metrics.snapshot() == {}


def test_lm_measured_accuracy_keeps_the_reference_logits(lm):
    model, cat, w = lm
    tok = tokens(model.cfg)
    labels = plain.forward(cat, w, tok)[0][:, :-1]
    schedule = linearize(model.to_graph(80), "insertion")
    measure = lm_measured_accuracy(model, schedule, tok, labels, SPECS)
    keep = torch.tensor([0, 7, 100, 159])
    for cuts in ((0, 1, 5), (3, 4, 4)):
        acc = measure(cuts, keep=keep)
        top1, want = plain.forward(cat, w, tok, cuts, BITS, keep=keep)
        assert acc * labels.numel() == pytest.approx(
            int((top1[:, :-1] == labels).sum()), abs=1e-3)
        assert rel_err(measure.kept[cuts]["logits"], want) <= REL


# -- the benchmark's library and cell ---------------------------------------------------

def test_leaves_are_the_models_parameters():
    from bench.lib import granite_moe
    cfg = reduced()
    names = {n for n, *_ in granite_moe.leaves(config_keys(cfg))}
    assert names == set(dict(MixedLM(cfg, device="meta").named_parameters()))
    file = json.loads((ROOT / "bench" / "configs" /
                       "granite-h-small-4plat.json").read_text())
    port = granite_moe.port_config(file)
    assert (port.n_layers, port.n_experts, port.experts_held, port.top_k,
            port.moe_d_ff, port.d_ff) == (20, 72, (0, 9), 10, 768, 1536)
    assert port.layer_types == registry.get_config(ARCH).layer_types[:20]
    with pytest.raises(ValueError, match="no experts"):
        granite_moe.port_config({**file, "num_local_experts": 0})


def test_work_counts_by_hand():
    from bench.lib import granite, granite_moe
    file = json.loads((ROOT / "bench" / "configs" /
                       "granite-h-small-4plat.json").read_text())
    b, t, d = 2, 8192, 4096
    rows = granite_moe.expected_rows(file, b, t)
    assert rows == 20 * b * t * 10 * 9 / 72
    flops = granite_moe.forward_flops(file, b, t)
    shared = granite.forward_flops(
        dict(file, intermediate_size=1536), b, t)
    assert flops == shared + 2 * 20 * b * t * d * 72 + 6 * d * 768 * rows
    # ~1.0e14 products a forward
    assert 0.9e14 < flops < 1.1e14
    assert granite_moe.forward_flops(file, b, t, held_rows=0) == \
        flops - 6 * d * 768 * rows


TINY = {"config": {"hidden_size": 64, "intermediate_size": 32,
                   "shared_intermediate_size": 64, "num_hidden_layers": 3,
                   "layer_types": ["mamba", "attention", "mamba"],
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "mamba_n_heads": 4, "mamba_d_head": 32,
                   "mamba_d_state": 16, "mamba_chunk_size": 32,
                   "vocab_size": 512, "experts_published": 8,
                   "num_local_experts": 3, "experts_first": 2,
                   "num_experts_per_tok": 3},
        "cell": {"traffic": {"name": "t8192", "loop": "closed",
                             "sequences": 2, "tokens": 80,
                             "link_quant": True, "warmup_vectors": 1,
                             "traced_vectors": 1, "check_vectors": 2,
                             "check_among": 3, "kept_positions": 16},
                 # at this size the program reads 0 against the reference
                 # (bit for bit on the CPU), the control 5.4e-3 to 5.8e-3
                 # on three seeds, its median position 2.0e-3 to 2.5e-3;
                 # the cell's own limits are set at full size on the card
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
# the traced path: the driver's spans and counters, and the metrics'
# readers (the profiler's metrics need a card)
w, cell, config = harness.cell_files({cell!r})
cell.update(ov["cell"]); config.update(ov["config"])
run = harness.Run({cell!r}, cell, config, 7, 0.3, torch.device("cpu"),
                  TraceWindow(False, torch.device("cpu")), True)
drv = harness.driver_module(cell["driver"])
st = drv.setup(run)
o = drv.window(st, run)
ctx = harness.MetricContext(run, o, None, None)
out["traced"] = {{m["name"]: harness.metric_module(m["name"]).read(ctx)
                  for m in harness.cell_metrics(harness.load_benchmark(),
                                                {cell!r}, "per_layer")}}
out["counters"] = o["counters"]
out["vectors"] = o["traced_vectors"]
# the capacity route (factor 1.25) planted in the program's place
setup = drv.setup
def planted(run):
    st = setup(run)
    for u in st.model.units():
        if u.kind == "moe":
            u.moe.cap_f = 1.25
    return st
drv.setup = planted
r = harness.run_cell({cell!r}, 20261018, 0.5, False, "cpu", overrides=ov)
out["planted"] = {{"correct": r["correct"], "checks": r["checks"]}}
out["forbidden"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def test_cell_at_a_tiny_size_on_the_cpu():
    """The cell's driver, check and control through the harness (in a
    fresh interpreter: the harness refuses a process that loaded JAX):
    sound ``correct``, the control and the planted capacity route not; the
    traced path's span metric and counters."""
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
    planted = out["planted"]
    assert not planted["correct"], planted
    assert planted["checks"]["logit_rel_err"]["value"] > 1e-3, planted
    tr = out["traced"]
    assert set(tr) == {"mfu.granite_small", "moe_ms.granite_small",
                       "device_idle.granite_small"}
    assert tr["moe_ms.granite_small"] > 0
    assert tr["mfu.granite_small"] is None     # no device trace here
    assert tr["device_idle.granite_small"] is None
    n = out["vectors"]
    assert n >= 1
    assert out["counters"]["moe_rows.routed"] == n * 3 * 2 * 80 * 3
    assert 0 < out["counters"]["moe_rows.held"] < \
        out["counters"]["moe_rows.routed"]
    assert out["counters"]["ssm_scan_calls.ref"] == 2 * n
    assert out["forbidden"] == []
