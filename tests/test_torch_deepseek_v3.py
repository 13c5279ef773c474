"""DeepSeek-V3 (``deepseek-v3``: MLA with YaRN, the ``noaux_tc`` route over
groups of experts, a shared expert) on the port, against the benchmark's
plain reference ``bench/reference/deepseek_v3.py`` (plain torch, no
kernel), at a small size on the CPU with a held share of the experts
(experts 4-7 of 16 in 4 groups, the best 2 groups, top 4, as a device of
an expert-parallel deployment holds its share): the forward, the
partitioned, fake-quantized forward over cut vectors at the search's
positions (some between an attention unit and its FFN unit), the
``noaux_tc`` route against a hand-written one, YaRN against its closed
form, the shares of an expert layer adding up to the whole layer, the
softmax dropless route bit for bit as it was, ``mla_layer``'s counts, the
runner's spans and counters, and the benchmark cell
``oracle.deepseek-v3-4plat.t16384`` at a tiny size.

Tolerances: logits within 1e-5 of the largest |logit|, the top-1 equal at
every position (the port and the reference take their sums in the same
order here and agree bit for bit on the CPU; the bound leaves room for
other orders without hiding a missing term, which moves the logits by
1e-3 or more).
"""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.lib import deepseek_v3 as lib  # noqa: E402
from bench.reference import deepseek_v3 as plain  # noqa: E402
from repro_torch.configs.base import ModelConfig, RopeScaling  # noqa: E402
from repro_torch.core import layers as GL  # noqa: E402
from repro_torch.core.graph import linearize  # noqa: E402
from repro_torch.core.hwmodel.mapper import decompose  # noqa: E402
from repro_torch.core.quant import QuantSpec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.decoder import (AttnUnit, DecoderLM,  # noqa: E402
                                        FfnUnit)
from repro_torch.nn import attention as A  # noqa: E402
from repro_torch.nn.moe import MoEFFN, gated_ffn  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.quantize import lm_measured_accuracy  # noqa: E402
from repro_torch.serving import PartitionedLMRunner  # noqa: E402

ARCH = "deepseek-v3"
CELL = "oracle.deepseek-v3-4plat.t16384"
REL = 1e-5
BITS = (16, 16, 8, 8)
SPECS = [QuantSpec(bits=b) for b in BITS]
HELD = (4, 4)
# the chain of the small model (1 dense layer, 3 expert layers): 10
# positions, 1, 3, 5, 7 the attention units, 2 the MLP, 4, 6, 8 the expert
# layers; (0, 1, 5), (3, 4, 4) and (2, 5, 7) end a stage between an
# attention unit and its FFN unit
CUTS = [(-1, -1, -1), (0, 1, 5), (1, 2, 9), (3, 4, 4), (9, 9, 9),
        (-1, 4, 6), (2, 5, 7)]


def small(held=HELD, **kw) -> ModelConfig:
    """The published configuration at ``reduced()`` widths, 4 layers (the
    first dense), 16 experts in 4 groups, the best 2 kept, top 4."""
    return dataclasses.replace(registry.get_config(ARCH).reduced(),
                               n_layers=4, n_experts=16, n_group=4,
                               topk_group=2, top_k=4, experts_held=held,
                               **kw)


def config_keys(cfg: ModelConfig) -> dict:
    """The configuration file's keys of a port config (the benchmark's
    file with the small widths)."""
    first, count = cfg.experts_held or (0, cfg.n_experts)
    rs = dataclasses.asdict(cfg.rope_scaling)
    c = json.loads((ROOT / "bench" / "configs" /
                    "deepseek-v3-4plat.json").read_text())
    c.update(
        num_hidden_layers=cfg.n_layers, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, moe_intermediate_size=cfg.moe_d_ff,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_dim, qk_rope_head_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim, vocab_size=cfg.vocab,
        first_k_dense_replace=cfg.first_dense,
        n_shared_experts=cfg.n_shared, n_group=cfg.n_group,
        topk_group=cfg.topk_group, num_experts_per_tok=cfg.top_k,
        routed_scaling_factor=cfg.routed_scaling_factor,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        rope_scaling=dict(c["rope_scaling"], **rs),
        experts_published=cfg.n_experts, experts_first=first,
        n_routed_experts=count)
    return c


def build(cfg, seed=20261019):
    """The model on weights drawn as the benchmark draws them, its
    configuration keys and the weights."""
    from bench.lib import weights
    cat = config_keys(cfg)
    w = weights.draw(lib.leaves(cat), seed, torch.device("cpu"))
    model = DecoderLM(cfg, device="meta")
    model.load_state_dict(w, assign=True)
    return model, cat, w


@pytest.fixture(scope="module")
def lm():
    return build(small())


def tokens(cfg, b=2, t=80, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, t), generator=g)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# -- the configuration ----------------------------------------------------------

def test_published_widths():
    cfg = registry.get_config(ARCH)
    assert cfg.family == "moe" and ARCH in registry.PORT_ARCH_IDS
    assert ARCH not in registry.ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.n_heads, cfg.d_ff,
            cfg.first_dense, cfg.tied_embeddings) == (
        61, 7168, 129_280, 128, 18_432, 3, False)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim,
            cfg.qk_rope_dim, cfg.v_head_dim) == (1536, 512, 128, 64, 128)
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared, cfg.moe_d_ff,
            cfg.n_group, cfg.topk_group, cfg.routed_scaling_factor,
            cfg.experts_held, cfg.mtp) == (256, 8, 1, 2048, 8, 4, 2.5,
                                           None, 0)
    assert cfg.rope_scaling == RopeScaling(40.0, 4096, 32.0, 1.0, 1.0, 1.0)
    # the cell's cut: 7 layers, 8 of 256 experts held; the graph counts
    # no RMSNorm scale of a layer (2 a layer and the final norm)
    cut = dataclasses.replace(cfg, n_layers=7, experts_held=(0, 8))
    assert cut.param_count() == 5_945_090_048 - 15 * 7168
    model = DecoderLM(cut, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 5_945_090_048
    g = registry.model_graph(cut, 16)
    assert g.nodes["Attention_0"].params == 187_107_328
    assert g.nodes["MoE_3"].params == 585_318_656 - 187_107_328 - 2 * 7168


def test_the_twin_keeps_the_reference_graph():
    """deepseek-v3-671b, the JAX package's twin, keeps its plain RoPE, its
    capacity route and the reference's count of MLA as GQA (its parity
    tests pin its graph to the reference's): the count follows the
    config's ``graph_mla``, not its name."""
    twin = registry.get_config("deepseek-v3-671b")
    assert (twin.rope_scaling, twin.n_group, twin.experts_held,
            twin.graph_mla) == (None, 0, None, False)
    assert registry.model_graph(dataclasses.replace(twin, graph_mla=True),
                                64).nodes["Attention_0"].op == GL.MLA
    g = registry.model_graph(twin, 64)
    assert g.nodes["Attention_0"].op == GL.ATTENTION
    assert g.nodes["Attention_0"].params == GL.attention_layer(
        "a", 7168, 128, 128, 64, 56).params
    blk = DecoderLM(twin.reduced(), device="meta").blocks[-1]
    assert blk.moe.cap_f == 1.25 and not hasattr(blk.moe, "router_bias")
    assert registry.model_graph(registry.get_config(ARCH), 64).nodes[
        "Attention_0"].op == GL.MLA


@pytest.mark.parametrize("kw,match", [
    (dict(family="moe", n_experts=16, top_k=4, n_group=3, topk_group=2),
     "noaux_tc"),
    (dict(family="moe", n_experts=16, top_k=4, n_group=4, topk_group=5),
     "noaux_tc"),
    (dict(family="moe", n_experts=16, top_k=9, n_group=4, topk_group=2),
     "noaux_tc"),
    (dict(family="moe", n_experts=8, top_k=2, n_group=8, topk_group=2),
     "noaux_tc"),
    (dict(family="dense", n_experts=16, top_k=4, n_group=4, topk_group=2),
     "noaux_tc"),
    (dict(family="moe", n_experts=16, top_k=4, topk_group=2), "topk_group"),
    (dict(family="moe", n_experts=16, top_k=4,
          routed_scaling_factor=2.5), "routed_scaling_factor"),
    (dict(family="moe", n_experts=16, top_k=4, experts_held=(0, 4)),
     "experts_held"),
    (dict(family="moe", n_experts=16, top_k=4, n_group=4, topk_group=2,
          experts_held=(14, 4)), "experts_held"),
    (dict(family="dense", rope_scaling=RopeScaling(40.0, 4096)),
     "rope_scaling"),
    (dict(family="moe", n_experts=16, top_k=4, graph_mla=True),
     "graph_mla"),
])
def test_new_fields_are_checked(kw, match):
    with pytest.raises(ValueError, match=match):
        ModelConfig(arch_id="x", n_layers=2, d_model=8, vocab=8, **kw)


# -- YaRN -----------------------------------------------------------------------

def test_yarn_frequencies_and_scales_against_the_closed_form():
    """At DeepSeek-V3's rope width 64: the half-dims below 10 keep the
    plain frequencies, those from 23 are divided by 40, the ones between
    follow the linear ramp (the correction dims of beta 32 and 1 over 4096
    positions, 10.47 and 22.52, rounded out); cos and sin unscaled
    (mscale = mscale_all_dim); the softmax scale 192^-½ (0.1 ln 40 +
    1)²."""
    rs = registry.get_config(ARCH).rope_scaling
    got = A.yarn_inv_freq(64, 10000.0, rs).double()
    plain_f = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = plain_f / 40 * ramp + plain_f * (1 - ramp)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    assert torch.allclose(got[:10], plain_f[:10], rtol=1e-6)
    assert torch.allclose(got[23:], plain_f[23:] / 40, rtol=1e-6)
    assert 10 <= 64 * math.log(4096 / (32 * 2 * math.pi)) / (
        2 * math.log(10000)) < 11
    m = 0.1 * math.log(40) + 1
    assert A.yarn_mscale(40, 1.0) == pytest.approx(m)
    assert A.yarn_mscale(1.0, 1.0) == 1.0
    att = A.MLAAttention(A.MLAConfig(
        d_model=64, n_heads=2, q_lora_rank=16, kv_lora_rank=8,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, rope_scaling=rs),
        device="meta")
    assert att.scale == pytest.approx(24 ** -0.5 * m * m)
    # the rotation: angle position x inv_freq on each (first, second) half
    x = torch.randn(1, 5, 1, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None] * 1000
    y = A.apply_rope(x, pos, 10000.0, rs).double()
    ang = pos[0, :, None].double() * want
    c, s = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x[..., :32].double(), x[..., 32:].double()
    assert torch.allclose(y, torch.cat([a * c - b * s, b * c + a * s], -1),
                          atol=2e-4)
    # with mscale 2 over mscale_all_dim 1, cos and sin scale by m(2)/m(1)
    rs2 = dataclasses.replace(rs, mscale=2.0)
    y2 = A.apply_rope(x, pos, 10000.0, rs2).double()
    r = A.yarn_mscale(40, 2.0) / m
    assert torch.allclose(y2, y * r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t", [37, 2048], ids=["sdpa", "chunked"])
def test_mla_with_yarn_matches_plain(lm, t):
    """One MLA unit on the ``sdpa`` branch and on ``chunked_sdpa`` (from
    2048 tokens) against the reference's, YaRN's frequencies and scale on
    both; the absorbed decode through the latent cache gives the same
    outputs."""
    model, cat, w = lm
    attn = model.blocks[1].attn
    x = torch.randn(1, t, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    got, _ = attn(x)
    p = {k.split("attn.")[1]: v for k, v in w.items()
         if k.startswith("blocks.1.attn.")}
    from bench.reference.granite_hybrid import _Products
    want = plain.mla(cat, p, x, _Products(False), 512)
    assert rel_err(got, want) <= REL
    if t > 100:
        return
    cache = A.init_mla_cache(1, 64, attn.cfg, torch.float32)
    steps = []
    for i in range(t):
        y, cache = attn(x[:, i:i + 1], positions=torch.tensor([[i]]),
                        cache=cache)
        steps.append(y)
    assert rel_err(torch.cat(steps, 1), want) <= REL


@pytest.mark.parametrize("chunk,heads,keys,want", [
    (512, 128, 16384, 128),     # DeepSeek-V3's cell: 1 GiB, not 4
    (512, 32, 8192, 512),       # granite's: 512 MiB, as it was
    (512, 128, 2048, 512),
    (384, 128, 16384, 96),
    (375, 128, 16384, 375),     # an odd chunk cannot halve
])
def test_score_chunk_bounds_one_sequences_scores(chunk, heads, keys, want):
    """On a card ``chunked_sdpa`` takes :func:`score_chunk`'s chunk: the
    largest halving of the given one whose float32 scores of one sequence
    fit ``SCORE_CHUNK_BYTES`` (the CPU and a dry run's ``meta`` keep the
    given chunk)."""
    assert A.score_chunk(chunk, heads, keys) == want


def test_yarn_moves_the_attention(lm):
    """At 2048 positions, past half the original 4096, YaRN off (plain
    RoPE, scale 1/sqrt(qk)) is far from YaRN on."""
    model, _, _ = lm
    attn = model.blocks[1].attn
    x = torch.randn(1, 2048, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    on, _ = attn(x)
    off = A.MLAAttention(dataclasses.replace(attn.cfg, rope_scaling=None),
                         device="meta")
    off.load_state_dict(attn.state_dict(), assign=True)
    assert rel_err(off(x)[0], on) > 1e-2


# -- the noaux_tc route -----------------------------------------------------------

def expert_layer(held=None, seed=0, e=16, g=4, tg=2, k=4):
    gen = torch.Generator().manual_seed(seed)
    layer = MoEFFN(32, 16, e, k, 1, capacity_factor=None, router_scale=2.5,
                   sigmoid_gate=True, held=held, n_group=g, topk_group=tg,
                   device="cpu", generator=gen)
    with torch.no_grad():
        layer.router_bias.copy_(0.1 * torch.randn(e, generator=gen))
    return layer


def hand_route(logits, bias, g, tg, k, scale):
    """The noaux_tc route one row at a time with Python lists."""
    idx, wts = [], []
    for row in logits.tolist():
        s = [1 / (1 + math.exp(-v)) for v in row]
        c = [a + b for a, b in zip(s, bias.tolist())]
        per = len(c) // g
        score = [sum(sorted(c[j * per:(j + 1) * per])[-2:]) for j in range(g)]
        groups = sorted(range(g), key=lambda j: -score[j])[:tg]
        cand = [e for j in groups for e in range(j * per, (j + 1) * per)]
        chosen = sorted(cand, key=lambda e: -c[e])[:k]
        tot = sum(s[e] for e in chosen)
        idx.append(chosen)
        wts.append([s[e] / tot * scale for e in chosen])
    return torch.tensor(idx), torch.tensor(wts)


def test_noaux_tc_route_against_a_hand_written_one():
    """The route's choices and weights equal the hand-written route's; the
    group limit changes some choices (against the top-4 over all 16), the
    bias changes choices (against no bias) but never a weight: each is the
    chosen sigmoid score over the chosen scores' sum, times 2.5."""
    layer = expert_layer()
    x = torch.randn(2, 50, 32, generator=torch.Generator().manual_seed(6))
    logits = (x @ layer.router).float()
    w, idx = layer._noaux_tc(logits)
    hi, hw = hand_route(logits.reshape(-1, 16), layer.router_bias, 4, 2, 4,
                        2.5)
    assert torch.equal(idx.reshape(-1, 4).sort(-1).values,
                       hi.sort(-1).values)
    order = idx.reshape(-1, 4).argsort(-1)
    horder = hi.argsort(-1)
    assert torch.allclose(w.reshape(-1, 4).gather(1, order),
                          hw.gather(1, horder), rtol=1e-6)
    s = torch.sigmoid(logits)
    c = s + layer.router_bias
    free = c.topk(4, -1).indices
    assert (free.sort(-1).values != idx.sort(-1).values).any(-1).sum() > 5
    with torch.no_grad():
        bias = layer.router_bias.clone()
        layer.router_bias.zero_()
        _, idx0 = layer._noaux_tc(logits)
        layer.router_bias.copy_(bias)
    moved = (idx0.sort(-1).values != idx.sort(-1).values).any(-1)
    assert moved.sum() > 5
    chosen = s.gather(-1, idx)
    assert torch.allclose(w, chosen / chosen.sum(-1, keepdim=True) * 2.5,
                          rtol=1e-6)


def test_noaux_tc_layer_matches_plain():
    """The dropless layer at a held share against the reference's
    ``moe``."""
    layer = expert_layer(HELD)
    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(7))
    y, aux = layer(x)
    p = dict(layer.named_parameters())
    cfg = {"n_group": 4, "topk_group": 2, "num_experts_per_tok": 4,
           "routed_scaling_factor": 2.5, "experts_first": HELD[0]}
    from bench.reference.granite_hybrid import _Products
    assert rel_err(y, plain.moe(cfg, p, x, _Products(False))) <= REL
    _, idx = layer._noaux_tc((x @ layer.router).float())
    assert aux["rows"] == int(((idx >= 4) & (idx < 8)).sum()) > 0


def take_share(full: MoEFFN, held) -> MoEFFN:
    part = expert_layer(held)
    first, count = held
    with torch.no_grad():
        for name, p in full.named_parameters():
            getattr(part, name).copy_(p[first:first + count] if name in (
                "w_gate", "w_up", "w_down") else p)
    return part


def test_expert_shares_add_up_to_the_whole_layer():
    """Four devices' shares (experts 0-3, 4-7, 8-13, 14-15): their routed
    parts, the shared expert counted once, add up to the uncut layer."""
    full = expert_layer(None, seed=1)
    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(8))
    want, aux = full(x)
    assert aux["rows"] == 2 * 40 * 4
    sh = gated_ffn(x, full.sh_gate, full.sh_up, full.sh_down)
    total, rows = sh.clone(), 0
    for held in ((0, 4), (4, 4), (8, 6), (14, 2)):
        y, a = take_share(full, held)(x)
        total += y - sh
        rows += a["rows"]
    assert rows == aux["rows"]
    assert rel_err(total, want) <= REL


def dropless_as_it_was(layer: MoEFFN, x):
    """The softmax dropless route as the parent wrote it (``_dropless``
    before the noaux_tc gate), kept here to hold the route bit for bit."""
    b, t, d = x.shape
    logits = (x @ layer.router).float()
    top, idx = torch.topk(logits, layer.k, dim=-1)
    wk = (torch.softmax(top, dim=-1) * layer.router_scale).to(x.dtype)
    flat = x.reshape(-1, d)
    first, count = layer.held
    local = idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < count), local, count)
    order = torch.argsort(key, stable=True)
    rows = torch.bincount(key, minlength=count + 1)[:count].tolist()
    tok = order // layer.k
    w = wk.reshape(-1)[order]
    out = torch.zeros_like(flat)
    s = 0
    for e, n in enumerate(rows):
        if n:
            r = tok[s:s + n]
            y_e = gated_ffn(flat[r], layer.w_gate[e], layer.w_up[e],
                            layer.w_down[e])
            out.index_add_(0, r, y_e * w[s:s + n, None])
        s += n
    y = out.reshape(b, t, d)
    y = y + gated_ffn(x, layer.sh_gate, layer.sh_up, layer.sh_down)
    return y, s


@pytest.mark.parametrize("held", [None, (1, 2)], ids=["all", "held"])
def test_softmax_dropless_route_unchanged_bit_for_bit(held):
    """granite-4.0-h-small's expert layer (the softmax dropless route)
    gives the parent's bits."""
    layer = MoEFFN(32, 16, 8, 3, 1, capacity_factor=None, held=held,
                   shared_d_ff=24, device="cpu",
                   generator=torch.Generator().manual_seed(9))
    assert not hasattr(layer, "router_bias")
    x = torch.randn(2, 30, 32, generator=torch.Generator().manual_seed(10))
    y, aux = layer(x)
    want, rows = dropless_as_it_was(layer, x)
    assert torch.equal(y, want) and aux == {"rows": rows}


# -- the graph's MLA node -----------------------------------------------------------

def test_mla_layer_counts_by_hand():
    d, h, seq = 7168, 128, 16384
    node = GL.mla_layer("a", d, h, seq, 1536, 512, 128, 64, 128)
    proj = (7168 * 1536 + 1536 * 128 * 192 + 7168 * 512 + 7168 * 64
            + 512 * 128 * 128 * 2 + 128 * 128 * 7168)
    assert proj == 187_105_280
    assert node.params == proj + 1536 + 512
    pairs = seq * (seq + 1) // 2
    assert node.macs == seq * proj + pairs * 128 * (192 + 128)
    # ~374 MFLOP of projections and ~671 of core a token
    assert 2 * proj / 1e6 == pytest.approx(374.2, abs=0.1)
    assert 2 * pairs * 128 * 320 / seq / 1e6 == pytest.approx(671.1,
                                                               abs=0.1)
    assert (node.op, node.out_shape) == (GL.MLA, (seq, d))
    gemms, elems = decompose(GL.mla_layer("a", 64, 2, 10, 16, 8, 16, 8, 16))
    assert [(a.k, a.c, a.p) for a in gemms] == [
        (16 + 8 + 8, 64, 10), (2 * 24, 16, 10), (2 * 32, 8, 10),
        (10, 24, 20), (16, 10, 20), (64, 32, 10)]
    assert elems == 10 * 2 * 10
    moe = GL.moe_layer("m", 7168, 2048, 8, 256, 8, 1, held=8,
                       router_bias=True)
    assert moe.params == 8 * 3 * 7168 * 2048 + 3 * 7168 * 2048 \
        + 7168 * 256 + 256


# -- the model, the chain and the partitioned forward ----------------------------------

def test_units_share_the_blocks_parameters(lm):
    model, _, w = lm
    units = model.units()
    assert [u.kind for u in units] == ["mla", "mlp"] + ["mla", "moe"] * 3
    assert [type(u) for u in units[:2]] == [AttnUnit, FfnUnit]
    assert units[1].ln is model.blocks[0].ln2
    assert units[3].moe is model.blocks[1].moe
    assert set(model.state_dict()) == set(w)          # nothing twice
    names = [layer.name for layer in linearize(model.to_graph(80),
                                                "insertion")]
    assert names == ["Embed_0"] + [f"{k}_{i}" for i in range(4) for k in (
        "Attention", "Mlp" if i == 0 else "MoE")] + ["Head_0"]


@pytest.mark.parametrize("held", [HELD, None], ids=["held", "all"])
def test_forward_matches_plain(held):
    model, cat, w = build(small(held))
    tok = tokens(model.cfg)
    got = model({"tokens": tok})
    n = got.shape[0] * got.shape[1]
    top1, want = plain.forward(cat, w, tok, keep=torch.arange(n))
    assert rel_err(got.reshape(n, -1), want) <= REL
    assert torch.equal(got.argmax(-1), top1)


@pytest.mark.parametrize("cuts", CUTS, ids=str)
def test_partitioned_fake_quant_matches_plain(lm, cuts):
    """Weights fake-quantized at the platforms' widths, the links float or
    fake-quantized at the producer's."""
    model, cat, w = lm
    tok = tokens(model.cfg)
    n = tok.numel()
    for link in (False, True):
        got, rep = PartitionedLMRunner(model, cuts, SPECS,
                                       link_quant=link).forward(
                                           {"tokens": tok})
        top1, want = plain.forward(cat, w, tok, cuts, BITS, link,
                                   keep=torch.arange(n))
        assert rel_err(got.reshape(n, -1), want) <= REL
        assert torch.equal(got.argmax(-1), top1)
    assert len(rep.latency_s) == len(plain.layout(4, cuts, BITS))


@pytest.mark.parametrize("cuts", [(), (0, 1, 5), (2, 5, 7)], ids=str)
def test_the_reordered_reference_is_the_same_function(lm, cuts):
    """The reference's other float32 sums (``reorder``: YaRN's closed-form
    frequencies, the causal triangle in blocks whose last is shorter, a
    score's two parts as two products), from which the cell's limits are
    set, compute what its default order computes."""
    model, cat, w = lm
    tok = tokens(model.cfg)
    n = tok.numel()
    bits = BITS[:len(cuts) + 1] if cuts else (None,)
    top1, want = plain.forward(cat, w, tok, cuts, bits, False,
                               keep=torch.arange(n))
    rtop1, got = plain.forward(cat, w, tok, cuts, bits, False,
                               keep=torch.arange(n), block=32, reorder=True)
    assert rel_err(got, want) <= REL
    assert torch.equal(rtop1, top1)
    cos, sin = plain.yarn_cos_sin(cat, 80, torch.device("cpu"))
    rcos, rsin = plain.yarn_cos_sin(cat, 80, torch.device("cpu"), True)
    assert torch.allclose(rcos, cos, atol=1e-5)
    assert torch.allclose(rsin, sin, atol=1e-5)


def test_quantization_moves_the_logits(lm):
    model, _, _ = lm
    tok = tokens(model.cfg)
    want = model({"tokens": tok})
    got, _ = PartitionedLMRunner(model, (1, 2, 9), SPECS,
                                 link_quant=True).forward({"tokens": tok})
    assert rel_err(got, want) > 1e-3


@pytest.mark.parametrize("cuts", CUTS, ids=str)
def test_stages_hold_the_cost_models_nodes(lm, cuts):
    """Stage i holds exactly the nodes the cost model puts on the i-th
    platform that holds any; each expert node's parameters are its unit's
    held experts, shared expert, router and bias (its norm scale aside),
    each MLA node's its attention's."""
    model, _, _ = lm
    graph = model.to_graph(64)
    names = [layer.name for layer in linearize(graph, "insertion")]
    bounds = [-1] + list(cuts) + [len(names) - 1]
    want = [names[a + 1:b + 1] for a, b in zip(bounds, bounds[1:]) if b > a]
    runner = PartitionedLMRunner(model, cuts, SPECS)
    d = model.cfg.d_model
    got = []
    for si, (a, b) in enumerate(runner.ranges):
        held = ["Embed_0"] if si == 0 else []
        held += [names[1 + i] for i in range(a, b)]
        held += ["Head_0"] if si == runner.n_stages - 1 else []
        got.append(held)
        for blk in runner._blocks[si]:
            unit = blk.block
            node = graph.nodes[names[1 + runner._blocks[si].index(blk) + a]]
            assert node.params == sum(
                p.numel() for p in unit.parameters()) - d
            if unit.kind == "moe":
                assert node.attrs["held"] == HELD[1]
    assert got == want


# -- the oracle, spans and counters ----------------------------------------------------

def test_runner_spans_and_counters(lm):
    model, cat, w = lm
    tok = tokens(model.cfg)
    labels = plain.forward(cat, w, tok)[0][:, :-1]
    schedule = linearize(model.to_graph(80), "insertion")
    obs = Obs.on()
    measure = lm_measured_accuracy(model, schedule, tok, labels, SPECS,
                                   obs=obs)
    seen = []

    def hook(mod, args, out):
        seen.append(out[1]["rows"])
    handles = [blk.moe.register_forward_hook(hook)
               for blk in model.blocks[1:]]
    try:
        measure((0, 3, 4))   # stages: embed; mla + mlp + mla; moe;
        #                      mla + moe + mla + moe + head
    finally:
        for h in handles:
            h.remove()
    stages = [s.args for s in obs.tracer.spans() if s.name == "oracle.stage"]
    assert [{k: a[k] for k in ("stage", "mamba", "attention", "mla", "moe",
                               "tokens")} for a in stages] == [
        {"stage": 0, "mamba": 0, "attention": 0, "mla": 0, "moe": 0,
         "tokens": 160},
        {"stage": 1, "mamba": 0, "attention": 0, "mla": 2, "moe": 0,
         "tokens": 160},
        {"stage": 2, "mamba": 0, "attention": 0, "mla": 0, "moe": 1,
         "tokens": 160},
        {"stage": 3, "mamba": 0, "attention": 0, "mla": 2, "moe": 2,
         "tokens": 160}]
    assert [a["mla_ms"] > 0 for a in stages] == [False, True, False, True]
    assert [a["moe_ms"] > 0 for a in stages] == [False, False, True, True]
    snap = obs.metrics.snapshot()
    assert len(seen) == 3 and snap["moe_rows.held"] == sum(seen) > 0
    assert snap["moe_rows.routed"] == 3 * 160 * 4
    assert "ssm_scan_calls.ref" not in snap


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
    cfg = small()
    names = {n for n, *_ in lib.leaves(config_keys(cfg))}
    assert names == set(dict(DecoderLM(cfg, device="meta")
                             .named_parameters()))
    file = json.loads((ROOT / "bench" / "configs" /
                       "deepseek-v3-4plat.json").read_text())
    port = lib.port_config(file)
    assert port == dataclasses.replace(registry.get_config(ARCH),
                                       n_layers=7, experts_held=(0, 8))
    for key, value in (("topk_method", "greedy"), ("scoring_func",
                                                    "softmax"),
                       ("num_nextn_predict_layers", 1)):
        with pytest.raises(ValueError, match="noaux_tc"):
            lib.port_config({**file, key: value})


def test_work_counts_by_hand():
    file = json.loads((ROOT / "bench" / "configs" /
                       "deepseek-v3-4plat.json").read_text())
    b, t = 1, 16384
    rows = lib.expected_rows(file, b, t)
    assert rows == 4 * t * 8 * 8 / 256
    mla = lib.mla_macs(file, b, t)
    flops = lib.forward_flops(file, b, t)
    d = 7168
    want = 2 * (7 * (mla["proj"] + mla["core"]) + 3 * t * 3 * d * 18432
                + 4 * t * (d * 256 + 3 * d * 2048) + 3 * d * 2048 * rows
                + t * d * 129280)
    assert flops == want
    # ~12.0 GFLOP a token, ~196.6 TFLOP a vector, MLA ~61 % of it
    assert flops / t / 1e9 == pytest.approx(12.0, abs=0.05)
    share = 2 * 7 * (mla["proj"] + mla["core"]) / flops
    assert 0.60 < share < 0.62
    assert lib.forward_flops(file, b, t, held_rows=0) == \
        flops - 6 * d * 2048 * rows


TINY = {"config": {"hidden_size": 64, "intermediate_size": 128,
                   "moe_intermediate_size": 32, "num_attention_heads": 4,
                   "num_key_value_heads": 4, "q_lora_rank": 32,
                   "kv_lora_rank": 16, "qk_nope_head_dim": 16,
                   "qk_rope_head_dim": 8, "v_head_dim": 16,
                   "num_hidden_layers": 4, "first_k_dense_replace": 1,
                   "vocab_size": 512, "experts_published": 16,
                   "n_routed_experts": 4, "experts_first": 4, "n_group": 4,
                   "topk_group": 2, "num_experts_per_tok": 4},
        "cell": {"traffic": {"name": "t16384", "loop": "closed",
                             "sequences": 2, "tokens": 80,
                             "link_quant": True, "warmup_vectors": 1,
                             "traced_vectors": 1, "check_vectors": 2,
                             "check_among": 3, "kept_positions": 16},
                 # at this size the program reads 0 against the
                 # reference (bit for bit on the CPU), the control 1e-2
                 # and more, its median position ~7e-3; the cell's own
                 # limits are set at full size on the card
                 "limits": {"logit_rel_err": 1e-4,
                            "logit_median_rel_err": 1e-4,
                            "agree_gap_positions": 16}}}

SCRIPT = """
import dataclasses, json, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
torch.set_num_threads(2)
from bench.lib import harness
from bench.lib.trace import TraceWindow
ov = json.loads({ov!r})
out = {{}}
for key, control in (("sound", False), ("control", True)):
    r = harness.run_cell({cell!r}, 2**31 + 20261019, 0.5, False, "cpu",
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
# two faults planted in the program's place: the route without its group
# limit (top-4 over all 16), and YaRN off (plain RoPE, 1/sqrt(qk))
setup = drv.setup
def planted(fault):
    def fn(run):
        st = setup(run)
        for u in st.model.units():
            if fault == "groups" and u.kind == "moe":
                u.moe.topk_group = u.moe.n_group
            if fault == "yarn" and u.kind == "mla":
                u.attn.cfg = dataclasses.replace(u.attn.cfg,
                                                 rope_scaling=None)
                u.attn.scale = None
        return st
    return fn
for fault in ("groups", "yarn"):
    drv.setup = planted(fault)
    r = harness.run_cell({cell!r}, 2**31 + 20261019, 0.5, False, "cpu",
                         overrides=ov)
    out[fault] = {{"correct": r["correct"], "checks": r["checks"]}}
out["forbidden"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def test_cell_at_a_tiny_size_on_the_cpu():
    """The cell's driver, check and control through the harness (in a
    fresh interpreter: the harness refuses a process that loaded JAX):
    sound ``correct``; the control and both planted faults not; the
    traced path's span metrics and counters."""
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
    for fault in ("groups", "yarn"):
        assert not out[fault]["correct"], (fault, out[fault])
        med = out[fault]["checks"]["logit_median_rel_err"]
        assert med["value"] > 10 * med["limit"], (fault, med)
    tr = out["traced"]
    assert set(tr) == {"mla_ms.deepseek_v3", "mfu.deepseek_v3",
                       "device_idle.deepseek_v3", "moe_ms.deepseek_v3",
                       "weight_quant_ms.deepseek_v3"}
    assert tr["mla_ms.deepseek_v3"] > 0
    assert tr["moe_ms.deepseek_v3"] > 0
    assert tr["weight_quant_ms.deepseek_v3"] > 0
    assert tr["mfu.deepseek_v3"] is None       # no device trace here
    assert tr["device_idle.deepseek_v3"] is None
    n = out["vectors"]
    assert n >= 1
    assert out["counters"]["moe_rows.routed"] == n * 3 * 2 * 80 * 4
    assert 0 < out["counters"]["moe_rows.held"] < \
        out["counters"]["moe_rows.routed"]
    assert out["forbidden"] == []
