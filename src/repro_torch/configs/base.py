"""Unified model/run configuration for the assigned architectures.

One :class:`ModelConfig` describes any of the 7 families (dense / moe / ssm /
hybrid / mixed / audio / vlm).  ``reduced()`` produces the CPU smoke-test
variant (≤2 layers, d_model ≤ 512, ≤4 experts) of the same family.

The fields after ``source`` are the port's own (the JAX package's config
has none of them); each defaults to the behaviour every other config has:

* ``layer_types``: the ``mixed`` family's mixer of each layer, ``"mamba"``
  or ``"attention"`` (IBM Granite 4.0-H: a Mamba2 mixer or a GQA attention
  in each layer, each followed by the layer's own gated MLP of width
  ``d_ff``, or, where the config has experts (``n_experts``), by an expert
  layer: ``n_experts`` routed gated experts of width ``moe_d_ff``, top
  ``top_k``, dropless, beside one shared gated MLP of width ``d_ff``); None
  for every other family;
* ``experts_held``: ``(first, count)``, the routed experts this device
  holds of every expert layer (expert parallelism: the router keeps all
  ``n_experts`` outputs, the layer computes its own experts' part); None
  for all of them.  Read by the ``mixed`` family's expert layers;
* ``embedding_multiplier``, ``residual_multiplier``, ``logits_scaling``:
  the token embeddings times the first, each residual branch times the
  second, the logits divided by the third (muP; read by the ``mixed``
  family, 1.0 elsewhere);
* ``attention_scale``: the softmax scale of the attention scores, None for
  1/sqrt(head_dim); ``rope``: rotary position embeddings on q and k
  (False: no positional encoding);
* ``norm_eps``: the eps of every RMSNorm of the LM families.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM architecture: family, widths, attention, MoE, SSM and the
    audio / vlm fields, the dtype, and the port's own fields after
    ``source``: ``layer_types`` (the mixed family's mixer of each layer,
    ``"mamba"`` or ``"attention"``), ``embedding_multiplier``,
    ``residual_multiplier`` and ``logits_scaling`` (muP, the mixed family
    only), ``attention_scale`` (None: 1/sqrt(head_dim)), ``rope`` (False:
    no positional encoding), ``norm_eps`` (every RMSNorm's eps, 1e-6 by
    default) and ``experts_held`` (the mixed family's held share of its
    routed experts, ``(first, count)``; None: all).  Each defaults to the
    behaviour of the configs that have no such field.  In the mixed family
    ``n_experts`` > 0 puts an expert layer after every mixer in place of
    the MLP (``d_ff`` then the shared expert's width)."""

    arch_id: str
    family: str              # dense | moe | ssm | hybrid | mixed | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv: int = 0
    head_dim: Optional[int] = None
    d_ff: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    tied_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0                     # per-expert FFN width
    first_dense: int = 0                  # leading dense layers (DeepSeek)
    sigmoid_gate: bool = False
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mtp: int = 0                          # multi-token-prediction depth
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0                   # hybrid: shared attn block period
    # audio
    n_codebooks: int = 0
    # vlm
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_patches: int = 0                    # vision stub token count
    # numerics / training
    dtype: str = "float32"
    remat: bool = True
    optimizer: str = "adamw"              # adafactor for the 70B+ configs
    # citation for the config source
    source: str = ""
    # the port's own fields (see the module docstring)
    layer_types: Optional[Tuple[str, ...]] = None
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_scale: Optional[float] = None
    rope: bool = True
    norm_eps: float = 1e-6
    experts_held: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        mixed = self.family == "mixed"
        if mixed != (self.layer_types is not None):
            raise ValueError(f"{self.arch_id}: layer_types is given for the "
                             f"mixed family only (family {self.family!r})")
        if mixed and (len(self.layer_types) != self.n_layers or not set(
                self.layer_types) <= {"mamba", "attention"}):
            raise ValueError(f"{self.arch_id}: layer_types must name "
                             f"'mamba' or 'attention' for each of the "
                             f"{self.n_layers} layers")
        if not mixed and (self.embedding_multiplier, self.residual_multiplier,
                          self.logits_scaling) != (1.0, 1.0, 1.0):
            raise ValueError(f"{self.arch_id}: the multipliers are read by "
                             f"the mixed family only")
        if mixed and self.n_experts and not (
                0 < self.top_k <= self.n_experts and self.moe_d_ff):
            raise ValueError(f"{self.arch_id}: the mixed family's expert "
                             f"layer needs top_k in 1 .. n_experts and "
                             f"moe_d_ff")
        if self.experts_held is not None:
            first, count = self.experts_held
            if not mixed or not (self.n_experts and 0 <= first and
                                 1 <= count <= self.n_experts - first):
                raise ValueError(f"{self.arch_id}: experts_held "
                                 f"{self.experts_held} is a (first, count) "
                                 f"share of the mixed family's "
                                 f"{self.n_experts} experts")

    @property
    def resolved_head_dim(self) -> int:
        """``head_dim``, else ``d_model // n_heads``."""
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        from repro_torch.models.registry import count_params_from_config
        return count_params_from_config(self)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims."""
        d = 256 if self.d_model >= 256 else self.d_model
        heads = min(self.n_heads, 4) or 0
        kv = min(self.n_kv, heads) or 0
        if self.n_kv and self.n_heads and self.n_heads != self.n_kv:
            kv = max(1, heads // 2)       # keep GQA grouping
        layers = min(self.n_layers, 2)
        if self.family == "hybrid":
            layers = min(self.attn_every, 6)  # one full shared-attn group
        types = None
        if self.layer_types is not None:
            # each mixer kind once, in order of first use, then the first
            # again: a cut falls on either side of every kind
            kinds = list(dict.fromkeys(self.layer_types))
            types = tuple(kinds + kinds[:1])
            layers = len(types)
        return dataclasses.replace(
            self,
            n_layers=layers,
            layer_types=types,
            d_model=d,
            n_heads=heads, n_kv=kv,
            head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared=min(self.n_shared, 1),
            moe_d_ff=min(self.moe_d_ff, d) if self.moe_d_ff else 0,
            first_dense=min(self.first_dense, 1),
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_dim=32 if self.use_mla else self.qk_nope_dim,
            qk_rope_dim=16 if self.use_mla else self.qk_rope_dim,
            v_head_dim=32 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=min(self.ssm_headdim, 32) if self.ssm_state else 64,
            ssm_chunk=32,
            window=min(self.window, 64) if self.window else None,
            mrope_sections=(8, 12, 12) if self.mrope_sections else None,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            mtp=min(self.mtp, 1),
            remat=False,
            experts_held=None,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
