"""Architecture configuration — one frozen dataclass drives every family.

The same dataclass as the JAX package's ``models/config.py``, copied so
the port imports nothing of that package.  Families: dense
(granite/qwen3/olmo/starcoder2), moe (kimi/mixtral), ssm (xlstm), hybrid
(hymba), vlm (internvl — vision stub + LM backbone), audio (whisper —
conv-frontend stub + enc-dec).  The port runs every family.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None       # tokens; None = full attention
    global_attn_every: int = 0              # hybrid: every k-th layer global
    nonparametric_norm: bool = False        # olmo-style LN without params
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0                       # per-expert hidden (kimi 2048)
    n_shared_experts: int = 0               # kimi-style always-on experts
    # Expert-TP: shard each expert's FFN hidden dim over the model axis
    # instead of sharding the expert dim.  Required when n_experts does not
    # divide the model-axis size (mixtral: 8 experts on a 16-way axis would
    # otherwise replicate every expert onto every chip — observed 16x FLOP
    # blow-up, §Perf iteration 1).
    moe_tp: bool = False

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    slstm_every: int = 0                    # xlstm: every k-th block sLSTM
    mlstm_heads: int = 4

    # encoder-decoder / multimodal
    encoder_layers: int = 0
    encoder_seq: int = 0                    # frontend-stub sequence length
    cross_attention: bool = False
    frontend: str | None = None             # audio_stub | vision_stub
    frontend_tokens: int = 0                # prefix tokens from the stub

    # numerics / training
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: str = "block"                    # none | block | full
    optimizer_dtype: str = "float32"        # adam moment dtype
    fsdp: bool = True                       # shard weights over data axis

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def padded_vocab(self) -> int:
        """Embedding/head vocab dim padded to a multiple of 256 so the
        vocab axis shards over the 16-way model axis (and tiles evenly).  Unpadded odd vocabs (granite 49155, internvl 92553,
        whisper 51865, hymba 32001) otherwise replicate the largest matmul
        in the model onto every chip (§Perf iteration 6).  Pad logits are
        masked to -inf in the head, so semantics are unchanged."""
        return ((self.vocab_size + 255) // 256) * 256

    # Target tensor-parallel width the padding helpers align to (the
    # production mesh's model axis).
    TP_WIDTH = 16

    @property
    def padded_heads(self) -> int:
        """Query heads zero-padded *per KV group* so the head axis shards
        over the model axis (starcoder2's 36 heads otherwise replicate
        attention onto every chip — §Perf iteration 8).  Padding preserves
        the GQA q-head -> kv-head mapping (each group pads from g to g_pad),
        and padded heads have zero wq/wo so the output is bit-identical.
        Capped at 1.5x overhead: archs where alignment would cost more
        (hymba: 25 heads / 5 kv would need 80) stay unpadded and are
        recorded as replicated dims in the dry-run report instead."""
        h, kv = self.n_heads, self.n_kv_heads
        if h % self.TP_WIDTH == 0 or kv == 0:
            return h
        g = h // kv
        g_pad = g
        while (kv * g_pad) % self.TP_WIDTH != 0:
            g_pad += 1
        h_pad = kv * g_pad
        return h_pad if h_pad <= 1.5 * h else h

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def mamba_width(self) -> int:
        """Channels of a hybrid block's mamba heads (u, z, the conv and the
        state): the model width."""
        return self.d_model

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence scaling: SSM state or sliding window."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def has_decode_step(self) -> bool:
        return True     # all assigned archs are decoder-bearing

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                  # head
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        for _ in range(self.n_layers):
            n += attn
            if self.is_moe:
                n += d * self.n_experts               # router
                n += self.n_experts * 3 * d * self.expert_d_ff
                n += self.n_shared_experts * 3 * d * self.expert_d_ff
            elif self.family == "ssm":
                pass                                  # handled below
            if self.d_ff and self.family != "ssm" and not self.is_moe:
                n += 3 * d * self.d_ff                # swiglu
            n += 2 * d                                # norms
        if self.family == "ssm":
            n += self.n_layers * (8 * d * d // 4)     # lstm proj approx
        if self.encoder_layers:
            n += self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.expert_d_ff
        active = self.n_layers * (self.top_k + self.n_shared_experts) \
            * 3 * d * self.expert_d_ff
        return total - all_experts + active


@dataclasses.dataclass(frozen=True)
class HymbaConfig(ModelConfig):
    """A hybrid config at Hymba's published structure (arXiv:2411.13676
    §2): the block of ``ModelConfig``'s hybrid family, with

    - ``global_layers``: the layers that attend every earlier position; the
      others attend within ``sliding_window``;
    - ``meta_tokens``: learned vectors put before every sequence, which
      every layer's attention sees (a window layer's as well as its window)
      and its mamba heads scan first;
    - ``kv_groups``: runs of consecutive layers of one attention kind that
      share one k/v cache, which the run's first layer projects and the
      others read;
    - ``mamba_expand``: the mamba heads' channels over the model width.

    Kept apart from ``ModelConfig`` so that the JAX package's configs,
    which have none of these fields, stay field for field its own.  The
    port serves it on one device (``models/hymba.py``)."""
    global_layers: tuple[int, ...] = ()
    meta_tokens: int = 1
    kv_groups: tuple[tuple[int, ...], ...] = ()
    mamba_expand: int = 1

    def __post_init__(self):
        super().__post_init__()
        L = self.n_layers
        if self.family != "hybrid" or self.sliding_window is None \
                or self.global_attn_every or self.meta_tokens < 1:
            raise ValueError(f"{self.name}: a hybrid config with a sliding "
                             "window, meta tokens, and global_layers in "
                             "place of global_attn_every")
        if not all(0 <= i < L for i in self.global_layers):
            raise ValueError(f"{self.name}: global layers "
                             f"{self.global_layers} outside {L} layers")
        seen: set = set()
        for g in self.kv_groups:
            kinds = {i in self.global_layers for i in g}
            if (len(g) < 2 or list(g) != list(range(g[0], g[0] + len(g)))
                    or len(kinds) > 1 or seen & set(g)
                    or not 0 <= g[0] <= g[-1] < L):
                raise ValueError(f"{self.name}: kv group {g} is not a run "
                                 "of two or more consecutive layers of one "
                                 "kind, apart from the other groups")
            seen |= set(g)

    @property
    def mamba_width(self) -> int:
        return self.mamba_expand * self.d_model

    def is_global(self, lid: int) -> bool:
        return lid in self.global_layers


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One (shape-id x mode) cell of the assignment."""
    name: str                       # train_4k | prefill_32k | ...
    mode: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}
