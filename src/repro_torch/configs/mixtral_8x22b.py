"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, moe_d_ff=16384,
    sliding_window=4096,
    moe_tp=True,    # 8 experts < 16-way model axis: shard expert FFNs
)
