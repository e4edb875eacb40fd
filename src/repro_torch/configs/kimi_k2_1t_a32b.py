"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 experts top-8 + 1 shared
expert, d_ff(expert)=2048 (paper-table entry).  [arXiv:2501.kimi2; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    optimizer_dtype="bfloat16",
)
