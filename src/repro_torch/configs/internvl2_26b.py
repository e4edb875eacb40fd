"""internvl2-26b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings via input_specs) + InternLM2 backbone.  [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,
    frontend="vision_stub", frontend_tokens=256,
)
