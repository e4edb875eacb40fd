"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block;
sliding-window attention with a global layer every 11 (3 global layers of
32), ssm_state=16.  [arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, sliding_window=1024, global_attn_every=11,
)
