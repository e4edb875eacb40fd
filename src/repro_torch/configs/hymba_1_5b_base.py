"""hymba-1.5b-base [hybrid] at its published structure: attention and
mamba heads side by side in all 32 blocks; global attention in layers 0,
15 and 31, a 1,024-token sliding window in the other 29; 128 meta tokens
before every sequence; consecutive window layers sharing one k/v cache;
mamba heads of twice the model width, ssm_state=16.  Tied embeddings.
[arXiv:2411.13676 §2; the model card nvidia/Hymba-1.5B-Base]

The JAX package has no such config: ``configs/hymba_1_5b.py`` is its
paper-table entry (a global layer every 11, no meta tokens, no sharing).
The k/v sharing runs are the model card's ``kv_reuse_group``.
"""
from repro_torch.models.config import HymbaConfig

CONFIG = HymbaConfig(
    name="hymba-1.5b-base", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, tie_embeddings=True, norm_eps=1e-6,
    ssm_state=16, ssm_conv=4, mamba_expand=2, sliding_window=1024,
    global_layers=(0, 15, 31), meta_tokens=128,
    kv_groups=((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
               (16, 17, 18), (19, 20), (21, 22), (23, 24), (25, 26),
               (27, 28), (29, 30)),
)

# Every kind at a CPU-test size: global layers 0 and 4, window layers 1
# and 2 sharing a cache and layer 3 with its own, 8 meta tokens, a window
# of 8.
REDUCED = HymbaConfig(
    name="hymba-1.5b-base", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, tie_embeddings=True, norm_eps=1e-6,
    ssm_state=4, ssm_conv=4, mamba_expand=2, sliding_window=8,
    global_layers=(0, 4), meta_tokens=8, kv_groups=((1, 2),),
)
