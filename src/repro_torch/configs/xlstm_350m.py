"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (pattern 3:1), no FFN (d_ff=0).
[arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=4, mlstm_heads=4,
)
