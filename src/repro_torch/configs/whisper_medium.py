"""whisper-medium [audio] — enc-dec; conv frontend STUBBED (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_seq=1500, cross_attention=True,
    frontend="audio_stub",
)
