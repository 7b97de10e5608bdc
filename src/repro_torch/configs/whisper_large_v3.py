"""whisper-large-v3 [audio] — encoder–decoder; conv/mel frontend STUBBED
(input_specs supplies precomputed frame embeddings). [arXiv:2212.04356]

Port of ``repro.configs.whisper_large_v3``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=64,                 # 32 enc + 32 dec
    d_model=1280,
    num_heads=20,
    kv_heads=20,                   # full MHA
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    is_encoder_decoder=True,
    enc_layers=32,
    dec_layers=32,
    qkv_bias=True,
    activation="gelu",
    norm="layer",
    tie_embedding=True,
)

SMOKE = CONFIG.replace(
    name="whisper-large-v3-smoke", num_layers=4, enc_layers=2, dec_layers=2,
    d_model=64, num_heads=4, kv_heads=4, head_dim=16, d_ff=128, vocab=512,
)
