"""qwen2-1.5b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]

Port of ``repro.configs.qwen2_1_5b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="silu",
    norm="rms",
    tie_embedding=True,
)

SMOKE = CONFIG.replace(
    name="qwen2-1.5b-smoke", num_layers=2, d_model=128, num_heads=4, kv_heads=2,
    head_dim=32, d_ff=256, vocab=512,
)
