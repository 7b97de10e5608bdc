"""chatglm3-6b [dense] — 2d (half-rotary) RoPE, GQA kv=2, QKV bias.
[arXiv:2406.12793; hf]

Port of ``repro.configs.chatglm3_6b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    qkv_bias=True,
    partial_rotary=0.5,            # "RoPE 2d": rotate half the head dim
    activation="silu",
    norm="rms",
    tie_embedding=False,
)

SMOKE = CONFIG.replace(
    name="chatglm3-6b-smoke", num_layers=2, d_model=128, num_heads=4, kv_heads=2,
    head_dim=32, d_ff=256, vocab=512,
)
