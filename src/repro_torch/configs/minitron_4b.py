"""minitron-4b [dense] — pruned nemotron: squared-ReLU MLP, partial RoPE,
256k vocab (the pool's largest embedding table — prime QR target).
[arXiv:2407.14679; hf]

Port of ``repro.configs.minitron_4b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    kv_heads=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
    partial_rotary=0.5,
    activation="relu2",
    norm="layer",
    tie_embedding=False,
)

SMOKE = CONFIG.replace(
    name="minitron-4b-smoke", num_layers=2, d_model=128, num_heads=4, kv_heads=2,
    head_dim=32, d_ff=256, vocab=512,
)
