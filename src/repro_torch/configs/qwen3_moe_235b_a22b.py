"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, q/k norm, untied head.
The pool's largest model; the EP + FSDP showcase. [hf:Qwen/Qwen3-30B-A3B; hf]

Port of ``repro.configs.qwen3_moe_235b_a22b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    top_k=8,
    activation="silu",
    norm="rms",
    tie_embedding=False,
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-235b-a22b-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=64, vocab=512, num_experts=8, top_k=2,
)
