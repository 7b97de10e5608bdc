"""granite-moe-3b-a800m [moe] — 40 experts top-8, tiny per-expert FFN.

The assigned config line says 40 experts; the HF card for the 1b-a400m base
says 32 — we follow the explicit assigned numbers.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Port of ``repro.configs.granite_moe_3b_a800m``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    num_experts=40,
    top_k=8,
    activation="silu",
    norm="rms",
    tie_embedding=True,
)

SMOKE = CONFIG.replace(
    name="granite-moe-3b-a800m-smoke", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=64, vocab=512, num_experts=8, top_k=2,
)
