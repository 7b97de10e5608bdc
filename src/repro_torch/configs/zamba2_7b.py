"""zamba2-7b [hybrid] — Mamba2 backbone + shared full-MHA block every 6 layers.
[arXiv:2411.15242; unverified]

Port of ``repro.configs.zamba2_7b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,                  # 3584 / 32
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=2,
    attn_every=6,                  # 13 shared-attention application sites
    activation="gelu",
    norm="rms",
    tie_embedding=True,
)

SMOKE = CONFIG.replace(
    name="zamba2-7b-smoke", num_layers=4, d_model=64, num_heads=4, kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, ssm_state=16, ssm_head_dim=16, ssm_groups=1,
    attn_every=2,
)
