"""pixtral-12b [vlm] — mistral-nemo decoder backbone; pixtral-ViT frontend
STUBBED (input_specs supplies precomputed patch embeddings).
[hf:mistralai/Pixtral-12B-2409; unverified]

Port of ``repro.configs.pixtral_12b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    activation="silu",
    norm="rms",
    tie_embedding=False,
    num_patches=256,               # stub ViT prefix length (16x16 patch grid)
)

SMOKE = CONFIG.replace(
    name="pixtral-12b-smoke", num_layers=2, d_model=128, num_heads=4, kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, num_patches=8,
)
