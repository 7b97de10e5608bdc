"""granite-34b [dense] — llama-arch code model, MQA (kv=1). [arXiv:2405.04324; hf]

Port of ``repro.configs.granite_34b``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    qkv_bias=True,                 # granite-34b-code keeps bias (gpt-bigcode lineage)
    activation="gelu",
    norm="layer",
    tie_embedding=True,
)

SMOKE = CONFIG.replace(
    name="granite-34b-smoke", num_layers=2, d_model=128, num_heads=4, kv_heads=1,
    head_dim=32, d_ff=256, vocab=512,
)
