"""xlstm-125m [ssm] — mLSTM backbone with sLSTM blocks interleaved (1:4),
attention-free (d_ff=0: mLSTM blocks carry their own projection FFN).
[arXiv:2405.04517; unverified]

Port of ``repro.configs.xlstm_125m``: the same values.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    slstm_every=4,                 # blocks 3, 7, 11 are sLSTM
    norm="layer",
    tie_embedding=True,
)

SMOKE = CONFIG.replace(
    name="xlstm-125m-smoke", num_layers=4, d_model=64, num_heads=4, kv_heads=4,
    head_dim=16, vocab=512, slstm_every=2,
)
