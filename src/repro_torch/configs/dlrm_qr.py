"""dlrm-qr and its dense baseline (port of ``repro.configs.dlrm_qr``)."""

import dataclasses

from repro_torch.configs.base import DLRMConfig

CONFIG = DLRMConfig(
    name="dlrm-qr",
    num_tables=26,
    vocab_per_table=2_000_000,
    dim=128,                       # 512 B rows at fp32
    pooling=32,
    embedding_kind="qr",
    qr_collision=64,
)

# The dense (no weight-sharing) baseline the paper compares against.
DENSE_BASELINE = dataclasses.replace(CONFIG, name="dlrm-dense", embedding_kind="dense")

SMOKE = DLRMConfig(
    name="dlrm-qr-smoke",
    num_tables=4,
    vocab_per_table=4096,
    dim=32,
    pooling=8,
    bottom_mlp=(64, 32),
    top_mlp=(64, 1),
    embedding_kind="qr",
    qr_collision=8,
    cache_slots=128,
)

DENSE_SMOKE = dataclasses.replace(
    SMOKE, name="dlrm-dense-smoke", embedding_kind="dense"
)
