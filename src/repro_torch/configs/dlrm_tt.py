"""dlrm-tt: DLRM with TT-Rec (tensor-train) tables, the paper's second
weight-sharing target (port of ``repro.configs.dlrm_tt``).

Factorization: vocab 2M -> (38, 1386, 38), dim 128 -> (4, 8, 4), rank 16.
A G2 row is 16 * 8 * 16 = 2,048 fp32 (8 KiB); one table's outer cores are
~19 KB, all 26 packed ~0.5 MB.
"""

from repro_torch.configs.base import DLRMConfig

CONFIG = DLRMConfig(
    name="dlrm-tt",
    num_tables=26,
    vocab_per_table=2_000_000,
    dim=128,                       # same sweep point as dlrm-qr
    pooling=32,
    embedding_kind="tt",
    tt_rank=16,
    tt_exec="pallas",              # lookups on the card run the TT-bag kernel
)

SMOKE = DLRMConfig(
    name="dlrm-tt-smoke",
    num_tables=4,
    vocab_per_table=4096,
    dim=32,
    pooling=8,
    bottom_mlp=(64, 32),
    top_mlp=(64, 1),
    embedding_kind="tt",
    tt_rank=4,
    tt_exec="pallas",
    cache_slots=128,
)
