"""Walkthrough of the ProactivePIM cache subsystem (port of
``examples/cache_plan.py``): trace -> intra-GnR analyzer -> duplication
plan -> prefetch scheduler -> the cached QR bag kernel K4b
(``ops.cached_qr_pooled``), one launch per batch, each held against its
plain version.

Run:  PYTHONPATH=src python -m repro_torch.examples.cache_plan [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.cache import duplication, intra_gnr
from repro_torch.cache.sram_cache import PrefetchScheduler
from repro_torch.core import embedding_bag, placement
from repro_torch.core.embedding_bag import BagConfig
from repro_torch.core.qr_embedding import EmbeddingConfig
from repro_torch.data.synthetic import zipf_trace
from repro_torch.kernels import ops, ref


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    dev = device_mod.resolve(ap.parse_args(argv).device)

    emb = EmbeddingConfig(vocab=65_536, dim=128, kind="qr", collision=32,
                          param_dtype=torch.float32, compute_dtype=torch.float32)
    bag = BagConfig(emb=emb, pooling=16)
    pooling = bag.pooling

    # 1. Offline: profile a long-tail trace and measure intra-GnR locality.
    trace = zipf_trace(emb.vocab, 64_000, alpha=1.05, seed=0)
    locs = intra_gnr.analyze_table(trace.reshape(-1, pooling), emb)
    reuse = {k: round(v.mean_intra_reuse, 2) for k, v in locs.items()}
    print("intra-GnR reuse per bag:", reuse)

    # 2. Duplication plan: replicate R (+ hot Q rows) under a per-device budget.
    counts = placement.profile_counts(trace, emb.vocab)
    plan = duplication.plan_duplication([bag], [counts], num_shards=8,
                                        budget_bytes=1 * 2**20)
    t = plan.tables[0]
    print(f"duplication: replicated={t.replicated_bytes}B "
          f"hot_rows={t.hot_plan.num_hot} comm_free={t.comm_free} "
          f"local_share={t.local_share:.2f}")

    # 3. Serving: double-buffered prefetch + the cached gather kernel.
    params = embedding_bag.init_tables([bag], generator=torch.Generator(dev).manual_seed(0),
                                       device=dev)[0]
    sched = PrefetchScheduler(emb.qr_spec.q_rows, num_slots=512,
                              value=locs["q"].prefetch_value())
    batches = [zipf_trace(emb.vocab, 64 * pooling, seed=1, step=s).reshape(-1, pooling)
               for s in range(4)]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    sched.prefetch(batches[0] // emb.collision)          # cold-start staging
    for s, idx in enumerate(batches):
        q_idx, r_idx = up(idx // emb.collision), up(idx % emb.collision)
        slot = up(sched.slots_for(idx // emb.collision))
        cache = params["q"][up(sched.cache_rows()).long()]  # staging copy
        out = ops.cached_qr_pooled(params["q"], cache, params["r"], q_idx, slot, r_idx)
        expect = ref.cached_qr_bag_ref(params["q"], cache, params["r"], q_idx, slot, r_idx)
        torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-5)
        if s + 1 < len(batches):                         # the prefetch hook
            sched.prefetch(batches[s + 1] // emb.collision)
    st = sched.stats
    print(f"served {st.batches} batches: hit rate {st.hit_rate:.3f}, "
          f"staged {st.staged_per_batch:.1f} rows/batch")
    tr = st.traffic_bytes(emb.dim * 4)
    print(f"modeled DRAM bytes: {tr['cached']} vs uncached {tr['baseline']} "
          f"({tr['cached'] / tr['baseline']:.2f}x)")
    return {"reuse": reuse, "replicated_bytes": t.replicated_bytes,
            "hot_rows": t.hot_plan.num_hot, "batches": st.batches,
            "hit_rate": st.hit_rate, "staged_per_batch": st.staged_per_batch,
            "traffic": tr}


if __name__ == "__main__":
    main()
