"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``repro`` so each port sits where its counterpart does.
The package imports ``torch`` and numpy only: host logic that ``repro``
keeps in numpy modules is copied here, never imported.

The port serves dlrm-qr, dlrm-dense and dlrm-tt end to end
(``repro_torch.launch.serve_rec.run_pipeline``).  The embedding layer of one
batch is one launch of a hand-written CUDA kernel (``csrc/packed_gather.cu``
for QR and dense, ``csrc/tt_bag.cu`` for TT, wrapped by
``kernels/packed_gather.py``).  The per-table paths run the same way:
``EmbeddingEngine.cached_lookup`` and ``lookup``, the ``kernels.ops`` bag
entry points (``kernels/cached_gather.py``, ``gnr_bag.py``,
``qr_gather.py`` over ``csrc/packed_gather.cu`` and ``csrc/qr_gather.cu``)
and every embedding kind, hashed included.  DLRM trains through
``EmbeddingEngine.lookup`` (``repro_torch.launch.train``, ``train/``,
``checkpoint/``): every kernel entry point is differentiable, its backward
recomputing the plain version.  Attention runs through
``kernels.ops.flash_attention_fused`` (``csrc/flash_attention.cu``).  On
CPU tensors the same wrappers take their plain PyTorch versions.
Around the serving path: ``obs`` (telemetry), ``tune`` (the trace-driven
autotuner ``engine.plan(tuner=)`` consumes), ``serve`` (the resilient front
end and its degradation ladder) and ``adapt`` (online re-planning).  The
sharded two-level GnR (``EmbeddingEngine.gnr`` / ``forward_partial`` /
``inline_gnr`` / ``baseline``, ``core.sharded_embedding``) runs one process
per mesh rank under ``torch.distributed`` (``launch.mesh.spawn`` and
``make_mesh``, ``distributed.sharding`` and ``collectives``): each rank's
partial is one packed launch on its row shard, one psum combines them.
``repro_torch.examples`` holds the quickstart, the cache walkthrough, the
DLRM training example and the autotuner walkthrough.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
