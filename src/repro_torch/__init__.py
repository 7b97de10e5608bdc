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
``repro_torch.examples`` holds the quickstart, the cache walkthrough and
the DLRM training example.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
