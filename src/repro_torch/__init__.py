"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``repro`` so each port sits where its counterpart does.
The package imports ``torch`` and numpy only: host logic that ``repro``
keeps in numpy modules is copied here, never imported.

The port serves dlrm-qr, dlrm-dense and dlrm-tt end to end
(``repro_torch.launch.serve_rec.run_pipeline``).  The embedding layer of one
batch is one launch of a hand-written CUDA kernel (``csrc/packed_gather.cu``
for QR and dense, ``csrc/tt_bag.cu`` for TT, wrapped by
``kernels/packed_gather.py``); on CPU tensors the same wrappers take their
plain PyTorch versions.  Hashed tables wait for the per-table slice and
raise ``NotImplementedError``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

# what every hashed-kind branch raises until the per-table slice
HASHED_NEXT = "hashed tables: per-table slice"
