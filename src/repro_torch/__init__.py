"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Module paths mirror ``repro`` so each port sits where its counterpart does.
The package imports ``torch`` and numpy only: host logic that ``repro``
keeps in numpy modules is copied here, never imported.

This slice serves dlrm-qr and dlrm-dense end to end
(``repro_torch.launch.serve_rec.run_pipeline``).  The embedding layer of one
batch is one launch of a hand-written CUDA kernel
(``csrc/packed_gather.cu``, wrapped by ``kernels/packed_gather.py``); on CPU
tensors the same wrappers take their plain PyTorch versions.  TT tables are
the next slice and raise ``NotImplementedError``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

# what every TT (and hashed) branch of this slice raises
TT_NEXT = "TT: next slice"
