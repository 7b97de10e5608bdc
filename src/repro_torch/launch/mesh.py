"""Hardware constants of one NVIDIA H100 (the port's counterpart of the
constants in ``repro.launch.mesh``; the mesh builder comes with the sharded
slice).

Rates are the NVIDIA H100 Tensor Core GPU datasheet's, SXM5 column (dense,
without sparsity), at the card's full power limit of 700 W; a card set
below it runs slower under load.  The names ``obs.attribution`` reads
(``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW_PER_LINK``) are ``repro``'s, so
the attribution reads like the reference.  ``DISPATCH_OVERHEAD_S`` is the
one number measured here rather than read from the datasheet.
"""

from __future__ import annotations

# datasheet, H100 SXM5: bf16 Tensor Core 989 TFLOP/s (dense)
PEAK_FLOPS_BF16 = 989e12
# datasheet, H100 SXM5: FP32 67 TFLOP/s (CUDA cores)
PEAK_FLOPS_FP32 = 67e12
# datasheet, H100 SXM5: GPU memory bandwidth 3.35 TB/s (HBM3)
HBM_BW = 3.35e12
# datasheet, H100 SXM5: GPU memory 80 GB
HBM_PER_CHIP = 80e9
# datasheet, H100 SXM5: NVLink 900 GB/s, the sum over its 18 NVLink-4 links
# of both directions
NVLINK_BW = 900e9
NVLINK_LINKS = 18
# one NVLink link, both directions: 900 GB/s / 18 = 50 GB/s (the attribution
# prices a cross-card combine at two of them, as repro prices two ICI links)
ICI_BW_PER_LINK = NVLINK_BW / NVLINK_LINKS
# datasheet, H100 SXM5: PCIe Gen5 128 GB/s (x16, both directions); the host
# link one way is half of it
HOST_LINK_BW = 128e9 / 2

# Host cost of one kernel launch through the port's wrappers: a one-table
# bag's back-to-back time minus its time replayed in a CUDA graph, the median
# over K4b, K6, K4a and K7 at (2,048, 32) (0.0372, 0.0316, 0.0343, 0.0139 ms),
# read from chip_smoke.py's "launch overhead" line on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit.  It varies from run to run with the host.
DISPATCH_OVERHEAD_S = 33.0e-6
