"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB data sheet: 3.35 TB/s of HBM3 bandwidth, at the
card's full power limit of 700 W. A card set below that limit runs
slower under load, so every roofline share is printed with the power
limit that `nvidia-smi` reports beside it.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM5 80GB data sheet, 3.35 TB/s HBM3 at 700 W"
