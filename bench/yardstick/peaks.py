"""Published peaks of the card the benchmark runs on: one NVIDIA H100 SXM
(NVIDIA's data sheet, at its full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
