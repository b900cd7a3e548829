"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit) and the least time a launch takes, for the rooflines."""

# HBM3 bandwidth, bytes per second.
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores, operations per second.
F32_OPS_PER_S = 67e12
# The least time of any launch: a one-element add replayed from a CUDA
# graph, 0.00101-0.00104 ms on an H100 80GB HBM3 at 700 W.
LAUNCH_FLOOR_S = 1.01e-6


def least_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take to move ``n_bytes`` and do
    ``n_ops`` float32 operations, and never under the launch floor."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S,
               LAUNCH_FLOOR_S)
