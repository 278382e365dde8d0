"""Hardware constants for the roofline model: the fields of the JAX
package's ``roofline/hw.py``, with the port's card in its place."""

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bandwidth: float        # B/s per chip
    ici_link_bandwidth: float   # B/s per link
    ici_links: int              # links per chip participating in a collective
    hbm_bytes: float            # capacity per chip


# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet, SXM
# column, at its 700 W maximum power).
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,     # data sheet: BF16 Tensor Core 1,979 TFLOPS
                                # with sparsity; dense is half
    hbm_bandwidth=3.35e12,      # data sheet: GPU memory bandwidth 3.35 TB/s
    # data sheet: one ConnectX-7 port of 400 Gb/s a GPU (NVIDIA DGX H100).
    # Every collective of the 16x16 and 2x16x16 meshes crosses 8-GPU
    # nodes, so this single link, not NVLink's 900 GB/s inside a node,
    # bounds it: the conservative single-link accounting
    ici_link_bandwidth=50e9,
    ici_links=1,
    hbm_bytes=80e9,             # data sheet: GPU memory 80 GB
)
