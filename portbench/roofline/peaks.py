"""Published peaks of one NVIDIA H100 SXM5 80GB (data sheet, dense rates,
no sparsity, at its full 700 W power limit), and the nominal rate of the
host link the Engram tables in host memory are read over."""

BF16_FLOP_PER_S = 989e12        # tensor cores, bf16 dense
HBM_BYTES_PER_S = 3.35e12       # HBM3
PCIE_BYTES_PER_S = 64e9         # PCIe Gen5 x16, one direction, nominal
