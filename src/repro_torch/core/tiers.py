"""Memory-system specifications for heterogeneous KV-cache placement
(the port's own copy of the reference's spec table, plus the H100),
and the compute-roofline constants of one H100 (`H100_CHIP`).

The paper (Table I) models an NVIDIA GH200: HBM3 + NVLink-C2C attached
LPDDR5X. The spec is data, so the same latency model prices the
paper-faithful GH200 and the H100 + PCIe host this port runs on.

All bandwidths are bytes/second, capacities in bytes.
"""

from __future__ import annotations

import dataclasses

GB = 1024**3
GBps = 1e9  # vendor bandwidth figures are decimal
TBps = 1e12


@dataclasses.dataclass(frozen=True)
class MemorySystemSpec:
    """Two-tier memory system: HBM + off-package DRAM behind a serial link.

    Attributes mirror the paper's Table I / Section III-A symbols:
      hbm_bw          B_h  — HBM bandwidth
      hbm_capacity         — HBM bytes available to the KV cache
      link_bw         B_k  — uni-directional serial-link bandwidth
                             (NVLink-C2C / PCIe); full duplex
      dram_bw         B_d  — internal DDR/LPDDR channel bandwidth
      dram_capacity        — off-package DRAM capacity
    """

    name: str
    hbm_bw: float
    hbm_capacity: float
    link_bw: float
    dram_bw: float
    dram_capacity: float

    @property
    def effective_dram_read_bw(self) -> float:
        # Reads from off-package DRAM traverse both the DRAM channels and
        # the serial link; Eq. (4) charges them at min(B_k, B_d).
        return min(self.link_bw, self.dram_bw)

    @property
    def bw_ratio(self) -> float:
        """HBM : effective-DRAM read bandwidth ratio (the fault plane's
        fallback compares a degraded spec's ratio with the base's)."""
        return self.hbm_bw / self.effective_dram_read_bw

    def with_kv_budget(self, kv_bytes: float) -> "MemorySystemSpec":
        """Spec with HBM capacity replaced by an explicit KV budget."""
        return dataclasses.replace(self, hbm_capacity=kv_bytes)


# --- Paper-faithful configuration (Table I) --------------------------------
GH200 = MemorySystemSpec(
    name="gh200",
    hbm_bw=4.9 * TBps,
    hbm_capacity=24 * GB,
    link_bw=900 * GBps,
    dram_bw=500 * GBps,
    dram_capacity=480 * GB,
)

# --- NVIDIA H100 SXM on a PCIe Gen5 host ------------------------------------
# hbm_bw, hbm_capacity: NVIDIA H100 Tensor Core GPU datasheet, SXM form
#   factor — 80 GB of HBM3 at 3.35 TB/s.
# link_bw: the same datasheet lists the host interface as "PCIe Gen5:
#   128 GB/s", i.e. x16 at 32 GT/s — 64 GB/s in each direction (PCI-SIG
#   PCIe 5.0 base specification; 128b/130b encoding ~63 GB/s usable).
# dram_bw: a 4th-gen Intel Xeon Scalable host socket — 8 channels of
#   DDR5-4800 at 38.4 GB/s each = 307.2 GB/s (Intel product brief).
# dram_capacity: NVIDIA DGX H100 datasheet — 2 TB of system memory.
H100 = MemorySystemSpec(
    name="h100",
    hbm_bw=3.35 * TBps,
    hbm_capacity=80 * GB,
    link_bw=64 * GBps,
    dram_bw=307.2 * GBps,
    dram_capacity=2048 * GB,
)

SPECS = {s.name: s for s in (GH200, H100)}


# --- Compute-roofline constants of the dry-run target (one H100) -------------
@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float   # FLOP/s
    hbm_bw: float            # bytes/s
    ici_bw: float            # bytes/s per link (uni-directional)
    hbm_capacity: float


# NVIDIA H100 Tensor Core GPU datasheet, SXM form factor: 989 TFLOP/s
# dense bf16 (without sparsity), 80 GB of HBM3 at 3.35 TB/s, NVLink at
# 900 GB/s total, i.e. 450 GB/s each way (the chip-to-chip term; a
# one-card run has no collective to put on it). hbm_capacity is what a
# program can have of the 80 GB: `torch.cuda.get_device_properties(0)
# .total_memory` on an NVIDIA H100 80GB HBM3, 85,017,493,504 bytes
# (`chip_smoke.py` phases 8 and 9 print it), less than 80 * 2**30.
H100_CHIP = ChipSpec(
    name="h100",
    peak_flops_bf16=989e12,
    hbm_bw=3.35 * TBps,
    ici_bw=450 * GBps,
    hbm_capacity=85_017_493_504,
)
