"""Hardware constants for roofline analysis.

The port's target device is the NVIDIA H100 SXM5 (``H100_SXM``): its
peaks feed ``roofline/analysis.py``, which every bound of the port and
of ``chip_smoke.py`` reads. The FPGA device table mirrors Table III/IV
of the SATAY paper and feeds the toolflow's DSE. This package states no
TPU figure.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GpuChip:
    """One GPU's peaks, by the math a kernel runs (``peak``)."""
    name: str
    peak_fp32_flops: float       # FLOP/s, fp32 outside the tensor cores
    peak_tf32_flops: float       # FLOP/s, TF32 tensor cores, dense
    peak_bf16_flops: float       # FLOP/s, bf16 tensor cores, dense
    peak_int8_ops: float         # OP/s, int8 tensor cores, dense
    hbm_bytes: int               # device memory
    hbm_bw: float                # bytes/s
    nvlink_bw_per_link: float    # bytes/s per NVLink link, one direction
    nvlink_links: int
    sm_count: int
    smem_per_sm: int             # shared memory per SM, bytes
    l2_bytes: int

    def peak(self, math: str) -> float:
        """The peak rate of ``math``: ``fp32``, ``tf32``, ``bf16`` or
        ``int8``."""
        try:
            return {"fp32": self.peak_fp32_flops,
                    "tf32": self.peak_tf32_flops,
                    "bf16": self.peak_bf16_flops,
                    "int8": self.peak_int8_ops}[math]
        except KeyError:
            raise ValueError(f"unknown math {math!r}: fp32, tf32, bf16 or "
                             f"int8") from None


# NVIDIA H100 SXM5 datasheet, the card "NVIDIA H100 80GB HBM3, 700 W".
# The tensor-core peaks are the dense ones (the datasheet's figures with
# sparsity halved; TF32's 494.5 taken as 495).
H100_SXM = GpuChip(
    name="h100-sxm",
    peak_fp32_flops=67e12,       # NVIDIA H100 80GB HBM3, 700 W: FP32
    peak_tf32_flops=495e12,      # NVIDIA H100 80GB HBM3, 700 W: TF32, dense
    peak_bf16_flops=989.5e12,    # NVIDIA H100 80GB HBM3, 700 W: BF16, dense
    peak_int8_ops=1979e12,       # NVIDIA H100 80GB HBM3, 700 W: INT8, dense
    hbm_bytes=80 * 10**9,        # NVIDIA H100 80GB HBM3, 700 W: 80 GB
    hbm_bw=3.35e12,              # NVIDIA H100 80GB HBM3, 700 W: 3.35 TB/s
    nvlink_bw_per_link=25e9,     # NVIDIA H100 80GB HBM3, 700 W: 900 GB/s
    nvlink_links=18,             # both ways over 18 NVLink 4 links
    sm_count=132,                # NVIDIA H100 80GB HBM3, 700 W: 132 SMs
    smem_per_sm=228 * 1024,      # NVIDIA H100 80GB HBM3, 700 W: 228 KB
    l2_bytes=50 * 2**20,         # NVIDIA H100 80GB HBM3, 700 W: 50 MB L2
)

DEFAULT_CHIP = H100_SXM


@dataclasses.dataclass(frozen=True)
class FpgaDevice:
    """FPGA resource envelopes used by the paper-faithful DSE benchmarks.

    Numbers are the public resource counts of the AMD/Xilinx parts the
    paper evaluates (Table III/IV).
    """
    name: str
    dsp: int
    bram36: int            # 36Kb BRAM blocks
    uram: int              # 288Kb URAM blocks
    lut: int
    f_clk: float           # design clock, Hz
    ddr_bw: float          # off-chip bandwidth, bytes/s

    @property
    def onchip_bytes(self) -> int:
        return int(self.bram36 * 36_864 / 8 + self.uram * 294_912 / 8)


ZCU104 = FpgaDevice("zcu104", dsp=1728, bram36=312, uram=96, lut=230_400,
                    f_clk=200e6, ddr_bw=135e9 / 8)
U250 = FpgaDevice("u250", dsp=12_288, bram36=2688, uram=1280, lut=1_728_000,
                  f_clk=200e6, ddr_bw=77e9)
VCU110 = FpgaDevice("vcu110", dsp=1800, bram36=3180, uram=0, lut=1_074_240,
                    f_clk=200e6, ddr_bw=19.2e9)
VCU118 = FpgaDevice("vcu118", dsp=6840, bram36=2160, uram=960, lut=1_182_240,
                    f_clk=255e6, ddr_bw=38.4e9)

FPGA_DEVICES = {d.name: d for d in (ZCU104, U250, VCU110, VCU118)}
