"""FPGA resource envelopes for the toolflow's DSE.

The FPGA device table mirrors Table III/IV of the SATAY paper. A copy of
the FPGA half of the JAX package's ``roofline/hw.py``; this package
states no TPU figure.
"""
from __future__ import annotations

import dataclasses


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
