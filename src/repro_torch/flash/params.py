"""Hardware parameters — paper Table II, plus Table I bus currents.

All times in nanoseconds, energies in picojoules, currents in mA, voltages
in V.  Derived quantities are properties so a config override stays
consistent.

Geometry note: Table II lists (die, plane, block, page) = (2, 1, 32, 128)
with a 4 KiB *logical* page; the paper's footnote 1 fixes 4 KiB as the
logical page size while 3D-NAND physical pages are 16 KiB.  We model logical
pages directly and size the array to the paper's experimental setup (650 MiB
index = 65 % of visible capacity -> 1 GiB visible), i.e. 512 logical pages
per block.  This scaling is recorded here because the Table II numbers alone
(256 MiB) cannot host the paper's own 650 MiB index.
"""
from __future__ import annotations

import dataclasses

US = 1000.0          # ns per us
MS = 1000.0 * US


@dataclasses.dataclass(frozen=True)
class FlashParams:
    # --- geometry
    channels: int = 8
    dies_per_channel: int = 2
    planes_per_die: int = 1
    blocks_per_plane: int = 32
    pages_per_block: int = 512          # logical 4 KiB pages (see note)
    page_bytes: int = 4096

    # --- array timings (ns)
    t_read_ns: float = 16 * US          # SLC sense
    t_program_ns: float = 80 * US
    t_erase_ns: float = 1 * MS

    # --- SiM match engine
    sim_clock_hz: float = 33e6
    sim_cycles_per_match: int = 10

    # --- internal (ONFi NV-DDR3) bus, 8-bit wide
    bus_width_bits: int = 8
    match_mode_mt_s: float = 80e6       # transfers/s in match mode
    storage_mode_mt_s: float = 800e6

    # --- external PCIe Gen3 interface
    pcie_bus_bits: int = 128
    pcie_clock_hz: float = 250e6

    # --- electrical
    bus_voltage: float = 1.2
    nand_voltage: float = 3.3
    bus_active_ma: float = 5.0          # equalized per §VII-B footnote 5
    bus_idle_ua: float = 10.0
    nand_read_ma: float = 25.0
    nand_program_ma: float = 25.0
    sim_match_ma: float = 2.5
    # Table I peak currents (used only by the power-budget experiments)
    bus_peak_ma_storage: float = 152.0
    bus_peak_ma_match: float = 11.0

    # --- host-side constants
    dram_hit_ns: float = 1 * US         # page-cache hit service time
    cpu_search_ns: float = 2 * US       # host SIMD search of a loaded page
    mmio_ns: float = 1 * US             # NVMe command doorbell/completion
    # Per-I/O kernel cost of the conventional DMA path (block layer, DMA
    # mapping, interrupt, page-cache insertion).  The paper's SiM path
    # "communicates entirely through NVMe's command interface (MMIO) and
    # bypasses the conventional DMA procedures" (§VI-A3) — so this cost is
    # baseline-only.  ~10 us is a standard figure for the Linux NVMe stack.
    host_io_overhead_ns: float = 10 * US

    # ------------------------------------------------------------ derived
    @property
    def n_dies(self) -> int:
        return self.channels * self.dies_per_channel

    @property
    def pages_per_die(self) -> int:
        return (self.planes_per_die * self.blocks_per_plane
                * self.pages_per_block)

    @property
    def total_pages(self) -> int:
        return self.n_dies * self.pages_per_die

    @property
    def capacity_bytes(self) -> int:
        return self.total_pages * self.page_bytes

    @property
    def match_bus_bytes_per_ns(self) -> float:
        return self.match_mode_mt_s * (self.bus_width_bits / 8) / 1e9

    @property
    def storage_bus_bytes_per_ns(self) -> float:
        return self.storage_mode_mt_s * (self.bus_width_bits / 8) / 1e9

    @property
    def pcie_bytes_per_ns(self) -> float:
        return self.pcie_clock_hz * (self.pcie_bus_bits / 8) / 1e9

    @property
    def t_match_ns(self) -> float:
        return self.sim_cycles_per_match / self.sim_clock_hz * 1e9

    def bus_time_ns(self, n_bytes: int, match_mode: bool) -> float:
        bw = (self.match_bus_bytes_per_ns if match_mode
              else self.storage_bus_bytes_per_ns)
        return n_bytes / bw

    def pcie_time_ns(self, n_bytes: int) -> float:
        return n_bytes / self.pcie_bytes_per_ns

    # ------------------------------------------------------------- energy
    # E[pJ] = V * I[mA] * t[ns]  (V * mA * ns = pJ)
    def e_sense_pj(self) -> float:
        return self.nand_voltage * self.nand_read_ma * self.t_read_ns

    def e_program_pj(self) -> float:
        return self.nand_voltage * self.nand_program_ma * self.t_program_ns

    def e_match_pj(self) -> float:
        return self.nand_voltage * self.sim_match_ma * self.t_match_ns

    def e_bus_pj(self, n_bytes: int, match_mode: bool) -> float:
        t = self.bus_time_ns(n_bytes, match_mode)
        return self.bus_voltage * self.bus_active_ma * t


# Payload sizes (paper §VII-B)
BITMAP_BYTES = 64          # search response
CHUNK_BYTES = 64           # gather unit
OPEN_OVERHEAD_BYTES = 256  # verification transfer on page_open
PAGE_BYTES = 4096

DEFAULT_PARAMS = FlashParams()
