"""Constraint-file generation (paper Sec. II-C step 3).

Emits the XDC (Vivado) and SDC-style (VTR/VPR) artifacts the paper's Python
environment writes: one pblock per voltage island with its slice range, the
clustered MAC cells pinned inside, and the clock constraint.  There is no P&R
engine in this container to consume them — they are produced as textual
artifacts exactly as the paper's flow hands them to the vendor tool.
"""

from __future__ import annotations

from typing import List

from .partition import Floorplan


def mac_cell_name(mac_id: int, array_n: int) -> str:
    i, j = divmod(mac_id, array_n)
    return f"GEN_REG_I[{i}].GEN_REG_J[{j}].uut"


def generate_xdc(fp: Floorplan, clock_ns: float = 10.0,
                 design: str = "systolic_array") -> str:
    """Vivado XDC: create_pblock / resize_pblock / add_cells_to_pblock."""
    lines: List[str] = [
        f"# auto-generated voltage-island constraints for {design} "
        f"({fp.array_n}x{fp.array_n})",
        f"create_clock -period {clock_ns:.3f} -name clk [get_ports clk]",
    ]
    for p in fp.partitions:
        name = f"pblock_vccint_{p.index + 1}"
        lines.append(f"create_pblock {name}")
        lines.append(f"resize_pblock {name} -add {{{p.slice_range()}}}")
        cells = " ".join(mac_cell_name(m, fp.array_n) for m in p.mac_ids)
        lines.append(f"add_cells_to_pblock {name} [get_cells {{{cells}}}]")
        if p.v_ccint == p.v_ccint:  # not NaN
            lines.append(f"# V_CCINT rail for partition {p.index + 1}: "
                         f"{p.v_ccint:.4f} V")
    return "\n".join(lines) + "\n"


def generate_sdc(fp: Floorplan, clock_ns: float = 10.0) -> str:
    """VTR/VPR SDC: clock + per-partition placement region comments (VPR takes
    placement regions via its own constraint syntax; we mirror the paper's
    script output)."""
    lines = [f"create_clock -period {clock_ns:.3f} clk"]
    for p in fp.partitions:
        cells = ", ".join(mac_cell_name(m, fp.array_n) for m in p.mac_ids[:4])
        more = "" if p.n_macs <= 4 else f", ... ({p.n_macs} MACs)"
        lines.append(f"# region partition-{p.index + 1} "
                     f"x[{p.x0}:{p.x1}] y[{p.y0}:{p.y1}] "
                     f"vccint={p.v_ccint:.4f} cells: {cells}{more}")
    return "\n".join(lines) + "\n"
