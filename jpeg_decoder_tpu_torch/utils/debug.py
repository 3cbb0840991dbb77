"""Structure dumps — the runtime-toggleable replacement for the reference's
compile-time debug system (`#define DEBUG 0` + per-module print_* functions,
reference/src/debug.h:2-8, frame_header.c:84-130, scan_header.c:37-81,
huff_table.c:303-354, decode.c:1295-1303). Everything here is available at
runtime (CLI `info`, logging hooks), no recompile needed."""

from __future__ import annotations

from ..core.types import JpegStructure


def structure_summary(s: JpegStructure) -> dict:
    """JSON-friendly dump of everything the marker walk learned."""
    f = s.frame
    return {
        "process": f.process.name,
        "precision": f.precision,
        "width": f.width,
        "height": f.height,
        "mcus": [f.mcus_x, f.mcus_y],
        "components": [
            {
                "id": c.id,
                "sampling": [c.hsf, c.vsf],
                "qtable": c.qtid,
                "size": [c.x, c.y],
                "plane_blocks": [c.blocks_x, c.blocks_y],
            }
            for c in f.components
        ],
        "scans": [
            {
                "components": [
                    {"id": sc.sc, "dc": sc.dc, "ac": sc.ac}
                    for sc in scan.header.components
                ],
                "spectral": [scan.header.ss, scan.header.se],
                "approx": [scan.header.ah, scan.header.al],
                "restart_interval": scan.restart_interval,
                "entropy_bytes": int(scan.span.end - scan.span.start),
                "restart_segments": scan.span.num_segments,
                "tables": {
                    "dc": sorted(scan.dc_tables),
                    "ac": sorted(scan.ac_tables),
                    "quant": sorted(scan.quant_tables),
                },
            }
            for scan in s.scans
        ],
        "app_segments": [
            {"marker": f"APP{m - 0xE0}" if 0xE0 <= m <= 0xEF else "COM",
             "offset": off, "bytes": len(payload)}
            for m, off, payload in s.app_segments
        ],
    }


def print_structure(s: JpegStructure) -> None:
    f = s.frame
    print(f"{f.process.name}, {f.width}x{f.height}, {f.precision}-bit, "
          f"{f.ncs} component(s), {f.mcus_x}x{f.mcus_y} MCUs")
    for c in f.components:
        print(f"  component {c.id}: sampling {c.hsf}x{c.vsf}, "
              f"qtable {c.qtid}, plane {c.x}x{c.y} "
              f"({c.blocks_x}x{c.blocks_y} blocks)")
    for i, scan in enumerate(s.scans):
        h = scan.header
        comps = ",".join(str(sc.sc) for sc in h.components)
        print(f"  scan {i}: comps [{comps}] ss={h.ss} se={h.se} "
              f"ah={h.ah} al={h.al} ri={scan.restart_interval} "
              f"segments={scan.span.num_segments} "
              f"entropy={scan.span.end - scan.span.start}B")
    for m, off, payload in s.app_segments:
        name = f"APP{m - 0xE0}" if 0xE0 <= m <= 0xEF else "COM"
        print(f"  {name} @{off}: {len(payload)} bytes")
