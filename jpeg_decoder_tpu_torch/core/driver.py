"""Shared per-scan decode loop.

JPEG table state is mutable stream state (DHT/DQT/DRI may be redefined
between scans; the reference keeps them as mutable locals in
decode_jpeg_buffer, reference/src/decode.c:146-158). Every entropy
backend needs the same loop — accumulate the quant-table state a scan sees,
then dispatch the scan — so it lives here once instead of being repeated
per backend (oracle / numpy / native / device).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .types import CoefficientPlanes, JpegStructure, Scan


def run_scans(
    structure: JpegStructure,
    planes: CoefficientPlanes,
    decode_scan: Callable[[JpegStructure, Scan, CoefficientPlanes], None],
) -> dict[int, np.ndarray]:
    """Decode every scan into `planes`; returns qtid -> natural-order
    quant-table values (the accumulated table state after all scans)."""
    qts: dict[int, np.ndarray] = {}
    for scan in structure.scans:
        for tid, qt in scan.quant_tables.items():
            qts[tid] = qt.values
        decode_scan(structure, scan, planes)
    return qts


def scan_deps(scans: list[Scan]) -> list[list[int]]:
    """Dependency edges for out-of-order scan execution.

    Scan j depends on an earlier scan i iff they share a scan component
    AND their spectral bands [ss..se] overlap: progressive successive-
    approximation passes of the same (component, band) must run in stream
    order (each refine reads the coefficients the previous pass wrote,
    spec G.1.2), while scans of disjoint components or disjoint bands
    touch disjoint coefficients — a Pillow-style scan script's chroma AC
    chains are independent of the luma chain and of the DC chain. Each
    scan carries its own parsed table state (Scan.dc/ac/quant_tables), so
    DHT/DQT redefinition between scans imposes no extra ordering."""
    comps: list[set] = []
    bands: list[tuple[int, int]] = []
    for s in scans:
        comps.append({c.sc for c in s.header.components})
        bands.append((s.header.ss, s.header.se))
    deps: list[list[int]] = []
    for j in range(len(scans)):
        deps.append([
            i for i in range(j)
            if comps[i] & comps[j]
            and bands[i][0] <= bands[j][1] and bands[j][0] <= bands[i][1]
        ])
    return deps


def run_scans_parallel(
    structure: JpegStructure,
    planes: CoefficientPlanes,
    decode_scan: Callable[[JpegStructure, Scan, CoefficientPlanes], None],
    max_workers: int = 0,
) -> dict[int, np.ndarray]:
    """run_scans with independent scans decoded CONCURRENTLY.

    The scan scheduler for restart-free progressive streams: each scan's
    entropy data is bit-serial (no restart seam), so the remaining
    parallelism axis is ACROSS scans — the dependency DAG from
    scan_deps() lets the chroma AC chains and the DC chain decode under
    the (critical-path) luma chain. decode_scan must release the GIL for
    its bit work (the native backend does). Writes from concurrent scans
    go to disjoint coefficients by construction of the DAG.

    Failure contract: matches run_scans — the raised error is the
    FIRST-IN-STREAM-ORDER failing scan's error (later concurrent
    failures are suppressed), so corrupt-stream tests see identical
    typed errors regardless of execution order.
    """
    import concurrent.futures as cf
    import os

    scans = structure.scans
    qts: dict[int, np.ndarray] = {}
    for scan in scans:
        for tid, qt in scan.quant_tables.items():
            qts[tid] = qt.values
    n = len(scans)
    deps = scan_deps(scans)
    if max_workers <= 0:
        max_workers = min(n, os.cpu_count() or 1)
    if n <= 1 or max_workers <= 1:
        for scan in scans:
            decode_scan(structure, scan, planes)
        return qts

    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures: dict[int, cf.Future] = {}
        completed: set[int] = set()
        failures: dict[int, BaseException] = {}
        while len(completed) + len(failures) < n:
            for i in range(n):
                if i not in futures and all(
                    d in completed for d in deps[i]
                ):
                    futures[i] = ex.submit(
                        decode_scan, structure, scans[i], planes
                    )
            inflight = {
                f: i for i, f in futures.items()
                if i not in completed and i not in failures
            }
            if not inflight:
                break  # remaining scans depend on a failed one
            done, _ = cf.wait(
                inflight.keys(), return_when=cf.FIRST_COMPLETED
            )
            for f in done:
                i = inflight[f]
                err = f.exception()
                if err is not None:
                    failures[i] = err
                else:
                    completed.add(i)
    if failures:
        raise failures[min(failures)]
    return qts
