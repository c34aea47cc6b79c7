"""Diagnostics writers: the reference's out/*.txt schema + structured JSONL.

The reference writes four text files per run (/root/reference/src/sph.cpp:160-186):

* ``energy.txt``          — "Step, Kinetic Energy, Potential Energy, Total Energy"
* ``angularmomentum.txt`` — "Step, Angular Momentum"
* ``timing.txt``          — "Step, Voxelize, Find Neighbors, Compute Density,
                             Compute Pressure, Compute Acceleration, Integrate"
* ``neighbors.txt``       — "mean, max, min" per step (no header in the ref)

We reproduce the same schemas byte-compatibly (so existing analysis scripts
keep working) and add ``diagnostics.jsonl`` with one structured record per
step.  Under jit the six reference phases fuse into one XLA program, so the
timing file reports the fused step time in the "Integrate" column and zeros
elsewhere unless a per-phase profile is supplied.

If the native C++ writer (``native/sphio``) is built, writes are handed to a
background-thread writer via ctypes; otherwise buffered Python IO is used.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import IO

import numpy as np

from ..state import StepDiagnostics


@dataclass
class DiagnosticsWriter:
    """Streams per-step diagnostics to the reference-compatible files.

    With ``use_native=True`` (default: auto-detect) rows are handed to the
    background-thread writer in ``native/sphio.cpp`` so file IO never blocks
    the dispatch thread.
    """

    out_dir: str = "out"
    write_jsonl: bool = True
    use_native: bool | None = None
    _files: dict[str, IO] = field(default_factory=dict, repr=False)
    _native: object = field(default=None, repr=False)

    def __post_init__(self):
        os.makedirs(self.out_dir, exist_ok=True)
        if self.use_native is None:
            from . import native as native_mod

            self.use_native = native_mod.have_native()
        if self.use_native:
            from .native import AsyncFileWriter

            self._native = AsyncFileWriter()
        self._files["energy"] = self._open("energy.txt")
        self._files["energy"].write("Step, Kinetic Energy, Potential Energy, Total Energy\n")
        self._files["angmom"] = self._open("angularmomentum.txt")
        self._files["angmom"].write("Step, Angular Momentum\n")
        self._files["timing"] = self._open("timing.txt")
        self._files["timing"].write(
            "Step, Voxelize, Find Neighbors, Compute Density, Compute Pressure, "
            "Compute Acceleration, Integrate\n")
        self._files["neighbors"] = self._open("neighbors.txt")
        if self.write_jsonl:
            self._files["jsonl"] = self._open("diagnostics.jsonl")

    def _open(self, name: str) -> IO:
        path = os.path.join(self.out_dir, name)
        if self._native is not None:
            return _NativeStream(self._native, path)
        return open(path, "w", buffering=1 << 16)

    def write_block(self, first_step: int, diags: StepDiagnostics,
                    phase_ms: dict[str, float] | None = None) -> None:
        """Write a block of per-step diagnostics (stacked arrays from scan)."""
        ke = np.asarray(diags.kinetic_energy)
        pe = np.asarray(diags.potential_energy)
        am = np.asarray(diags.angular_momentum)
        nmean = np.asarray(diags.neighbor_mean)
        nmax = np.asarray(diags.neighbor_max)
        nmin = np.asarray(diags.neighbor_min)
        overflow = np.asarray(diags.overflow_cells)
        truncated = np.asarray(diags.truncated_ranges)
        halo_dropped = np.asarray(diags.halo_dropped)
        mig_dropped = np.asarray(diags.migration_dropped)
        n = ke.shape[0] if ke.ndim else 1
        ke, pe, am = np.atleast_1d(ke), np.atleast_1d(pe), np.atleast_1d(am)
        nmean, nmax, nmin = np.atleast_1d(nmean), np.atleast_1d(nmax), np.atleast_1d(nmin)
        overflow = np.atleast_1d(overflow)
        truncated = np.atleast_1d(truncated)
        halo_dropped = np.atleast_1d(halo_dropped)
        mig_dropped = np.atleast_1d(mig_dropped)
        ms = phase_ms or {}
        step_ms = ms.get("step", 0.0)

        for i in range(n):
            s = first_step + i
            self._files["energy"].write(f"{s}, {ke[i]:g}, {pe[i]:g}, {ke[i] + pe[i]:g}\n")
            self._files["angmom"].write(f"{s}, {am[i]:g}\n")
            # reference columns; fused-step time lands in the Integrate column
            self._files["timing"].write(
                f"{s}, {ms.get('voxelize', 0)}, {ms.get('neighbors', 0)}, "
                f"{ms.get('density', 0)}, {ms.get('pressure', 0)}, "
                f"{ms.get('acceleration', 0)}, {step_ms:g}\n")
            # reference neighbors.txt rows: "mean, max, min" (src/sph.cpp:232),
            # with mean truncated by integer division like countNeighbors/N
            self._files["neighbors"].write(f"{int(nmean[i])}, {int(nmax[i])}, {int(nmin[i])}\n")
            if self.write_jsonl:
                self._files["jsonl"].write(json.dumps({
                    "step": s,
                    "kinetic_energy": float(ke[i]),
                    "potential_energy": float(pe[i]),
                    "total_energy": float(ke[i] + pe[i]),
                    "angular_momentum": float(am[i]),
                    "neighbor_mean": float(nmean[i]),
                    "neighbor_max": int(nmax[i]),
                    "neighbor_min": int(nmin[i]),
                    "overflow_cells": int(overflow[i]),
                    "truncated_ranges": int(truncated[i]),
                    "halo_dropped": int(halo_dropped[i]),
                    "migration_dropped": int(mig_dropped[i]),
                    "step_ms": step_ms,
                }) + "\n")

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        if self._native is not None:
            self._native.close()
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _NativeStream:
    """File-like shim routing writes through the native async writer."""

    def __init__(self, writer, path: str):
        self._writer = writer
        self._path = path
        self._first = True

    def write(self, text: str) -> None:
        self._writer.write(self._path, text, append=not self._first)
        self._first = False

    def close(self) -> None:
        self._writer.flush()


def detect_blowup(diags: StepDiagnostics) -> tuple[bool, str]:
    """Failure detection: NaN/Inf or runaway energy in a diagnostics block.

    The reference merely skips NaNs in its tallies (src/sph.cpp:1000-1001);
    here a blow-up is detected and reported so the runner can abort with a
    checkpoint instead of silently producing garbage.
    """
    ke = np.asarray(diags.kinetic_energy)
    pe = np.asarray(diags.potential_energy)
    if not np.isfinite(ke).all() or not np.isfinite(pe).all():
        return True, "non-finite energy"
    if ke.size and np.abs(ke).max() > 1e30:
        return True, "kinetic energy blow-up"
    return False, ""


def detect_truncation(diags: StepDiagnostics) -> tuple[bool, str]:
    """Silent-physics warning: interactions dropped by static capacities.

    Nonzero ``truncated_ranges`` means candidate windows overflowed
    ``cfg.range_slice`` (or a kernel's chunk clamp); nonzero ``halo_dropped``
    means the sharded halo band was too narrow.  Both lose pair interactions —
    the run keeps going, but the caller should warn (the cell-list contract is
    'truncation is counted, not silently dropped')."""
    trunc = int(np.asarray(diags.truncated_ranges).sum())
    halo = int(np.asarray(diags.halo_dropped).sum())
    mig = int(np.asarray(diags.migration_dropped).sum())
    msgs = []
    if trunc:
        msgs.append(f"{trunc} candidate ranges truncated by capacity "
                    "(raise range_slice / kernel window)")
    if halo:
        msgs.append(f"{halo} candidates dropped outside the halo band "
                    "(raise halo_rows)")
    if mig:
        msgs.append(f"{mig} particles lost to migration/slab capacity "
                    "(raise m_cap / p_cap)")
    return bool(msgs), "; ".join(msgs)
