"""Simulation configuration.

The reference hardcodes its whole scene in the engine constructor
(`/root/reference/src/sph.cpp:36-118`) with eight parameters runtime-tunable
through a Qt tree (`/root/reference/src/sphconfig.cpp:29-51`).  Here the whole
scene is one frozen dataclass: hashable, so it can ride into ``jax.jit`` as a
static argument, and every derived constant is a cached property computed in
float32 exactly like the C++ constructor does.

Units follow the reference's astrophysical fork: km/s, pc, M_sun, Myr
(`/root/reference/src/sph.cpp:34`).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Literal

BoundaryMode = Literal["none", "reflect"]
SecondKickMode = Literal["gravity", "none", "full"]
NeighborhoodMode = Literal["octant", "cell27"]


def _f32(x: float) -> float:
    """Round-trip a Python float through float32 (the reference is all-float32)."""
    import struct

    return struct.unpack("f", struct.pack("f", x))[0]


@dataclasses.dataclass(frozen=True)
class SphConfig:
    """Full scene + physics + solver configuration.

    Defaults replicate the reference scene constants at
    `/root/reference/src/sph.cpp:46-98`: 32,768 particles, h=0.1, 32^3 grid of
    2h cells, dt=1e-3 over 1 Myr, rho0=0.1, k=1e-3, mu=1e-2, central point
    mass 1e5 M_sun with softening h, CFL clamp 1e4.
    """

    # --- scene / discretisation -------------------------------------------------
    num_particles: int = 32 * 1024
    h: float = 0.1                      # smoothing / interaction radius [pc]
    sim_scale: float = 1.0              # world->physics scale (ref: 1.0)
    grid_nx: int = 32
    grid_ny: int = 32
    grid_nz: int = 32
    # cell edge = cell_size_factor * h.  The reference uses 2h (its octant
    # search depends on it); factor 1 with the 27-cell stencil cuts occupancy
    # 8x and kernel lane work ~3x (box size = grid_n * cell, so halving the
    # factor needs doubled grid dims for the same box).
    cell_size_factor: float = 2.0

    # --- time integration --------------------------------------------------------
    dt: float = 1e-3                    # [Myr]
    total_time: float = 1.0             # [Myr]

    # --- fluid physics ------------------------------------------------------------
    rho0: float = 0.1                   # rest density
    stiffness: float = 1e-3             # EoS k: p = k (rho - rho0)
    viscosity: float = 1e-2             # viscosity coefficient mu
    damping: float = 1e-3               # boundary reflection damping
    gravity: tuple[float, float, float] = (0.0, 0.0, 0.0)  # uniform gravity (ref: zeroed)

    # --- central point mass (black hole / nuclear star cluster) -------------------
    grav_constant: float = 4.3009e-3    # G in pc (km/s)^2 / M_sun
    central_mass: float = 1e5           # [M_sun]
    softening: float | None = None      # defaults to h*sim_scale like the reference

    # --- particle properties -------------------------------------------------------
    particle_mass: float = 1.0          # [M_sun] each

    # --- solver limits ---------------------------------------------------------------
    cfl_limit: float = 1e4              # acceleration magnitude clamp
    max_neighbors: int = 32             # per-particle neighbor cap (compat mode)
    cell_capacity: int = 96             # max particles binned per grid cell
    range_slice: int = 96               # candidate slice length per x-contiguous cell range

    # --- behaviour switches ---------------------------------------------------------
    compat: bool = False                # reproduce the reference's quirks (SURVEY §2.1)
    include_self_density: bool = False  # textbook SPH adds self term; reference skips it
    boundary: BoundaryMode = "none"     # reference dynamics never enforce the box
    second_kick: SecondKickMode = "gravity"  # KDK closing kick: ref re-evaluates gravity only
    pressure_softening: float = 0.01    # +eps on |r_ij| in the spiky gradient direction
    # candidate stencil: "octant" = the reference's 2x2x2 trick (needs cell >= 2h),
    # "cell27" = full 3x3x3 superset (always safe)
    neighborhood: NeighborhoodMode = "octant"

    # --- execution -----------------------------------------------------------------
    # rows per lax.map chunk of the XLA cell-list sweeps; 0 = all rows in
    # one chunk.  One chunk is fastest, but its candidate tensors take
    # ~43 KB per particle at range_slice 128 (PERF.md, "Kernel decisions")
    sweep_chunk: int = 131072
    pallas_interpret: bool = False  # run Pallas kernels in interpret mode (CPU tests)

    # ---------------------------------------------------------------------------
    # Derived constants (float32-faithful to /root/reference/src/sph.cpp:46-95)
    # ---------------------------------------------------------------------------
    @property
    def h2(self) -> float:
        return _f32(_f32(self.h) ** 2)

    @property
    def cell_size(self) -> float:
        return _f32(_f32(self.cell_size_factor) * _f32(self.h))

    @property
    def inv_cell_size(self) -> float:
        return _f32(1.0 / self.cell_size)

    @property
    def h_scaled(self) -> float:
        return _f32(_f32(self.h) * _f32(self.sim_scale))

    @property
    def h_scaled2(self) -> float:
        return _f32(self.h_scaled ** 2)

    @property
    def h_scaled6(self) -> float:
        return _f32(self.h_scaled ** 6)

    @property
    def h_scaled9(self) -> float:
        return _f32(self.h_scaled ** 9)

    @property
    def box_max(self) -> tuple[float, float, float]:
        return (
            _f32(self.cell_size * self.grid_nx),
            _f32(self.cell_size * self.grid_ny),
            _f32(self.cell_size * self.grid_nz),
        )

    @property
    def central_pos(self) -> tuple[float, float, float]:
        mx, my, mz = self.box_max
        return (_f32(mx * 0.5), _f32(my * 0.5), _f32(mz * 0.5))

    @property
    def softening_eff(self) -> float:
        return self.h_scaled if self.softening is None else _f32(self.softening)

    @property
    def num_cells(self) -> int:
        return self.grid_nx * self.grid_ny * self.grid_nz

    @property
    def num_steps(self) -> int:
        # ref: totalSteps = round(time/dt); loop runs stepCount <= totalSteps
        # i.e. totalSteps+1 iterations (/root/reference/src/sph.cpp:71,171)
        return int(round(self.total_time / self.dt))

    # Smoothing-kernel normalisations (/root/reference/src/sph.cpp:93-95)
    @property
    def poly6_norm(self) -> float:
        return _f32(315.0 / (64.0 * math.pi * self.h_scaled9))

    @property
    def spiky_grad_norm(self) -> float:
        return _f32(-45.0 / (math.pi * self.h_scaled6))

    @property
    def visc_lap_norm(self) -> float:
        return _f32(45.0 / (math.pi * self.h_scaled6))

    # ---------------------------------------------------------------------------
    def replace(self, **kw) -> "SphConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SphConfig":
        d = json.loads(text)
        if isinstance(d.get("gravity"), list):
            d["gravity"] = tuple(d["gravity"])
        return cls(**d)

    def validate(self) -> None:
        if self.num_particles <= 0:
            raise ValueError("num_particles must be positive")
        if self.h <= 0 or self.dt <= 0:
            raise ValueError("h and dt must be positive")
        if self.cell_capacity < 1 or self.max_neighbors < 1:
            raise ValueError("capacities must be >= 1")
        if self.cell_size < self.h:
            raise ValueError("cell_size must cover the interaction radius h "
                             "(cell_size_factor >= 1)")
        if self.neighborhood == "octant" and self.cell_size < 2.0 * self.h:
            raise ValueError("octant stencil requires cell_size >= 2h; use cell27")
        if self.compat and self.cell_size_factor != 2.0:
            raise ValueError("compat mode requires the reference's 2h cells")
        if self.sweep_chunk < 0:
            raise ValueError("sweep_chunk must be >= 0 (0 = one chunk)")
