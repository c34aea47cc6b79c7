"""Smoothed Particle Hydrodynamics framework in JAX, for the GPU.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of
``DanielaCourel/smoothed_particle_hydrodynamics`` (a C++/Qt astrophysical SPH
gas-disk simulator): poly6 density, spiky pressure gradient, viscosity
Laplacian, stiff EoS, central point-mass gravity, leapfrog KDK integration,
sort-based uniform-grid neighbor search, multi-device spatial sharding, and the
diagnostics/render/benchmark surface around it.
"""

from .config import SphConfig
from .state import ParticleState, StepDiagnostics
from .init import init_dam_break, init_rotating_sphere, init_splash, load_state
from .ops.step import compute_forces, make_step, run_steps, simulate, step

__version__ = "0.1.0"

__all__ = [
    "SphConfig",
    "ParticleState",
    "StepDiagnostics",
    "init_rotating_sphere",
    "init_dam_break",
    "init_splash",
    "load_state",
    "step",
    "make_step",
    "run_steps",
    "simulate",
    "compute_forces",
    "__version__",
]
