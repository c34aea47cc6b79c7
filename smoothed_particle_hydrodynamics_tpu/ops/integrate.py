"""Time integration: leapfrog KDK + optional boundary reflection + diagnostics.

Reference: /root/reference/src/sph.cpp:937-1022.  Notable reference semantics
reproduced here:

* the closing kick re-evaluates **only** the central point-mass gravity at the
  drifted position (src/sph.cpp:972-995) — hydro forces enter the opening kick
  only (``second_kick="gravity"``);
* out-of-box particles are *not* reflected (the reflection code at
  src/sph.cpp:1025-1148 is dead) — ``boundary="none"``;
* energy tallies skip NaN via a ``dot > 0`` guard (src/sph.cpp:1001-1013), and
  in compat mode the potential-energy term divides by (d+eps)^3 (quirk 8).

Default mode fixes quirk 8 (PE = -G M m / (d+eps)) and computes the real
angular momentum |sum m (r-c) x v| (the reference's accumulation is commented
out so it always logs 0, src/sph.cpp:1010-1011).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import SphConfig
from ..state import ParticleState
from .physics import central_gravity

_f32 = jnp.float32


class EnergyTally(NamedTuple):
    kinetic: jnp.ndarray
    potential: jnp.ndarray
    angular_momentum: jnp.ndarray
    # [3] un-normed angular-momentum vector sum.  Distributed callers must
    # psum THIS and take the norm after the reduction (sum of per-shard
    # norms != norm of the global sum); single-chip callers can ignore it.
    l_vec: jnp.ndarray = None


def kdk_integrate(cfg: SphConfig, state: ParticleState,
                  acceleration: jnp.ndarray) -> tuple[ParticleState, EnergyTally]:
    """One leapfrog kick-drift-kick update of positions and velocities.

    ``acceleration`` is the full (hydro + gravity, CFL-clamped) acceleration at
    the pre-step positions.  Returns the updated state and the energy tally
    computed exactly where the reference computes it (post-kick velocities,
    drifted positions).
    """
    dt = _f32(cfg.dt)
    pos_dt = dt * _f32(1.0 / cfg.sim_scale)

    v_half = state.velocity + acceleration * (dt * 0.5)
    new_pos = state.position + v_half * pos_dt

    if cfg.second_kick == "gravity":
        a2 = central_gravity(cfg, new_pos)
        new_vel = v_half + a2 * dt
    elif cfg.second_kick == "none":
        new_vel = v_half
    else:  # "full" is applied by the step orchestrator (needs a force re-eval)
        raise ValueError("second_kick='full' must be handled by the step function")

    if cfg.boundary == "reflect":
        new_pos, new_vel = reflect_boundary(cfg, state.position, new_pos, new_vel)

    tally = energy_tally(cfg, new_pos, new_vel, state.mass)
    new_state = state._replace(position=new_pos, velocity=new_vel,
                               acceleration=acceleration)
    return new_state, tally


def angular_momentum_vec(cfg: SphConfig, pos: jnp.ndarray, vel: jnp.ndarray,
                         mass: jnp.ndarray) -> jnp.ndarray:
    """[3] vector L = sum_i m_i (r_i - c) x v_i about the central mass.

    Exposed separately from :func:`energy_tally` because distributed callers
    must ``psum`` the *vector* across shards before taking the norm — the sum
    of per-shard |L| norms is not |sum L| (parallel/slabs.py does this).
    """
    center = jnp.asarray(cfg.central_pos, jnp.float32)
    rel = (pos - center) * _f32(cfg.sim_scale)
    return jnp.sum(mass[:, None] * jnp.cross(rel, vel), axis=0)


def energy_tally(cfg: SphConfig, pos: jnp.ndarray, vel: jnp.ndarray,
                 mass: jnp.ndarray) -> EnergyTally:
    """KE/PE/|L| sums matching /root/reference/src/sph.cpp:997-1013.

    Default mode reduces all five scalars (KE, PE, Lx, Ly, Lz) through ONE
    stacked ``[N, 5]`` column sum, one reduction instead of five.
    """
    center = jnp.asarray(cfg.central_pos, jnp.float32)
    rel = (pos - center) * _f32(cfg.sim_scale)
    v2 = jnp.sum(vel * vel, axis=-1)
    gm = _f32(cfg.grav_constant) * _f32(cfg.central_mass)
    soft = _f32(cfg.softening_eff)
    if cfg.compat:
        dist = jnp.linalg.norm(rel, axis=-1)
        # The reference's NaN skip: the `dot > 0` guard excludes at-rest
        # particles from BOTH tallies (src/sph.cpp:1001-1013, quirk).
        ok = v2 > 0.0
        ke = jnp.sum(jnp.where(ok, 0.5 * mass * v2, 0.0))
        # quirk 8: 1/(d+eps)^3 instead of 1/(d+eps)
        pe = -jnp.sum(jnp.where(ok, gm * mass / (dist + soft) ** 3, 0.0))
        ang = jnp.zeros((), jnp.float32)  # reference always logs 0
        return EnergyTally(ke, pe, ang, jnp.zeros((3,), jnp.float32))
    # Default mode: at-rest particles count (a dam break at rest has
    # nonzero PE); only non-finite velocities are masked from KE, and PE
    # is not velocity-gated at all, so NaN positions surface as NaN PE
    # for detect_blowup instead of being silently zeroed.
    ke_i = jnp.where(jnp.isfinite(v2), 0.5 * mass * v2, 0.0)
    if float(cfg.grav_constant) * float(cfg.central_mass) == 0.0:
        # No central mass (splash, dam break): PE is identically zero, but
        # XLA cannot fold the 0-multiply under IEEE NaN rules, so the
        # sqrt+divide pass below would still run.  Skip it statically and
        # keep a 0*x NaN canary so non-finite positions still surface as
        # non-finite PE for detect_blowup (the documented contract above).
        pe_i = (rel[:, 0] + rel[:, 1] + rel[:, 2]) * _f32(0.0)
    else:
        dist = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
        pe_i = gm * mass / (dist + soft)
    l_i = mass[:, None] * jnp.cross(rel, vel)
    cols = jnp.concatenate([ke_i[:, None], pe_i[:, None], l_i], axis=1)
    s = jnp.sum(cols, axis=0)
    l_vec = s[2:5]
    return EnergyTally(s[0], -s[1], jnp.linalg.norm(l_vec), l_vec)


def reflect_boundary(cfg: SphConfig, old_pos: jnp.ndarray, new_pos: jnp.ndarray,
                     new_vel: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reflect particles off the box walls with damping.

    Rebuilt from the reference's dead reflection path
    (/root/reference/src/sph.cpp:1025-1148): on crossing a wall, the particle
    is placed at the intersection point plus the reflected, damped remainder
    of its displacement; the wall-normal velocity component flips sign.
    This branch-free version handles all six walls at once.

    The geometry is computed from the actual drift displacement
    ``new_pos - old_pos`` (dimensionless step fractions), so it is exact for
    any ``sim_scale`` and independent of which velocity produced the drift.
    """
    box = jnp.asarray(cfg.box_max, jnp.float32)

    below = new_pos < 0.0
    above = new_pos > box
    crossed = below | above

    disp = new_pos - old_pos
    safe_disp = jnp.where(disp == 0.0, 1e-30, disp)
    # one divide, two multiplies: XLA will not rewrite x/d into x*(1/d)
    # itself (unsafe under IEEE), and the two fractions share the denominator
    inv_disp = 1.0 / safe_disp
    f_low = -old_pos * inv_disp                  # fraction of the step at impact
    f_high = (box - old_pos) * inv_disp
    f_hit = jnp.where(below, f_low, jnp.where(above, f_high, 0.0))

    reflected_vel = jnp.where(crossed, -new_vel, new_vel)
    intersection = old_pos + disp * f_hit
    remaining = jnp.maximum(1.0 - f_hit, 0.0)
    bounced = intersection - disp * (remaining * _f32(cfg.damping))

    out_pos = jnp.where(crossed, bounced, new_pos)
    # Numerical safety: keep strictly inside so binning never clamps.
    out_pos = jnp.clip(out_pos, 0.0, box)
    return out_pos, reflected_vel
