"""Sharded SPH step over a device mesh.

Decomposition: particles are globally sorted by linear cell id every step
(``ops.grid``).  Because the id is z-major — ``(z*ny + y)*nx + x`` — equal
contiguous blocks of the *sorted* order are contiguous z-slabs of space, so
giving device ``d`` sorted rows ``[d*N/D, (d+1)*N/D)`` is a genuine spatial
domain decomposition with load balance by construction (equal particles per
device, not equal volume).

Communication pattern per step, all compiled XLA collectives:

* binning/sort is computed from replicated positions (cheap relative to the
  pair sweeps; a distributed sort is a later optimisation);
* the density sweep runs on local rows; its output is all-gathered (GSPMD
  inserts the collective at the ``shard_map`` boundary) because the force
  sweep needs neighbor densities, which can live on the adjacent slab —
  the moral equivalent of a halo exchange, currently widened to a gather;
* energy/neighbor diagnostics are global reductions (``psum`` semantics via
  replicated sums).

The same ``step`` semantics hold on 1 chip and N chips — tested by the
1-vs-8-device equality test on a virtual CPU mesh.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SphConfig
from ..state import ParticleState, StepDiagnostics, make_step_diagnostics
from ..ops import celllist
from ..ops.grid import unsort
from ..ops.integrate import kdk_integrate


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} available"
                " (for local testing set JAX_PLATFORMS=cpu and"
                " XLA_FLAGS=--xla_force_host_platform_device_count=N)")
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def shard_state(mesh: Mesh, state: ParticleState) -> ParticleState:
    """Place particle arrays sharded over their leading axis."""
    sh = NamedSharding(mesh, P("data"))
    return jax.tree.map(lambda a: jax.device_put(a, sh), state)


def step_sharded(cfg: SphConfig, mesh: Mesh, state: ParticleState
                 ) -> tuple[ParticleState, StepDiagnostics]:
    """One physics step, sharded over ``mesh``'s 'data' axis.  Call under jit."""
    n = state.position.shape[0]
    ndev = math.prod(mesh.devices.shape)
    if n % ndev:
        raise ValueError(f"num_particles={n} must be divisible by {ndev} devices")

    p = celllist.prepare(cfg, state)
    own_idx = jnp.arange(n, dtype=jnp.int32)

    density_local = jax.shard_map(
        partial(celllist.density_rows, cfg),
        mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")),
    )
    rho_s, ncount_s, truncated = density_local(
        p.pos_s, p.mass_s, p.rng_start, p.rng_end, own_idx, p.pos_s, p.mass_s)

    force_local = jax.shard_map(
        partial(celllist.force_rows, cfg),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(),
                  P("data"), P("data"), P("data"), P("data"), P("data"), P("data")),
        out_specs=P("data"),
    )
    acc_s = force_local(
        p.pos_s, p.vel_s, p.mass_s, rho_s,
        p.rng_start, p.rng_end, own_idx, p.pos_s, p.vel_s, rho_s)

    g = p.grid
    acc = unsort(g.order, acc_s)
    rho = unsort(g.order, rho_s)
    ncount = unsort(g.order, ncount_s)

    state = state._replace(density=rho, neighbor_count=ncount)
    new_state, tally = kdk_integrate(cfg, state, acc)
    # Keep the output sharded over particles for the next step.
    sharded = NamedSharding(mesh, P("data"))
    new_state = jax.tree.map(
        lambda a: jax.lax.with_sharding_constraint(a, sharded), new_state)

    diag = make_step_diagnostics(tally, ncount, g.overflow_cells,
                                 truncated_ranges=jnp.sum(truncated).astype(jnp.int32))
    return new_state, diag


def step_sharded_halo(cfg: SphConfig, mesh: Mesh, state: ParticleState,
                      halo_rows: int
                      ) -> tuple[ParticleState, StepDiagnostics]:
    """Sharded step with HALO EXCHANGE instead of gathered neighbor fields.

    Each device owns a contiguous block of globally-sorted rows — a z-slab of
    space (the linear cell id is z-major).  A particle's stencil candidates
    live at most one cell-plane away, i.e. within a bounded band of sorted
    indices around the slab; devices exchange ``halo_rows`` edge rows with
    both mesh neighbors via ``lax.ppermute`` and run the sweeps
    against [halo | local | halo] only.  Candidates beyond the halo are
    dropped and counted (``truncated_ranges`` doubles as the halo-overflow
    counter) — size ``halo_rows`` to cover the densest plane population.

    The binning/sort itself still runs replicated (cheap relative to sweeps);
    a distributed sort with migration buffers is the next step on this path.
    """
    n = state.position.shape[0]
    ndev = math.prod(mesh.devices.shape)
    if n % ndev:
        raise ValueError(f"num_particles={n} must be divisible by {ndev} devices")
    rows = n // ndev
    h = halo_rows
    if h > rows:
        raise ValueError("halo_rows must be <= rows per device")

    p = celllist.prepare(cfg, state)
    own_idx = jnp.arange(n, dtype=jnp.int32)
    fields = jnp.concatenate(
        [p.pos_s, p.vel_s, p.mass_s[:, None]], axis=1)     # [N, 7]

    def halo_sweeps(fields_loc, rng_s, rng_e, own):
        """shard_map body: fields_loc [rows, 7] local slab."""
        axis = "data"
        idx = jax.lax.axis_index(axis)
        right_edge = fields_loc[-h:]                        # goes to right neighbor
        left_edge = fields_loc[:h]                          # goes to left neighbor
        ndev_ax = jax.lax.axis_size(axis)
        # receive left neighbor's last rows and right neighbor's first rows
        from_left = jax.lax.ppermute(
            right_edge, axis, [(d, (d + 1) % ndev_ax) for d in range(ndev_ax)])
        from_right = jax.lax.ppermute(
            left_edge, axis, [(d, (d - 1) % ndev_ax) for d in range(ndev_ax)])
        # zero out wrapped halos at the chain ends (no periodic space)
        from_left = jnp.where(idx == 0, 0.0, from_left)
        from_right = jnp.where(idx == ndev_ax - 1, 0.0, from_right)
        ext = jnp.concatenate([from_left, fields_loc, from_right], axis=0)

        base = idx * rows - h                               # global idx of ext[0]
        # clamp candidate ranges into the halo band; count dropped CANDIDATE
        # ROWS (empty [0,0) ranges from out-of-grid rods must not count)
        lo = jnp.maximum(rng_s, idx * rows - h)
        hi = jnp.minimum(rng_e, (idx + 1) * rows + h)
        cut_left = jnp.maximum(jnp.minimum(rng_e, lo) - rng_s, 0)
        cut_right = jnp.maximum(rng_e - jnp.maximum(rng_s, hi), 0)
        cut = jnp.sum(cut_left + cut_right).astype(jnp.int32)
        lo = lo - base
        hi = jnp.maximum(hi - base, lo)

        pos_e, vel_e, mass_e = ext[:, 0:3], ext[:, 3:6], ext[:, 6]
        own_l = own - base
        pos_i = fields_loc[:, 0:3]
        vel_i = fields_loc[:, 3:6]
        mass_i = fields_loc[:, 6]

        rho_l, nc_l, trunc = celllist.density_rows(
            cfg, pos_e, mass_e, lo, hi, own_l, pos_i, mass_i)

        # force sweep needs neighbor densities -> exchange rho halos too
        rho_left = jax.lax.ppermute(
            rho_l[-h:], axis, [(d, (d + 1) % ndev_ax) for d in range(ndev_ax)])
        rho_right = jax.lax.ppermute(
            rho_l[:h], axis, [(d, (d - 1) % ndev_ax) for d in range(ndev_ax)])
        rho_left = jnp.where(idx == 0, 0.0, rho_left)
        rho_right = jnp.where(idx == ndev_ax - 1, 0.0, rho_right)
        rho_e = jnp.concatenate([rho_left, rho_l, rho_right])

        acc_l = celllist.force_rows(
            cfg, pos_e, vel_e, mass_e, rho_e, lo, hi, own_l,
            pos_i, vel_i, rho_l)
        # two distinct failure signals: static-capacity truncation vs candidates
        # cut because they fell outside the halo band (halo too small)
        truncated = jax.lax.psum(jnp.sum(trunc).astype(jnp.int32), axis)
        halo_cut = jax.lax.psum(cut, axis)
        return rho_l, nc_l, acc_l, truncated, halo_cut

    sweeps = jax.shard_map(
        halo_sweeps, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P(), P()),
    )
    rho_s, ncount_s, acc_s, truncated, halo_cut = sweeps(
        fields, p.rng_start, p.rng_end, own_idx)

    g = p.grid
    acc = unsort(g.order, acc_s)
    rho = unsort(g.order, rho_s)
    ncount = unsort(g.order, ncount_s)

    state = state._replace(density=rho, neighbor_count=ncount)
    new_state, tally = kdk_integrate(cfg, state, acc)
    sharded = NamedSharding(mesh, P("data"))
    new_state = jax.tree.map(
        lambda a: jax.lax.with_sharding_constraint(a, sharded), new_state)

    diag = make_step_diagnostics(tally, ncount, g.overflow_cells,
                                 truncated_ranges=truncated,
                                 halo_dropped=halo_cut)
    return new_state, diag


def run_steps_sharded(cfg: SphConfig, mesh: Mesh, state: ParticleState,
                      num_steps: int
                      ) -> tuple[ParticleState, StepDiagnostics]:
    """lax.scan over the sharded step (whole-run loop on a mesh)."""

    def body(carry, _):
        return step_sharded(cfg, mesh, carry)

    return jax.lax.scan(body, state, None, length=num_steps)


def derive_halo_rows(cfg: SphConfig, state: ParticleState,
                     n_devices: int) -> int:
    """Halo size from the state's cell-plane occupancy (host-side, concrete).

    A slab-edge particle's stencil candidates reach back to the start of the
    previous z-plane of cells, so one halo side must cover at most
    ``pop(z-1) + pop(z)`` sorted rows for the densest adjacent plane pair.
    25% headroom absorbs drift between rebuilds; runtime undersizing is
    observable as ``StepDiagnostics.halo_dropped``.
    """
    import numpy as np

    from ..ops.grid import cell_coords

    z = np.asarray(cell_coords(cfg, state.position))[:, 2]
    pop = np.bincount(z, minlength=cfg.grid_nz).astype(np.int64)
    need = int((pop[:-1] + pop[1:]).max()) if cfg.grid_nz > 1 else int(pop[0])
    rows = state.position.shape[0] // max(n_devices, 1)
    halo = min(rows, max(64, (need * 5) // 4))
    return -(-halo // 8) * 8 if halo < rows else rows


def make_sharded_step(cfg: SphConfig, mesh: Mesh, donate: bool = True,
                      halo_rows: int | None = None, variant: str = "halo"
                      ) -> Callable[[ParticleState], tuple[ParticleState, StepDiagnostics]]:
    """The multi-device halo-exchange step.

    ``halo_rows=None`` derives the halo from the first state's cell-plane
    occupancy (``derive_halo_rows``).  ``variant="gather"`` selects the
    replicated-gather step — kept as a correctness oracle for tests; it
    cannot weak-scale (per-device memory is O(N))."""
    if variant == "gather":
        f = partial(step_sharded, cfg, mesh)
        return jax.jit(f, donate_argnums=(0,) if donate else ())
    if variant != "halo":
        raise ValueError(f"unknown sharded-step variant: {variant!r}")

    ndev = math.prod(mesh.devices.shape)
    jitted: dict = {}

    def run(state: ParticleState):
        nonlocal halo_rows
        if halo_rows is None:
            halo_rows = derive_halo_rows(cfg, state, ndev)
        if "f" not in jitted:
            f = partial(step_sharded_halo, cfg, mesh, halo_rows=halo_rows)
            jitted["f"] = jax.jit(f, donate_argnums=(0,) if donate else ())
        return jitted["f"](state)

    return run
