"""Pressure-field reconstruction from planar PIV velocity fields;
a copy of ``torchpiv_tpu/stats/pressure.py``.

Standard PIV post-processing the reference lacks entirely (its statistics
stop at gradients of the ensemble mean, workers.py:100-118): recover the
relative pressure field from measured velocities via the pressure Poisson
equation (cf. van Oudheusden, Meas. Sci. Technol. 24 (2013) 032001 — the
canonical review; PIVlab ships the same Poisson/Neumann formulation).

For 2-D incompressible flow, taking the divergence of the momentum
equation and using continuity gives

    lap(p) = -rho * (u_x^2 + 2 u_y v_x + v_y^2)

(the unsteady and viscous terms are divergence-free and drop out of the
source; time dependence enters only through the boundary conditions).
Neumann boundary data come from the momentum equation itself:

    dp/dn = -rho * (du/dt + (u.grad)u - nu lap(u)) . n

The pure-Neumann Poisson problem is solved directly with a DCT-II
diagonalisation of the cell-centred 5-point Laplacian (the PIV
interrogation grid IS cell-centred: each vector sits at a window centre).
The all-Neumann problem is singular (pressure is a gauge field) and PIV
data never satisfy the compatibility condition exactly; zeroing the mean
mode yields the least-squares solution, and the returned field is
mean-zero ("gauge pressure" relative to the field average).

Host-side numpy/scipy on final [R, C] fields, like the rest of stats/
(smoothing.py uses the same scipy.fft DCT machinery).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _laplacian_eigs(n: int, h: float) -> np.ndarray:
    """Eigenvalues of the cell-centred Neumann 1-D Laplacian under DCT-II:
    lambda_k = (2 cos(pi k / n) - 2) / h^2."""
    k = np.arange(n, dtype=np.float64)
    return (2.0 * np.cos(np.pi * k / n) - 2.0) / (h * h)


def solve_poisson_neumann(
    f: np.ndarray,
    dx: float,
    dy: float,
    g_left: Optional[np.ndarray] = None,
    g_right: Optional[np.ndarray] = None,
    g_bottom: Optional[np.ndarray] = None,
    g_top: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Solve ``lap(p) = f`` on a uniform [R, C] grid with Neumann data.

    Cell-centred convention: node (i, j) is the centre of cell (i, j);
    boundary faces sit half a cell outside the first/last nodes.  ``g_*``
    are the OUTWARD-face normal derivatives along each edge expressed in
    the +x / +y direction, i.e. ``g_left``/``g_right`` are dp/dx at the
    left/right faces (each [R]), ``g_bottom``/``g_top`` are dp/dy at the
    row-0 / row-(R-1) faces (each [C]); row axis = y, like the rest of the
    package.  Missing data default to homogeneous Neumann.

    The ghost-cell elimination folds the data into the RHS:
    ``(p[1]-p[0])/h^2 = f[0] + g_low/h`` and
    ``(p[n-2]-p[n-1])/h^2 = f[n-1] - g_high/h``; the remaining operator is
    diagonal under DCT-II.  The k=0 mode (the gauge constant) is set to
    zero — the least-squares solution when the Neumann compatibility
    condition does not hold exactly.  Returns a mean-zero field.
    """
    from scipy.fft import dctn, idctn

    f = np.array(f, dtype=np.float64)
    if f.ndim != 2:
        raise ValueError(f"expected [R, C] source, got {f.shape}")
    r, c = f.shape
    if r < 2 or c < 2:
        raise ValueError(f"grid too small for a Poisson solve: {f.shape}")
    if g_left is not None:
        f[:, 0] += np.asarray(g_left, dtype=np.float64) / dx
    if g_right is not None:
        f[:, -1] -= np.asarray(g_right, dtype=np.float64) / dx
    if g_bottom is not None:
        f[0, :] += np.asarray(g_bottom, dtype=np.float64) / dy
    if g_top is not None:
        f[-1, :] -= np.asarray(g_top, dtype=np.float64) / dy

    fh = dctn(f, type=2, norm="ortho")
    lam = (_laplacian_eigs(r, dy)[:, None]
           + _laplacian_eigs(c, dx)[None, :])
    lam[0, 0] = 1.0  # gauge mode, zeroed below
    ph = fh / lam
    ph[0, 0] = 0.0
    p = idctn(ph, type=2, norm="ortho")
    return p - p.mean()


def _face_value(g0: np.ndarray, g1: np.ndarray) -> np.ndarray:
    """Linear extrapolation of a node-sampled gradient to the boundary
    face half a cell outside node 0 (second-order BC placement)."""
    return 1.5 * g0 - 0.5 * g1


def pressure_poisson(
    u: np.ndarray,
    v: np.ndarray,
    dx: float = 1.0,
    dy: float = 1.0,
    rho: float = 1.0,
    nu: float = 0.0,
    dudt: Optional[np.ndarray] = None,
    dvdt: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Gauge (mean-zero) pressure field from one [R, C] velocity snapshot.

    ``u``/``v`` in consistent units with ``dx``/``dy`` (e.g. m/s and m
    gives p in Pa for ``rho`` in kg/m^3).  ``dudt``/``dvdt`` (optional,
    [R, C]) add the unsteady term to the boundary conditions for
    time-resolved data (see :func:`pressure_from_stack`); ``nu`` adds the
    viscous boundary term (usually negligible at PIV Reynolds numbers).
    Invalid vectors must be infilled upstream (the pipelines already do);
    remaining NaN stragglers are patched with the package's Delaunay
    infill (ops/infill.py) so they don't poison the DCT.
    """
    from ..ops.infill import fill_missing_values, interpolate_borders

    u = np.array(u, dtype=np.float64)
    v = np.array(v, dtype=np.float64)
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"expected matching [R, C] fields, got "
                         f"{u.shape} / {v.shape}")
    fields = []
    for a in (u, v):
        if not np.isfinite(a).all():
            a = np.where(np.isfinite(a), a, np.nan)
            filled = fill_missing_values(interpolate_borders(a))
            a = filled if filled is not None else np.nan_to_num(a)
        fields.append(a)
    u, v = fields

    dudy, dudx = np.gradient(u, dy, dx, edge_order=2)
    dvdy, dvdx = np.gradient(v, dy, dx, edge_order=2)

    # lap(p) = -rho (u_x^2 + 2 u_y v_x + v_y^2)
    src = -rho * (dudx**2 + 2.0 * dudy * dvdx + dvdy**2)

    # dp/d{x,y} = -rho (Du/Dt) + mu lap(u), sampled at the nodes
    ax = u * dudx + v * dudy
    ay = u * dvdx + v * dvdy
    if dudt is not None:
        ax = ax + np.asarray(dudt, dtype=np.float64)
    if dvdt is not None:
        ay = ay + np.asarray(dvdt, dtype=np.float64)
    px = -rho * ax
    py = -rho * ay
    if nu:
        d2udy, _ = np.gradient(dudy, dy, dx, edge_order=2)
        _, d2udx = np.gradient(dudx, dy, dx, edge_order=2)
        d2vdy, _ = np.gradient(dvdy, dy, dx, edge_order=2)
        _, d2vdx = np.gradient(dvdx, dy, dx, edge_order=2)
        px = px + rho * nu * (d2udx + d2udy)
        py = py + rho * nu * (d2vdx + d2vdy)

    return solve_poisson_neumann(
        src, dx, dy,
        g_left=_face_value(px[:, 0], px[:, 1]),
        g_right=_face_value(px[:, -1], px[:, -2]),
        g_bottom=_face_value(py[0, :], py[1, :]),
        g_top=_face_value(py[-1, :], py[-2, :]),
    )


def pressure_from_stack(
    u_stack: np.ndarray,
    v_stack: np.ndarray,
    dt: float,
    dx: float = 1.0,
    dy: float = 1.0,
    rho: float = 1.0,
    nu: float = 0.0,
) -> np.ndarray:
    """Pressure for each snapshot of a time-resolved [N, R, C] sequence.

    The unsteady boundary term uses central time differences (one-sided at
    the ends); ``dt`` is the time between snapshots in the same units as
    the velocities.  Returns [N, R, C] gauge-pressure fields.
    """
    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"expected matching [N, R, C] stacks, got "
                         f"{u.shape} / {v.shape}")
    if u.shape[0] < 2:
        raise ValueError("need >= 2 snapshots for the unsteady term; "
                         "use pressure_poisson for a single field")
    dudt = np.gradient(u, dt, axis=0, edge_order=1)
    dvdt = np.gradient(v, dt, axis=0, edge_order=1)
    return np.stack([
        pressure_poisson(u[i], v[i], dx, dy, rho=rho, nu=nu,
                         dudt=dudt[i], dvdt=dvdt[i])
        for i in range(u.shape[0])
    ])


def mean_pressure_rans(
    mean_u: np.ndarray,
    mean_v: np.ndarray,
    uu: np.ndarray,
    vv: np.ndarray,
    uv: np.ndarray,
    dx: float = 1.0,
    dy: float = 1.0,
    rho: float = 1.0,
) -> np.ndarray:
    """Mean (Reynolds-averaged) pressure from ensemble statistics.

    Divergence of the 2-D RANS momentum equation:

        lap(P) = -rho [ U_x^2 + 2 U_y V_x + V_y^2
                        + (uu)_xx + 2 (uv)_xy + (vv)_yy ]

    with Neumann data ``dP/dn = -rho [ (U.grad)U + div(reynolds stress) ].n``.
    Inputs match the statistics table the runner saves (stats/ensemble.py):
    ``mean_u``/``mean_v`` the ensemble mean, ``uu``/``vv``/``uv`` the
    Reynolds normal/shear stresses (velocity-squared units).
    """
    U = np.asarray(mean_u, dtype=np.float64)
    V = np.asarray(mean_v, dtype=np.float64)
    uu = np.asarray(uu, dtype=np.float64)
    vv = np.asarray(vv, dtype=np.float64)
    uv = np.asarray(uv, dtype=np.float64)

    dUdy, dUdx = np.gradient(U, dy, dx, edge_order=2)
    dVdy, dVdx = np.gradient(V, dy, dx, edge_order=2)
    duu_dy, duu_dx = np.gradient(uu, dy, dx, edge_order=2)
    dvv_dy, dvv_dx = np.gradient(vv, dy, dx, edge_order=2)
    duv_dy, duv_dx = np.gradient(uv, dy, dx, edge_order=2)
    _, duu_dxx = np.gradient(duu_dx, dy, dx, edge_order=2)
    dvv_dyy, _ = np.gradient(dvv_dy, dy, dx, edge_order=2)
    duv_dxy, _ = np.gradient(duv_dx, dy, dx, edge_order=2)

    src = -rho * (dUdx**2 + 2.0 * dUdy * dVdx + dVdy**2
                  + duu_dxx + 2.0 * duv_dxy + dvv_dyy)
    px = -rho * (U * dUdx + V * dUdy + duu_dx + duv_dy)
    py = -rho * (U * dVdx + V * dVdy + duv_dx + dvv_dy)
    return solve_poisson_neumann(
        src, dx, dy,
        g_left=_face_value(px[:, 0], px[:, 1]),
        g_right=_face_value(px[:, -1], px[:, -2]),
        g_bottom=_face_value(py[0, :], py[1, :]),
        g_top=_face_value(py[-1, :], py[-2, :]),
    )
