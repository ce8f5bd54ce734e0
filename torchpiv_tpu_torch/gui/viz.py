"""Headless field visualisation — the plotting core the Qt GUI wraps (copy
of ``torchpiv_tpu/gui/viz.py``).

Reimplements the reference's canvas logic (``PIVwidgets.py:106-251``)
without any Qt dependency so it is testable and usable
from the CLI: pcolormesh field maps with adjustable color scale, streamline
overlay (velocity regridded onto a uniform mesh), profile-line extraction,
and y-autoscaling of profile plots.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def regrid_for_streamlines(
    x: np.ndarray, y: np.ndarray, u: np.ndarray, v: np.ndarray, n: int = 50
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Interpolate (u, v) onto a uniform grid (matplotlib's streamplot
    requires strictly uniform spacing; reference PIVwidgets.py:210-230)."""
    from scipy.interpolate import LinearNDInterpolator

    pts = np.stack([x.ravel(), y.ravel()], axis=1)
    xi = np.linspace(x.min(), x.max(), n)
    yi = np.linspace(y.min(), y.max(), n)
    XI, YI = np.meshgrid(xi, yi)
    UI = LinearNDInterpolator(pts, u.ravel())(XI, YI)
    VI = LinearNDInterpolator(pts, v.ravel())(XI, YI)
    return XI, YI, np.nan_to_num(UI), np.nan_to_num(VI)


def extract_profile(
    data: Dict[str, np.ndarray], key: str, index: int, horizontal: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """1-D profile of ``key`` along a row (horizontal) or column of the grid
    (reference ProfileCanvas, PIVwidgets.py:44-103)."""
    field = np.asarray(data[key])
    if horizontal:
        return np.asarray(data["x[mm]"])[index, :], field[index, :]
    return np.asarray(data["y[mm]"])[:, index], field[:, index]


def autoscale_y(ax, margin: float = 0.2) -> None:
    """Rescale the y-axis to the data visible in the current x-range
    (reference PlotterFunctions.py:77-98)."""
    lo, hi = ax.get_xlim()
    bot, top = np.inf, -np.inf
    for line in ax.get_lines():
        xd, yd = line.get_xdata(), line.get_ydata()
        vis = yd[(xd > lo) & (xd < hi)]
        if vis.size == 0:
            continue
        h = vis.max() - vis.min()
        bot = min(bot, vis.min() - margin * h)
        top = max(top, vis.max() + margin * h)
    if np.isfinite(bot) and np.isfinite(top) and bot < top:
        ax.set_ylim(bot, top)


def render_field(
    data: Dict[str, np.ndarray],
    key: str = "Vy[m/s]",
    *,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    streamlines: bool = False,
    vectors: bool = False,
    profile: Optional[Tuple[int, bool]] = None,
    show_grid: bool = False,
    show_axes: bool = True,
    out_path: Optional[str] = None,
    ax=None,
):
    """Render one field as a pcolormesh map (jet colormap + colorbar like the
    reference, PIVwidgets.py:163-208), optionally with streamlines and a
    white profile line.  Saves to ``out_path`` if given; returns the axes.
    """
    import matplotlib

    if out_path is not None and ax is None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    x = np.asarray(data["x[mm]"])
    y = np.asarray(data["y[mm]"])
    field = np.asarray(data[key])
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 6))
    else:
        fig = ax.figure
    mesh = ax.pcolormesh(x, y, field, cmap="jet", vmin=vmin, vmax=vmax,
                         shading="auto")
    fig.colorbar(mesh, ax=ax, label=key)
    if streamlines:
        XI, YI, UI, VI = regrid_for_streamlines(
            x, y, data["Vx[m/s]"], data["Vy[m/s]"]
        )
        ax.streamplot(XI, YI, UI, VI, color="k", density=1.2, linewidth=0.7)
    if vectors:
        # decimated quiver overlay (standard PIV vector view; keeps at
        # most ~32 arrows per axis so dense grids stay readable)
        U = np.asarray(data["Vx[m/s]"])
        V = np.asarray(data["Vy[m/s]"])
        sr = max(1, U.shape[0] // 32)
        sc = max(1, U.shape[1] // 32)
        ax.quiver(x[::sr, ::sc], y[::sr, ::sc], U[::sr, ::sc], V[::sr, ::sc],
                  color="k", scale_units="width", width=0.0022)
    if profile is not None:
        index, horizontal = profile
        if horizontal:
            ax.axhline(y[index, 0], color="w", lw=1.5)
        else:
            ax.axvline(x[0, index], color="w", lw=1.5)
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("y [mm]")
    if show_grid:
        ax.grid(True, color="w", alpha=0.3)
    if not show_axes:  # reference's axes toggle (PIVwidgets.py:238-251)
        ax.set_axis_off()
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax
