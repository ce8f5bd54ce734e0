"""Result persistence + filename helpers (copy of
``torchpiv_tpu/utils/persistence.py``; ``atoi`` and ``natural_keys`` are
the port's ``io.dataset.atoi`` and ``natural_keys``, and ``save_table``
writes through the port's native formatter, ``native.loader.write_table``).

Mirrors the reference's PlotterFunctions persistence surface
(``PlotterFunctions.py:16-65, 100-111``): natural
filename sort, never-overwrite uniquify, binary (.npy stack) and CSV table
writers, and the flat-CSV re-gridding used when re-loading saved fields.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from ..io.dataset import atoi, natural_keys  # noqa: F401 (re-exported)


_UNIQ_RE = re.compile(r"^(?P<base>.*) \((?P<n>\d+)\)$")


def saved_series_key(path: str):
    """Sort key for SAVED-OUTPUT series (files written via
    :func:`uniquify`): the bare name is snapshot 0 and ' (n)' suffixes
    are snapshots n, so ``run_pair.npy`` orders BEFORE
    ``run_pair (1).npy``.  Plain ``natural_keys`` puts the bare name
    LAST (' ' < '.'), which rotates a time series — fatal for
    order-sensitive analyses (DMD, SPOD, temporal spectra)."""
    d, fname = os.path.split(path)
    stem, ext = os.path.splitext(fname)
    m = _UNIQ_RE.match(stem)
    if m:
        return (d, natural_keys(m.group("base") + ext), int(m.group("n")))
    return (d, natural_keys(fname), 0)


def uniquify(path: str) -> str:
    """Append ' (n)' until the path is free — outputs are never overwritten
    (reference :16-24)."""
    filename, extension = os.path.splitext(path)
    counter = 1
    while os.path.exists(path):
        path = f"{filename} ({counter}){extension}"
        counter += 1
    return path


def save_binary(name: str, path: str, data: Dict[str, np.ndarray]) -> str:
    """Stack the dict's fields into one array and np.save it (reference
    :48-53).  Returns the (uniquified) path written."""
    os.makedirs(path, exist_ok=True)
    out = uniquify(os.path.join(path, name))
    np.save(out, np.stack([np.asarray(v) for v in data.values()], axis=0))
    return out


def save_table(name: str, path: str, data: Dict[str, np.ndarray], sep: str = ", ") -> str:
    """Flatten each field to a column and write a headed CSV with '%.6f'
    formatting (reference :55-65).  Returns the path written.

    Writes through the native C formatter when available (byte-identical
    to np.savetxt, pinned by tests/test_torch_native.py, and GIL-free);
    falls back to np.savetxt where it did not build."""
    cols = {k: np.asarray(v).reshape(-1) for k, v in data.items()}
    os.makedirs(path, exist_ok=True)
    out = uniquify(os.path.join(path, name))
    arr = np.stack(list(cols.values()), axis=1)
    header = sep.join(cols.keys())
    try:
        from ..native import loader as fastio

        fastio.write_table(out, header, arr, sep)
    except Exception:
        np.savetxt(out, arr, delimiter=sep, header=header,
                   comments="", fmt="%.6f")
    return out


def make_name(name: str, key: str, horizontal: bool) -> tuple:
    """Profile output filename '<base>_<key>_<Hor|Vert>_profile.txt' in ./Out
    (reference :68-75)."""
    orientation = "Hor" if horizontal else "Vert"
    base = os.path.basename(os.path.normpath(name))
    key = key[: key.find("[")].replace("/", "_")
    filename = f"{base}_{key}_{orientation}_profile.txt".replace(" ", "")
    return filename, os.path.join(os.getcwd(), "Out")


def find_grid(first_column: np.ndarray) -> int:
    """Infer the row width of a flattened 2-D grid from the first repeated
    value of its first column (reference :100-107)."""
    values = np.asarray(first_column)
    zero_val = values[0]
    idx = 1
    for idx, val in enumerate(values):
        if val == zero_val and idx > 0:
            break
    return idx


def reshape_data(data: Dict[str, np.ndarray], grid: int) -> Dict[str, np.ndarray]:
    """Re-grid flat columns into 2-D fields (reference :109-111)."""
    return {k: np.asarray(v).reshape(-1, grid) for k, v in data.items()}


def load_table(path: str) -> Dict[str, np.ndarray]:
    """Read a saved CSV table back into 2-D fields (reference Database.load,
    :194-199)."""
    import pandas as pd

    data = pd.read_csv(path, sep=None, engine="python")
    data.columns = [c.strip() for c in data.columns]
    # the ', ' separator leaves a leading space that stops ' nan' parsing
    # as float (object column); coerce every column back to numeric
    data = data.apply(pd.to_numeric, errors="coerce")
    grid = find_grid(data[data.keys()[0]].values)
    return reshape_data({k: v.values for k, v in data.items()}, grid)


def save_mat(name: str, path: str, x, y, u, v,
             scalars: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Write a velocity field as a MATLAB v5 ``.mat`` file (beyond the
    reference; loads directly in MATLAB/Octave and interops with PIVlab
    post-processing).  Variables: ``x``, ``y``, ``u``, ``v`` as [R, C]
    float64 matrices plus any extra ``scalars`` maps under sanitised
    names.  Returns the (uniquified) path written."""
    from scipy.io import savemat

    os.makedirs(path, exist_ok=True)
    out = uniquify(os.path.join(path, name))
    data = {"x": x, "y": y, "u": u, "v": v}
    for key, field in (scalars or {}).items():
        safe = "".join(ch if ch.isalnum() else "_" for ch in key)
        if safe and safe[0].isdigit():
            safe = "f_" + safe
        data[safe] = field
    shape = np.asarray(u).shape
    arrays = {}
    for k, val in data.items():
        val = np.asarray(val, dtype=np.float64)
        if val.shape != shape:
            raise ValueError(f"{k!r} shape {val.shape} != field {shape}")
        arrays[k] = val
    savemat(out, arrays)
    return out


def save_hdf5(name: str, path: str, x, y, u, v,
              scalars: Optional[Dict[str, np.ndarray]] = None,
              attrs: Optional[Dict[str, object]] = None) -> str:
    """Write a velocity field as HDF5 (beyond the reference).  Layout:
    datasets ``x``/``y``/``u``/``v`` ([R, C] float64, gzip) at the root,
    extra ``scalars`` maps under ``/derived``, free-form ``attrs`` as root
    attributes.  Returns the (uniquified) path written."""
    import h5py

    os.makedirs(path, exist_ok=True)
    out = uniquify(os.path.join(path, name))
    shape = np.asarray(u).shape
    with h5py.File(out, "w") as f:
        for k, val in (("x", x), ("y", y), ("u", u), ("v", v)):
            val = np.asarray(val, dtype=np.float64)
            if val.shape != shape:
                raise ValueError(f"{k!r} shape {val.shape} != field {shape}")
            f.create_dataset(k, data=val, compression="gzip")
        if scalars:
            g = f.create_group("derived")
            for key, field in scalars.items():
                field = np.asarray(field, dtype=np.float64)
                if field.shape != shape:
                    raise ValueError(f"scalar {key!r} shape {field.shape} "
                                     f"!= field {shape}")
                g.create_dataset(key, data=field, compression="gzip")
        for key, val in (attrs or {}).items():
            f.attrs[key] = val
    return out


def save_vtk_tracks(name: str, path: str, tracks, scale: float = 1.0,
                    frame_height: Optional[int] = None) -> str:
    """Write Lagrangian trajectories as legacy-ASCII VTK polylines (loads
    directly in ParaView: one line per track, per-point ``track`` and
    ``frame`` scalars for coloring).  ``tracks``: iterables with
    ``.frames``/``.x``/``.y`` (models/ptv.py ``Trajectory``); positions
    are multiplied by ``scale`` (mm per px).  Pass ``frame_height`` (px)
    to apply the pipeline's image->physical y flip ((H-1-y)*scale), so
    the polylines overlay the field exports, which use that convention.
    Returns the path written."""
    tracks = list(tracks)
    if not tracks:
        raise ValueError("no trajectories to write")
    os.makedirs(path, exist_ok=True)
    out = uniquify(os.path.join(path, name))
    pts, lines, tids, frames = [], [], [], []
    for tid, trk in enumerate(tracks):
        start = len(pts)
        n = len(trk.frames)
        ys = (trk.y if frame_height is None
              else (frame_height - 1) - np.asarray(trk.y))
        pts.extend((float(x) * scale, float(y) * scale)
                   for x, y in zip(trk.x, ys))
        tids.extend([float(tid)] * n)
        frames.extend(float(f) for f in trk.frames)
        lines.append(list(range(start, start + n)))
    with open(out, "w") as f:
        f.write("# vtk DataFile Version 3.0\n"
                "torchpiv-tpu trajectories\nASCII\n"
                "DATASET POLYDATA\n")
        f.write(f"POINTS {len(pts)} float\n")
        for x, y in pts:
            f.write(f"{x:.6g} {y:.6g} 0\n")
        total = sum(len(l) + 1 for l in lines)
        f.write(f"LINES {len(lines)} {total}\n")
        for l in lines:
            f.write(" ".join([str(len(l))] + [str(i) for i in l]) + "\n")
        f.write(f"POINT_DATA {len(pts)}\n")
        for nm, vals in (("track", tids), ("frame", frames)):
            f.write(f"SCALARS {nm} float 1\nLOOKUP_TABLE default\n")
            f.write("\n".join(f"{v:.6g}" for v in vals) + "\n")
    return out


def save_vtk(name: str, path: str, x, y, u, v,
             scalars: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Write a velocity field as legacy-ASCII VTK structured grid (beyond
    the reference; loads directly in ParaView/VisIt).  ``x``/``y`` are the
    [R, C] coordinate grids, ``u``/``v`` the velocity components; extra
    per-point scalar maps (e.g. vorticity, uncertainty) go in ``scalars``.
    Returns the (uniquified) path written.
    """
    os.makedirs(path, exist_ok=True)
    out = uniquify(os.path.join(path, name))
    x, y, u, v = (np.asarray(a, dtype=np.float64) for a in (x, y, u, v))
    if not (x.shape == y.shape == u.shape == v.shape) or x.ndim != 2:
        raise ValueError("save_vtk expects matching [R, C] grids")
    r, c = x.shape
    n = r * c
    with open(out, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("torchpiv-tpu velocity field\n")
        f.write("ASCII\nDATASET STRUCTURED_GRID\n")
        f.write(f"DIMENSIONS {c} {r} 1\n")
        f.write(f"POINTS {n} float\n")
        for i in range(r):
            for j in range(c):
                f.write(f"{x[i, j]:.6g} {y[i, j]:.6g} 0\n")
        f.write(f"POINT_DATA {n}\n")
        f.write("VECTORS velocity float\n")
        for i in range(r):
            for j in range(c):
                f.write(f"{u[i, j]:.6g} {v[i, j]:.6g} 0\n")
        for key, field in (scalars or {}).items():
            field = np.asarray(field, dtype=np.float64)
            if field.shape != (r, c):
                raise ValueError(f"scalar {key!r} shape {field.shape} != "
                                 f"grid {(r, c)}")
            safe = "".join(ch if ch.isalnum() else "_" for ch in key)
            f.write(f"SCALARS {safe} float 1\nLOOKUP_TABLE default\n")
            for i in range(r):
                for j in range(c):
                    f.write(f"{field[i, j]:.6g}\n")
    return out
