"""Plain multipass PIV: the benchmark's reference for the engine and the
host tail.  Extraction, correlation, peak fit, validation, CWS refinement
and the infill tail are written from the published algorithm (TorchPIV's
``PIVbackend``: flat-index clamped addressing, 3-point Gaussian peak fit,
first/second peak ratio validation, a cubic spline predictor, border and
Delaunay infill of invalid vectors).  TorchPIV has no window deformation:
DEF is written from Scarano 2002 (Meas. Sci. Technol. 13 R1) as the port
states its mode (each window resampled at its half shift plus the
displacement gradient across it, symmetric between frames), on the same
addressing and predictor.

It imports nothing of the program under test.  Everything is computed in
``float64`` with plain torch operations on whatever device the frames are
on; the correlation is a direct DFT written as real matrix products, so
that ``precision="tf32"`` (the control: float32 with every matrix product's
operands rounded to TF32's 10-bit mantissa, as the tensor cores round them)
changes the arithmetic of a whole pass, not just one step.

``fields(frame_a, frame_b, cfg)`` returns the final pass's raw ``(u, v,
invalid)`` (pixels, image axes) and ``tail(u, v, invalid, cfg)`` the user's
``(x, y, u, v)``, or None where more than half of the field is invalid.
``cfg`` is the ``engine`` group of a configuration file plus its
``frame_shape``; keys it leaves out take the engine's documented defaults
(``DEFAULTS``).  ``settings`` refuses, with a ``ValueError`` that names the
key, every key whose semantics this reference does not compute (``ONLY``
lists the values it does compute), so that a configuration with another
correlation, fit, validation or infill is never compared with the wrong
arithmetic: such a configuration names a reference of its own.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

EPS = 1e-7  # added to the minimum-subtracted correlation before the log
DEFAULTS = dict(multipass=1, multipass_mode="CWS", multipass_scale=2.0,
                val_ratio=1.2, validation_window=3, max_shift=None,
                def_margin=2, scale=1.0, dt=1.0)
CHUNK = 1 << 16  # windows correlated at a time
# keys whose value, any value, the reference computes with
COMPUTED = ("frame_shape", "wind_size", "overlap", "multipass", "multipass_scale",
            "val_ratio", "validation_window", "max_shift", "def_margin", "scale", "dt")
# keys that choose only how the program computes the same arithmetic
IMPLEMENTATION = ("fused", "peakfit", "correlator", "dft_precision", "use_pallas",
                  "shift_variant", "pallas_interpret", "shift_maps", "complex_mm",
                  "extract_variant")
# parameters of features that ``ONLY`` holds off: they act on nothing here
INERT = ("median_threshold", "rpc_diameter", "fallback_threshold")
# keys whose semantics the reference computes at these values alone
ONLY = {"multipass_mode": ("CWS", "DEF"), "cws_interp": ("bilinear",),
        "correlation": ("scc",), "subpixel": ("gauss3",), "window_weight": (None,),
        "median_filter": (None,), "u_limits": (None,), "v_limits": (None,),
        "global_std": (None,), "second_peak_fallback": (False,), "validate": (True,),
        "infill": ("host",), "edge_exact": (True,), "dtype": ("float32",)}


def settings(cfg: dict) -> dict:
    """``cfg`` over ``DEFAULTS``; a ``ValueError`` naming the first key
    whose semantics the reference does not compute."""
    for key, value in cfg.items():
        if key in ONLY:
            if value not in ONLY[key]:
                raise ValueError(f"the reference computes {key} only at "
                                 f"{list(ONLY[key])}, not {value!r}")
        elif key not in COMPUTED + IMPLEMENTATION + INERT:
            raise ValueError(f"the reference does not compute the key {key!r}")
    out = dict(DEFAULTS)
    out.update(cfg)
    return out


def schedule(cfg: dict):
    """Per-pass ``(window, overlap)``: each pass divides the last by
    ``multipass_scale`` and truncates, as the published constructor does."""
    c = settings(cfg)
    w, o = int(c["wind_size"]), int(c["overlap"])
    out = [(w, o)]
    for _ in range(int(c["multipass"]) - 1):
        w, o = int(w // c["multipass_scale"]), int(o // c["multipass_scale"])
        out.append((w, o))
    return out


def grid(shape, w: int, o: int):
    """``(rows, cols)`` of windows, their top-left origins, and the window
    centres ``(x, y)`` with the published centring offset."""
    H, W = shape
    step = w - o
    nr, nc = (H - w) // step + 1, (W - w) // step + 1
    r0 = np.arange(nr) * step
    c0 = np.arange(nc) * step
    x = c0 + w / 2.0 + (W - 1 - ((nc - 1) * step + (w - 1))) // 2
    y = r0 + w / 2.0 + (H - 1 - ((nr - 1) * step + (w - 1))) // 2
    return (nr, nc), (r0, c0), (x, y)


# ----------------------------------------------------------------- arithmetic

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest,
    ties away from zero, as the tensor cores' input conversion does."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Arith:
    """The number type of one reference run: ``float64`` or ``tf32``."""

    def __init__(self, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return torch.matmul(_tf32(a), _tf32(b))
        return torch.matmul(a, b)


def _dft(n: int, dtype, device):
    k = torch.arange(n, dtype=torch.float64, device=device)
    ang = -2.0 * math.pi * torch.outer(k, k) / n
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def correlate(ar: Arith, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular cross-correlation ``c[s] = sum_p a[p] b[p + s]`` of ``[N, w,
    w]`` windows, zero shift at the centre (index ``w // 2``), by the DFT as
    matrix products: ``C = F^-1 (conj(F a F^T) * (F b F^T)) F^-T``."""
    n = a.shape[-1]
    cr, ci = _dft(n, ar.dtype, a.device)
    out = []
    for s in range(0, a.shape[0], CHUNK):
        x, y = a[s:s + CHUNK], b[s:s + CHUNK]
        # F x F^T with F = cr + i ci, x real
        xr, xi = ar.mm(cr, x), ar.mm(ci, x)
        xr, xi = ar.mm(xr, cr) - ar.mm(xi, ci), ar.mm(xr, ci) + ar.mm(xi, cr)
        yr, yi = ar.mm(cr, y), ar.mm(ci, y)
        yr, yi = ar.mm(yr, cr) - ar.mm(yi, ci), ar.mm(yr, ci) + ar.mm(yi, cr)
        # conj(X) * Y
        pr, pi = xr * yr + xi * yi, xr * yi - xi * yr
        # the inverse: conj(F) P conj(F)^T / n^2, real part
        qr, qi = ar.mm(cr, pr) + ar.mm(ci, pi), ar.mm(cr, pi) - ar.mm(ci, pr)
        c = (ar.mm(qr, cr) + ar.mm(qi, ci)) / (n * n)
        out.append(torch.roll(c, (n // 2, n // 2), dims=(-2, -1)))
    return torch.cat(out)


def peak_fit(corr: torch.Tensor, val_ratio: float, vw: int):
    """``[N, d, k]`` raw maps -> ``(u, v, invalid)``: the minimum subtracted,
    the first maximum, the 3-point Gaussian fit on the flattened map (a
    neighbour index at or past either end is the peak itself), and the
    ratio of the peak to the highest sample outside its ``(2 vw + 1)^2``
    neighbourhood, taken by flat offset, which also excludes the first or
    last sample where the neighbourhood runs off that end."""
    n, d, k = corr.shape
    kd = d * k
    flat = corr.reshape(n, kd)
    lift = EPS - flat.amin(dim=1)
    m = torch.argmax(flat, dim=1)

    def at(i):
        return flat.gather(1, i[:, None])[:, 0] + lift

    left = torch.where(m + 1 >= kd - 1, m, m + 1)
    right = torch.where(m - 1 <= 0, m, m - 1)
    top = torch.where(m + k >= kd - 1, m, m + k)
    bot = torch.where(m - k <= 0, m, m - k)
    cm = at(m)
    lm, ll, lr, lt, lb = (torch.log(at(i)) for i in (m, left, right, top, bot))
    du = (lr - ll) / (2.0 * (ll + lr) - 4.0 * lm)
    dv = (lb - lt) / (2.0 * (lb + lt) - 4.0 * lm)
    row = torch.div(m, d, rounding_mode="floor").to(flat.dtype)
    col = (m % k).to(flat.dtype)
    u = torch.nan_to_num(col + du - k // 2)
    v = torch.nan_to_num(row + dv - d // 2)

    pos = torch.arange(kd, device=flat.device)
    off = pos[None, :] - m[:, None]
    j = torch.round(off.to(torch.float64) / k).to(off.dtype)
    excl = (j.abs() <= vw) & ((off - k * j).abs() <= vw)
    reach = vw + k * vw
    excl[:, 0] |= (m - reach) < 0
    excl[:, kd - 1] |= (m + reach) > kd - 1
    second = flat.masked_fill(excl, -torch.inf).amax(dim=1) + lift
    invalid = cm / torch.clamp(second, min=0.0) < val_ratio
    invalid |= (left >= kd - 1) & (right <= 0) & (top >= kd - 1) & (bot <= 0)
    return u, v, invalid


def windows(frame: torch.Tensor, w: int, o: int) -> torch.Tensor:
    """Every window of a ``[H, W]`` frame, row-major, ``[N, w, w]``."""
    step = w - o
    return frame.unfold(0, w, step).unfold(1, w, step).reshape(-1, w, w)


def _flat_sample(flat: torch.Tensor, H: int, W: int, yi, xi):
    """The frame at integer ``(yi, xi)`` by the published flat index,
    ``yi * W + xi`` clamped to the frame's first and last pixel."""
    return flat[(yi * W + xi).clamp(0, H * W - 1)]


def shifted_windows(frame, r0, c0, w, sx, sy, S):
    """CWS: each window's pixels sampled at its origin plus ``(sy, sx)``
    (one shift a window, clipped to ``+-S``), bilinear; where the shift is
    an integer in either axis the window is the floor corner's copy."""
    H, W = frame.shape
    flat = frame.reshape(-1)
    sx, sy = sx.clamp(-S, S), sy.clamp(-S, S)
    dx, dy = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - dx)[:, None, None], (sy - dy)[:, None, None]
    ar = torch.arange(w, device=frame.device)
    y = (r0[:, None] + dy.long()[:, None] + ar)[:, :, None]
    x = (c0[:, None] + dx.long()[:, None] + ar)[:, None, :]
    f11 = _flat_sample(flat, H, W, y, x)
    f21 = _flat_sample(flat, H, W, y, x + 1)
    f12 = _flat_sample(flat, H, W, y + 1, x)
    f22 = _flat_sample(flat, H, W, y + 1, x + 1)
    blend = (f11 * (1 - fx) * (1 - fy) + f21 * fx * (1 - fy)
             + f12 * (1 - fx) * fy + f22 * fx * fy)
    return torch.where((fx == 0) | (fy == 0), f11, blend)


def deformed_windows(frame, r0, c0, w, maps, S, M):
    """DEF: each pixel ``(i, j)`` sampled at its window's origin plus the
    centre shift (clipped to ``+-S``) plus the shift's gradient times the
    pixel's offset from the window centre, bilinear; the part of the shift
    beyond the integer centre shift is held within ``[-M, M + 1)`` (the
    deformation margin).  A pixel whose position is an integer in either
    axis takes the floor corner's value."""
    sx, sy, dudx, dudy, dvdx, dvdy = maps
    H, W = frame.shape
    flat = frame.reshape(-1)
    sx, sy = sx.clamp(-S, S), sy.clamp(-S, S)
    dx, dy = torch.floor(sx), torch.floor(sy)
    off = torch.arange(w, device=frame.device, dtype=frame.dtype) - (w - 1) / 2.0
    io, jo = off[:, None], off[None, :]
    hi = 2 * M + 1 - 1e-3

    def resid(f, gi, gj):
        r = M + f[:, None, None] + gi[:, None, None] * io + gj[:, None, None] * jo
        return r.clamp(0.0, hi)

    ry = resid(sy - dy, dvdy, dvdx)
    rx = resid(sx - dx, dudy, dudx)
    fry, frx = torch.floor(ry), torch.floor(rx)
    whole = (ry == fry) | (rx == frx)
    ty, tx = ry - fry, rx - frx
    ar = torch.arange(w, device=frame.device)
    y = (r0 + dy.long() - M)[:, None, None] + ar[:, None] + fry.long()
    x = (c0 + dx.long() - M)[:, None, None] + ar[None, :] + frx.long()
    f11 = _flat_sample(flat, H, W, y, x)
    f21 = _flat_sample(flat, H, W, y, x + 1)
    f12 = _flat_sample(flat, H, W, y + 1, x)
    f22 = _flat_sample(flat, H, W, y + 1, x + 1)
    blend = (f11 * (1 - tx) * (1 - ty) + f21 * tx * (1 - ty)
             + f12 * (1 - tx) * ty + f22 * tx * ty)
    return torch.where(whole, f11, blend)


def spline_up(field: torch.Tensor, y0, x0, y1, x1) -> torch.Tensor:
    """The cubic interpolating spline of a coarse ``[R0, C0]`` field on the
    fine grid (scipy's ``RectBivariateSpline``, degree 3 or less on tiny
    grids), computed in float64 on the host."""
    from scipy.interpolate import RectBivariateSpline

    k = min(3, len(y0) - 1, len(x0) - 1)
    f = field.detach().to("cpu", torch.float64).numpy()
    up = RectBivariateSpline(y0, x0, f, kx=k, ky=k)(y1, x1)
    return torch.from_numpy(up).to(field.device, field.dtype)


def gradient(f: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """Central differences inside, one-sided at the two ends, spacing ``h``."""
    n = f.shape[dim]
    first = (f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)) / h
    last = (f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)) / h
    inner = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) * 0.5 / h
    return torch.cat([first, inner, last], dim=dim)


# ----------------------------------------------------------------- the engine

def fields(frame_a: torch.Tensor, frame_b: torch.Tensor, cfg: dict,
           precision: str = "float64"):
    """One pair's final ``(u, v, invalid)`` on the last pass's grid."""
    c = settings(cfg)
    ar = Arith(precision)
    H, W = c["frame_shape"]
    fa = frame_a.to(ar.dtype)
    fb = frame_b.to(ar.dtype)
    passes = schedule(c)
    mode = c["multipass_mode"]
    vr, vw = c["val_ratio"], c["validation_window"]
    dev = fa.device

    # pass 1: windows normalised by their mean, correlated, fitted
    w, o = passes[0]
    (nr, nc), _, (x, y) = grid((H, W), w, o)
    a, b = windows(fa, w, o), windows(fb, w, o)
    a = a / a.mean(dim=(-2, -1), keepdim=True)
    b = b / b.mean(dim=(-2, -1), keepdim=True)
    u, v, inval = peak_fit(correlate(ar, a, b), vr, vw)
    u, v, inval = u.reshape(nr, nc), v.reshape(nr, nc), inval.reshape(nr, nc)
    del a, b

    for w, o in passes[1:]:
        (nr, nc), (r0, c0), (x1, y1) = grid((H, W), w, o)
        u0 = spline_up(u, y, x, y1, x1)
        v0 = spline_up(v, y, x, y1, x1)
        was_bad = spline_up(inval.to(ar.dtype), y, x, y1, x1) >= 0.5
        u2, v2 = u0 / 2.0, v0 / 2.0  # the half shift, before zeroing
        u0 = torch.where(was_bad, 0.0, u0)
        v0 = torch.where(was_bad, 0.0, v0)
        S = c["max_shift"] if c["max_shift"] is not None else max(w // 2, 1)
        rr = torch.from_numpy(np.repeat(r0, nc)).to(dev)
        cc = torch.from_numpy(np.tile(c0, nr)).to(dev)
        if mode == "CWS":
            sx, sy = u2.reshape(-1), v2.reshape(-1)
            a = shifted_windows(fa, rr, cc, w, -sx, -sy, S)
            b = shifted_windows(fb, rr, cc, w, sx, sy, S)
        else:
            step = float(w - o)
            maps = [u2, v2, gradient(u2, step, 1), gradient(u2, step, 0),
                    gradient(v2, step, 1), gradient(v2, step, 0)]
            maps = [m.reshape(-1) for m in maps]
            M = c["def_margin"]
            a = deformed_windows(fa, rr, cc, w, [-m for m in maps], S, M)
            b = deformed_windows(fb, rr, cc, w, maps, S, M)
        du, dv, bad = peak_fit(correlate(ar, a, b), vr, vw)
        del a, b
        du, dv, bad = du.reshape(nr, nc), dv.reshape(nr, nc), bad.reshape(nr, nc)
        # keep the predictor where the correction diverges or fails
        keep_u = ((du > u0) & (torch.round(u0) > 0)) | bad
        keep_v = ((dv > v0) & (torch.round(v0) > 0)) | bad
        u = torch.where(keep_u, u0, 2.0 * u2 + du)
        v = torch.where(keep_v, v0, 2.0 * v2 + dv)
        inval, x, y = bad, x1, y1
    return u, v, inval


# ------------------------------------------------------------------- the tail

def _border_interp(f: np.ndarray) -> None:
    """1-D linear infill of NaNs along each of the four borders, in place
    (a border that is all NaN stays so)."""
    for line in (f[0, :], f[-1, :], f[:, 0], f[:, -1]):
        bad = np.isnan(line)
        if bad.any() and not bad.all():
            idx = np.arange(line.size)
            line[bad] = np.interp(idx[bad], idx[~bad], line[~bad])


def _delaunay_fill(f: np.ndarray) -> Optional[np.ndarray]:
    """Fill NaN holes linearly over the Delaunay triangulation of the valid
    vectors that touch a hole (4-neighbours); None where the published rule
    gives up: the touching points' coordinates (two a point) number half
    the field or more, or the triangulation fails."""
    from scipy.interpolate import LinearNDInterpolator
    from scipy.spatial import QhullError

    bad = np.isnan(f)
    if not bad.any():
        return f
    grow = bad.copy()
    grow[1:, :] |= bad[:-1, :]
    grow[:-1, :] |= bad[1:, :]
    grow[:, 1:] |= bad[:, :-1]
    grow[:, :-1] |= bad[:, 1:]
    ring = grow & ~bad
    pts = np.argwhere(ring)
    if 2 * len(pts) >= f.size / 2:
        return None
    try:
        f[bad] = LinearNDInterpolator(pts, f[ring])(np.argwhere(bad))
    except (QhullError, ValueError):
        return None
    return f


def tail(u, v, invalid, cfg: dict):
    """The user's ``(x, y, u, v)`` of one pair: invalid vectors NaN, border
    and Delaunay infill, the y axis flipped to point up, units ``scale /
    dt * 1000``; None where the infill gives up."""
    c = settings(cfg)
    w, o = schedule(c)[-1]
    _, _, (x, y) = grid(c["frame_shape"], w, o)
    xx, yy = np.meshgrid(x, y)
    out = []
    for f in (u, v):
        f = np.array(f.detach().cpu() if torch.is_tensor(f) else f, dtype=np.float64)
        if invalid is not None:
            f[np.asarray(invalid.detach().cpu() if torch.is_tensor(invalid) else invalid)] = np.nan
            _border_interp(f)
            f = _delaunay_fill(f)
            if f is None:
                return None
        out.append(f)
    k = c["scale"] / c["dt"] * 1000
    return (xx * c["scale"], yy * c["scale"],
            np.flip(out[0], axis=0) * k, -np.flip(out[1], axis=0) * k)


def run(frame_a, frame_b, cfg: dict, precision: str = "float64"):
    """``(x, y, u, v)`` or None, and the raw invalid mask, of one pair."""
    u, v, inval = fields(frame_a, frame_b, cfg, precision)
    return tail(u, v, inval, cfg), inval.cpu().numpy()
