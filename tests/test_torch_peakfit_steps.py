"""The CUDA peak-fit kernel's work split (``csrc/peakfit.cu``: a warp a
map, the exclusion test only on the rows that can hold it) replayed on the
CPU by ``ops.peakfit.warp_fit_steps``, against the plain version
``correlation_to_displacement`` and the TPU kernel it replaces
(``correlation_to_displacement_pallas`` in interpret mode).

Tolerances: the step model must equal the plain version exactly
(``torch.equal``: both take the same logarithms and round every sum in the
same order).  With ``min_subtract`` the kernel, like the TPU kernel, adds
EPS after subtracting the minimum and the plain version adds ``EPS - min``
in one step; those differ for samples within about 2 of the minimum, so the
maps that test it have one pedestal pixel below all others, away from the
peaks.  Against the TPU kernel: ``u, v`` within 1e-5 px and equal masks,
the tolerance of ``tests/test_torch_ops.py``'s comparison of the plain
version with it."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import _maps as _ops_maps  # the seeded maps of the plain version's tests
from torchpiv_tpu.experimental.peakfit_pallas import correlation_to_displacement_pallas
from torchpiv_tpu_torch.kernels import _build
from torchpiv_tpu_torch.ops.peakfit import (WARP_FIT_MAX,
                                            correlation_to_displacement,
                                            warp_fit_plan, warp_fit_steps)

WIDTHS = (4, 8, 16, 32, 64, 128)
WINDOWS = (0, 1, 3, 5)


def _maps(d, vw, seed=0):
    """Random maps and the corner cases of the fit: peaks at flat 0 and
    kd - 1, on every edge and corner, within vw rows and columns of each
    edge (the exclusion set's collapse onto 0 and kd - 1), a second peak
    just outside and just inside the exclusion set, exact ties, constant
    maps and maps that hold a NaN."""
    rng = np.random.default_rng(seed * 1000 + d * 10 + vw)
    maps = [rng.uniform(0, 1, (d, d)) for _ in range(4)]
    near = min(vw, d - 1)
    places = {(0, 0), (0, d - 1), (d - 1, 0), (d - 1, d - 1), (0, d // 2),
              (d - 1, d // 3), (d // 2, 0), (d // 3, d - 1), (near, near),
              (d - 1 - near, d - 1 - near), (near, d - 1), (d - 1, near),
              (min(near + 1, d - 1), d // 2), (d // 2, d // 2)}
    for r, c in sorted(places):
        m = rng.uniform(0, 0.3, (d, d))
        m[r, c] = 1.0
        maps.append(m)
    for off in (vw, vw + 1):  # a second peak at the exclusion set's edge
        m = rng.uniform(0, 0.1, (d, d))
        r = c = d // 2
        m[r, c] = 1.0
        m[min(r + off, d - 1), c] = 0.95
        m[r, min(c + off, d - 1)] = 0.9
        maps.append(m)
    last = max(d * d - 2, 0)
    tie = rng.uniform(0, 0.5, (d, d))
    tie.flat[[min(d + 1, last), last]] = 1.0  # the first index wins
    maps.append(tie)
    maps.append(np.full((d, d), 0.25))
    maps.append(np.zeros((d, d)))
    for where in (0, d * d // 2, d * d - 1, last):
        m = rng.uniform(0, 1, (d, d))
        m.flat[where] = np.nan
        maps.append(m)
    nans = rng.uniform(0, 1, (d, d))
    nans.flat[[d // 2, d * d // 3]] = np.nan
    maps.append(nans)
    return np.stack(maps).astype(np.float32)


def _pedestal(maps):
    """Raw maps with a per-window offset and one pedestal pixel below all
    others, half the map away from the peak (see the module docstring)."""
    flat = maps.reshape(len(maps), -1).copy()
    kd = flat.shape[1]
    for row in flat:
        m = int(np.nanargmax(row))
        row[(m + kd // 2) % kd] = np.nanmin(row) - 1.0
    return flat.reshape(maps.shape) * 40.0 - 7.0


def _assert_equal(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_plan_matches_the_kernel_source():
    """``warp_fit_plan`` repeats ``PIV_FOR_MAP`` of ``csrc/peakfit.cu``, and
    every chunked instance holds its largest map in ``MAXC`` chunks."""
    src = (_build.CSRC / "peakfit.cu").read_text()
    rows = [(int(d), int(ch), int(mc)) for d, ch, mc in re.findall(
        r"if \(\(d\) <= (\d+)\) return fn<(\d+), (\d+)>", src)]
    assert rows and rows[-1][0] == WARP_FIT_MAX
    for d in range(1, WARP_FIT_MAX + 1):
        ch, maxc = next((ch, mc) for top, ch, mc in rows if d <= top)
        assert warp_fit_plan(d) == (ch, maxc)
        assert -(-d * d // (32 * ch)) <= maxc
    with pytest.raises(ValueError):
        warp_fit_plan(WARP_FIT_MAX + 1)


@pytest.mark.parametrize("vw", WINDOWS)
@pytest.mark.parametrize("d", WIDTHS)
def test_steps_equal_plain_version(d, vw):
    maps = torch.from_numpy(_maps(d, vw))
    for validate in (True, False):
        _assert_equal(warp_fit_steps(maps, validate, 1.2, vw),
                      correlation_to_displacement(maps, validate, 1.2, vw))
    _, _, inval = warp_fit_steps(maps, True, 1.2, vw)
    assert not inval.all()
    if 2 * vw + 1 < d:  # else every sample is excluded and c2 = 0
        assert inval.any()


@pytest.mark.parametrize("vw", WINDOWS)
@pytest.mark.parametrize("d", WIDTHS)
def test_steps_equal_plain_version_min_subtract(d, vw):
    maps = torch.from_numpy(_pedestal(_maps(d, vw)))
    _assert_equal(warp_fit_steps(maps, True, 1.2, vw, min_subtract=True),
                  correlation_to_displacement(maps, True, 1.2, vw, min_subtract=True))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 12, 23, 33, 40, 65, 100, 127])
def test_steps_equal_plain_version_at_ragged_sizes(d):
    """Sizes whose last chunk holds fewer than 32 samples a slot, and the
    boundaries between instances."""
    for vw in (0, 2, 7):
        maps = torch.from_numpy(_maps(d, vw, seed=1))
        _assert_equal(warp_fit_steps(maps, True, 1.2, vw),
                      correlation_to_displacement(maps, True, 1.2, vw))


def test_steps_nan_maps_fit_to_zero_at_the_first_nan():
    d = 16
    maps = np.random.default_rng(4).uniform(0, 1, (3, d, d)).astype(np.float32)
    maps[0].flat[[0, 9]] = np.nan  # the first NaN at flat 0
    maps[1].flat[[200, 7]] = np.nan  # ... at 7, the lower index
    maps[2][:] = np.nan
    u, v, inval = warp_fit_steps(torch.from_numpy(maps))
    assert torch.equal(u, torch.zeros(3)) and torch.equal(v, torch.zeros(3))
    want = correlation_to_displacement(torch.from_numpy(maps))
    _assert_equal((u, v, inval), want)


def test_steps_reject_what_the_warp_kernel_does_not_take():
    with pytest.raises(ValueError):
        warp_fit_steps(torch.zeros(2, 8, 9))
    with pytest.raises(ValueError):
        warp_fit_steps(torch.zeros(1, WARP_FIT_MAX + 2, WARP_FIT_MAX + 2))


@pytest.mark.parametrize("min_sub", [False, True])
@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("d", [16, 32])
def test_steps_match_pallas_kernel(d, min_sub, validate):
    maps = _ops_maps(d)
    if min_sub:
        maps[:, d // 2 + 3, d // 2 + 4] = maps.min(axis=(1, 2)) - 1.0
        maps = maps * 40.0 - 7.0
    tu, tv, ti = warp_fit_steps(torch.from_numpy(maps), validate, 1.2, 3,
                                min_subtract=min_sub)
    ju, jv, ji = correlation_to_displacement_pallas(
        jnp.asarray(maps), validate, 1.2, 3, interpret=True, min_subtract=min_sub)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    if validate:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.any() and not ti.all()
    else:
        assert ti is None and ji is None


@pytest.mark.parametrize("window", [1, 3, 5])
def test_steps_exclusion_window_matches_pallas_kernel(window):
    maps = _ops_maps(d=32)
    _, _, ti = warp_fit_steps(torch.from_numpy(maps), True, 1.1, window)
    _, _, ji = correlation_to_displacement_pallas(
        jnp.asarray(maps), True, 1.1, window, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_peakfit_anatomy_tool_edits_the_committed_source():
    """``tools/peakfit_anatomy_cuda.py``: every edit of every mode matches
    the committed ``peakfit.cu`` exactly once, ``full`` is the source
    itself, and each instance mode serves its pass with a plan that holds
    the map."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "peakfit_anatomy_cuda.py"
    spec = importlib.util.spec_from_file_location("peakfit_anatomy_cuda", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    committed = (_build.CSRC / "peakfit.cu").read_text()
    assert tool.edited_sources("full") == {"peakfit.cu": committed}
    for mode in tool.EDITS:
        edited = tool.edited_sources(mode)["peakfit.cu"]
        assert (edited == committed) == (mode == "full")
    for label, (w, _, _) in tool.PASSES.items():
        assert tool.COMMITTED[label] == warp_fit_plan(w)
        for mode, (ch, maxc) in tool.INSTANCE[label].items():
            assert f"fn<{ch}, {maxc}>" in tool.edited_sources(mode)["peakfit.cu"]
            assert -(-w * w // (32 * ch)) <= maxc
