"""The port's ``EnsemblePIV``, ``MultiDtPIV``, ``FolkiPIV``/``folki_flow``
and ``PTV`` on the CPU against the JAX package's, each port object built
from the JAX one by ``state.from_jax_model``, on the same seeded frames.

Tolerances (measured on these inputs in brackets):

* ``EnsemblePIV``: u, v <= 1e-4 px on valid windows [1.9e-6], invalid masks
  equal; ``corr_batch`` sums over two batches, divided by the pair count,
  then ``finalize``: within 1e-4 px of ``forward``;
* ``MultiDtPIV`` (the JAX engine with ``use_pallas="off",
  pallas_interpret=True``): the parity budget, RMS < 0.01 px on jointly
  valid windows [1.8e-7] with < 2% mask mismatch, ``dt_map`` equal on >= 98%
  [100%]; the one batched engine call within the same budget of the k
  single calls [bit-equal];
* ``folki_flow`` and ``FolkiPIV``: dense and grid RMS <= 1e-3 px [1.4e-6,
  3.9e-6 hybrid], ``bad`` mismatch <= 2% [0];
* ``PTV``: equal detection counts, >= 99% of the tracks common, their u, v
  <= 1e-4 px [8.6e-6];
* ``jax.image.resize(..., "bilinear")`` upsampling against the port's
  ``F.interpolate``: <= 1e-6 [4.8e-7].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.models import EnsemblePIV as JaxEnsemblePIV
from torchpiv_tpu.models import FolkiPIV as JaxFolkiPIV
from torchpiv_tpu.models import MultiDtPIV as JaxMultiDtPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu.models import PTV as JaxPTV
from torchpiv_tpu.models import folki_flow as jax_folki_flow
from torchpiv_tpu.models import ptv as jax_ptv
from torchpiv_tpu.models.multidt import merge_multi_dt as jax_merge_multi_dt
from torchpiv_tpu_torch import models
from torchpiv_tpu_torch.config import PIVConfig
from torchpiv_tpu_torch.models import ptv
from torchpiv_tpu_torch.models.folki import _upsample
from torchpiv_tpu_torch.state import from_jax_engine_state, from_jax_model
from torchpiv_tpu_torch.utils.synthetic import particle_pair, render_particles, shear_flow

SHAPE = (128, 128)
PALLAS_OFF = dict(use_pallas="off", pallas_interpret=True)


def _rms(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d ** 2)))


def _engine_of(jax_model):
    eng = getattr(jax_model, "engine", None) or jax_model._engine
    return getattr(eng, "__wrapped__", eng)


def _same_engine_state(port_model, jax_model):
    want = from_jax_engine_state(_engine_of(jax_model))
    got = port_model.engine.state_dict()
    # the tapers and RPC filters are derived from the config, not the state
    rest = {k for k, v in got.items() if v is not None} - set(want)
    assert all(k.startswith(("weight_", "rpc_")) for k in rest), rest
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ----- EnsemblePIV ---------------------------------------------------------

def _sparse_batch(n, seed0=200, density=0.004, disp=(3.3, -2.1)):
    pairs = [particle_pair(SHAPE, disp, density=density, seed=seed0 + i) for i in range(n)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize("peakfit", ["xla", "pallas"])
@pytest.mark.parametrize("window_weight", [None, "gaussian"])
@pytest.mark.parametrize("w,o", [(32, 16), (64, 32)])
def test_ensemble_matches_jax(peakfit, window_weight, w, o):
    A, B = _sparse_batch(4)
    jm = JaxEnsemblePIV(JaxPIVConfig(frame_shape=SHAPE, wind_size=w, overlap=o, multipass=1,
                                     peakfit=peakfit, window_weight=window_weight,
                                     pallas_interpret=True))
    ju, jv, ji = (np.asarray(a) for a in jm(jnp.asarray(A), jnp.asarray(B)))
    pm = from_jax_model(jm)
    _same_engine_state(pm, jm)
    u, v, inval = (t.numpy() for t in pm(torch.from_numpy(A), torch.from_numpy(B)))
    np.testing.assert_array_equal(inval, ji)
    ok = ~inval
    assert ok.mean() > 0.5
    assert np.abs(u - ju)[ok].max() <= 1e-4 and np.abs(v - jv)[ok].max() <= 1e-4
    assert np.allclose(pm.final_coordinates[0], jm.final_coordinates[0])


def test_ensemble_streaming_equals_one_call():
    A, B = _sparse_batch(6, seed0=220)
    pm = models.EnsemblePIV(PIVConfig(frame_shape=SHAPE, wind_size=32, overlap=16,
                                      multipass=1), device="cpu")
    u, v, inval = pm(torch.from_numpy(A), torch.from_numpy(B))
    acc = sum(pm.corr_batch(torch.from_numpy(A[s]), torch.from_numpy(B[s]))
              for s in (slice(0, 3), slice(3, 6)))
    su, sv, sinval = pm.finalize(acc / 6)
    assert torch.equal(sinval, inval)
    assert (su - u).abs().max() <= 1e-4 and (sv - v).abs().max() <= 1e-4


def test_ensemble_beats_single_pairs_on_sparse_seeding():
    """Averaging planes recovers the displacement where single pairs fail."""
    A, B = _sparse_batch(8, seed0=240, density=0.002)
    cfg = PIVConfig(frame_shape=SHAPE, wind_size=32, overlap=16, multipass=1)
    u, v, inval = models.EnsemblePIV(cfg, device="cpu")(torch.from_numpy(A), torch.from_numpy(B))
    single = models.MultipassPIV(cfg, device="cpu")(torch.from_numpy(A), torch.from_numpy(B))[2]
    assert (~inval).float().mean() > (~single).float().mean()
    assert abs(float(u[~inval].mean()) - 3.3) < 0.1 and abs(float(v[~inval].mean()) + 2.1) < 0.1


def test_ensemble_refuses_what_the_jax_one_refuses():
    with pytest.raises(ValueError, match="single-pass"):
        models.EnsemblePIV(PIVConfig(frame_shape=SHAPE, multipass=2), device="cpu")
    with pytest.raises(ValueError, match="correlator='fft'"):
        models.EnsemblePIV(PIVConfig(frame_shape=SHAPE, multipass=1, dtype="bfloat16",
                                     correlator="fft", fused="split"), device="cpu")


# ----- MultiDtPIV ----------------------------------------------------------

def _sequence(du, seed, T=5, density=0.02, H=128):
    rng = np.random.default_rng(seed)
    n = int(density * H * H)
    xs, ys = rng.uniform(0, H, n), rng.uniform(0, H, n)
    inten = rng.uniform(100, 220, n)
    return np.stack([np.clip(render_particles((H, H), xs + du * t, ys, inten), 0, 255)
                     .astype(np.uint8) for t in range(T)])


@pytest.mark.parametrize("mode,seps,du", [("CWS", (1, 2, 4), 0.8), ("DWS", (1, 3), 0.5),
                                          ("CWS", (2, 1), 2.3)])
def test_multidt_matches_jax(mode, seps, du):
    frames = _sequence(du, seed=4)
    cfg = JaxPIVConfig(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
                       multipass_mode=mode, **PALLAS_OFF)
    jm = JaxMultiDtPIV(cfg, separations=seps)
    pm = from_jax_model(jm)
    _same_engine_state(pm, jm)
    assert pm.separations == jm.separations
    jr, pr = jm(frames, 0), pm(frames, 0)
    assert np.mean(jr.invalid != pr.invalid) < 0.02
    both = ~(jr.invalid | pr.invalid)
    assert both.mean() > 0.5
    assert _rms(pr.u[both], jr.u[both]) < 0.01 and _rms(pr.v[both], jr.v[both]) < 0.01
    assert np.mean(jr.dt_map == pr.dt_map) >= 0.98


def _merge_from(fields, pm):
    return models.merge_multi_dt(fields, pm.separations, pm.config.pass_schedule()[0][0],
                                 pm.max_disp_frac, pm.consistency_px)


def test_multidt_batched_call_equals_k_single_calls():
    frames = _sequence(0.8, seed=6)
    pm = models.MultiDtPIV(PIVConfig(frame_shape=SHAPE, wind_size=64, overlap=32,
                                     multipass=2), separations=(1, 2, 4), device="cpu")
    singles = [tuple(t.numpy() for t in pm.engine(torch.from_numpy(frames[0]),
                                                  torch.from_numpy(frames[k])))
               for k in pm.separations]
    want = _merge_from(singles, pm)
    got = pm(frames, 0)
    assert np.mean(got.invalid != want.invalid) < 0.02
    both = ~(got.invalid | want.invalid)
    assert _rms(got.u[both], want.u[both]) < 0.01 and _rms(got.v[both], want.v[both]) < 0.01
    np.testing.assert_array_equal(got.dt_map, want.dt_map)
    assert (got.dt_map == 4).mean() > 0.95 and abs(np.median(got.u) - 0.8) < 0.02


def test_multidt_quarter_rule_against_the_first_pass():
    """A 3 px/frame flow: at 4 frames (12 px) the vector breaks the quarter
    rule of the first pass's 32 px window, so dt 2 (6 px) is kept."""
    frames = _sequence(3.0, seed=8)
    pm = models.MultiDtPIV(PIVConfig(frame_shape=SHAPE, wind_size=32, overlap=16,
                                     multipass=2), separations=(1, 2, 4), device="cpu")
    res = pm(frames, 0)
    assert not (res.dt_map == 4).any()
    assert (res.dt_map == 2).mean() > 0.8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_multi_dt_copy_equals_original(seed):
    rng = np.random.default_rng(seed)
    fields = [(rng.normal(k * 0.7, 0.3, (6, 7)), rng.normal(0, 0.3, (6, 7)),
               rng.random((6, 7)) < 0.15) for k in (1, 2, 4)]
    got = models.merge_multi_dt(fields, [1, 2, 4], 32, 0.25, 0.5)
    want = jax_merge_multi_dt(fields, [1, 2, 4], 32, 0.25, 0.5)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))


def test_multidt_refuses_bad_input():
    cfg = PIVConfig(frame_shape=SHAPE, wind_size=32, overlap=16, multipass=1)
    with pytest.raises(ValueError, match="separations"):
        models.MultiDtPIV(cfg, separations=(0, 2), device="cpu")
    pm = models.MultiDtPIV(cfg, separations=(1, 4), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        pm(_sequence(0.5, seed=1), t=2)
    with pytest.raises(ValueError, match=r"\[T, H, W\]"):
        pm(np.zeros(SHAPE, np.uint8), t=0)


# ----- FOLKI ---------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((7, 9), (128, 96)), ((8, 8), (16, 16)),
                                     ((15, 15), (128, 128)), ((3, 5), (4, 11)),
                                     ((64, 64), (128, 128))])
def test_resize_is_the_jax_bilinear_resize(src, dst):
    x = np.random.default_rng(1).normal(size=src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    assert np.abs(_upsample(torch.from_numpy(x), dst).numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("disp", [(3.3, -2.1), (0.6, 1.4), "shear"])
@pytest.mark.parametrize("radius,levels", [(8, 2), (4, 3)])
def test_folki_flow_matches_jax(disp, radius, levels):
    d = shear_flow(1.0, 0.02) if disp == "shear" else disp
    fa, fb = particle_pair(SHAPE, d, seed=7, density=0.02)
    ju, jv = (np.asarray(a) for a in jax_folki_flow(jnp.asarray(fa), jnp.asarray(fb),
                                                    radius=radius, iters=6, levels=levels))
    u, v = (t.numpy() for t in models.folki_flow(torch.from_numpy(fa), torch.from_numpy(fb),
                                                 radius=radius, iters=6, levels=levels))
    assert u.shape == SHAPE
    assert _rms(u, ju) <= 1e-3 and _rms(v, jv) <= 1e-3


@pytest.mark.parametrize("w,o", [(32, 16), (16, 8)])
def test_folki_piv_dense_matches_jax(w, o):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=9, density=0.02)
    jm = JaxFolkiPIV(SHAPE, w, o, levels=2)
    pm = from_jax_model(jm)
    assert (pm.radius, pm.iters, pm.levels) == (jm.radius, jm.iters, jm.levels)
    ju, jv, jbad = jm(fa, fb)
    u, v, bad = pm(fa, fb)
    assert u.shape == ju.shape == pm.coordinates[0].shape
    assert _rms(u, ju) <= 1e-3 and _rms(v, jv) <= 1e-3
    assert np.mean(bad != jbad) <= 0.02
    good = ~bad
    assert good.mean() > 0.5 and abs(np.median(u[good]) - 3.3) < 0.05


def test_folki_piv_hybrid_matches_jax():
    """Beyond LK's capture range (11 px): the correlation engine anchors."""
    fa, fb = particle_pair(SHAPE, (11.0, 0.0), seed=9, density=0.02)
    cfg = JaxPIVConfig(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2, **PALLAS_OFF)
    jm = JaxFolkiPIV(SHAPE, 32, 16, levels=2, piv_config=cfg)
    pm = from_jax_model(jm)
    _same_engine_state(pm, jm)
    ju, jv, jbad = jm(fa, fb)
    u, v, bad = pm(fa, fb)
    assert _rms(u, ju) <= 1e-3 and _rms(v, jv) <= 1e-3
    assert np.mean(bad != jbad) <= 0.02
    assert abs(np.median(u) - 11.0) < 0.05 and abs(np.median(v)) < 0.05


def test_folki_refuses_what_the_jax_one_refuses():
    with pytest.raises(ValueError, match="IDENTICAL grids"):
        models.FolkiPIV(SHAPE, 32, 8, piv_config=PIVConfig(frame_shape=SHAPE, wind_size=64,
                                                           overlap=32, multipass=2),
                        device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        models.folki_flow(torch.zeros(100, 100), torch.zeros(100, 100), levels=4)


# ----- PTV -----------------------------------------------------------------

def _tracks(res):
    return {(round(float(x), 3), round(float(y), 3)): (u, v)
            for x, y, u, v in zip(res.x, res.y, res.u, res.v)}


def _same_tracks(got, want):
    assert (got.n_a, got.n_b) == (want.n_a, want.n_b)
    g, w = _tracks(got), _tracks(want)
    common = set(g) & set(w)
    assert len(common) >= 0.99 * max(len(g), len(w))
    assert max(abs(g[k][0] - w[k][0]) + abs(g[k][1] - w[k][1]) for k in common) <= 1e-4


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ptv_matches_jax(guided, masked):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), density=0.01, seed=12)
    cfg = (JaxPIVConfig(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
                        **PALLAS_OFF) if guided else None)
    mask = None
    if masked:
        mask = np.zeros(SHAPE, bool)
        mask[:, :40] = True
    jm = JaxPTV(SHAPE, piv_config=cfg, max_particles=1024, frame_mask=mask)
    pm = from_jax_model(jm)
    assert pm.search_radius == jm.search_radius
    if guided:
        _same_engine_state(pm, jm)
    want, got = jm(fa, fb), pm(fa, fb)
    _same_tracks(got, want)
    assert len(got.x) > 0.7 * got.n_a
    assert abs(np.median(got.u) - 3.3) < 0.05 and abs(np.median(got.v) + 2.1) < 0.05
    if masked:
        assert (got.x >= 39.5).all()


def test_ptv_temporal_predictor_matches_jax():
    """A sequential series: the previous pair's tracks predict this one."""
    f0, f1 = particle_pair(SHAPE, (1.5, 0.8), density=0.008, seed=14)
    _, f2 = particle_pair(SHAPE, (4.3, 1.6), density=0.008, seed=14)
    jm = JaxPTV(SHAPE, max_particles=1024, search_radius=2.5)
    pm = from_jax_model(jm)
    prev_j, prev_p = jm(f0, f1), pm(f0, f1)
    _same_tracks(prev_p, prev_j)
    got = pm(f1, f2, prev=prev_p)
    _same_tracks(got, jm(f1, f2, prev=prev_j))
    # (2.8, 0.8) px is beyond the 2.5 px radius: only the predictor links
    assert len(got.x) > 0.5 * got.n_a and abs(np.median(got.u) - 2.8) < 0.05


def _ptv_results(seed):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, 100, 40), rng.uniform(0, 100, 40)
    out = []
    for p in range(4):
        x = x0 + 1.5 * p + 0.01 * rng.standard_normal(40)
        y = y0 - 0.5 * p + 0.01 * rng.standard_normal(40)
        keep = rng.random(40) > 0.1
        n = int(keep.sum())
        out.append(ptv.PTVResult(x=x[keep], y=y[keep], u=np.full(n, 1.5), v=np.full(n, -0.5),
                                 residual=np.zeros(n), n_a=40, n_b=40))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tracking_copies_equal_originals(seed):
    rng = np.random.default_rng(seed)
    xa, ya = rng.uniform(0, 50, 60), rng.uniform(0, 50, 60)
    xb, yb = xa + rng.normal(1.0, 0.3, 60), ya + rng.normal(0, 0.3, 60)
    for pu in (None, np.full(60, 1.0)):
        for g, w in zip(ptv.match_particles(xa, ya, xb, yb, pu, pu, radius=2.0),
                        jax_ptv.match_particles(xa, ya, xb, yb, pu, pu, radius=2.0)):
            np.testing.assert_array_equal(g, w)
    res = _ptv_results(seed)
    got = ptv.link_trajectories(res, radius=1.0, min_length=3)
    want = jax_ptv.link_trajectories(res, radius=1.0, min_length=3,
                                     pair_indices=None)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in ("frames", "x", "y"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        for a, b in zip(g.kinematics(0.5), w.kinematics(0.5)):
            np.testing.assert_array_equal(a, b)
    gapped = ptv.link_trajectories(res, pair_indices=[0, 1, 3, 4], min_length=2)
    assert len(gapped) == len(jax_ptv.link_trajectories(res, pair_indices=[0, 1, 3, 4],
                                                        min_length=2))
    for g, w in zip(ptv.bin_to_grid(xa, ya, xb - xa, yb - ya, (64, 64), 16, 8, 2),
                    jax_ptv.bin_to_grid(xa, ya, xb - xa, yb - ya, (64, 64), 16, 8, 2)):
        np.testing.assert_array_equal(g, w)


# ----- state and devices ---------------------------------------------------

def test_from_jax_model_refuses_other_objects():
    with pytest.raises(TypeError, match="no counterpart"):
        from_jax_model(object())


NEW_ENTRY_POINTS = {
    "EnsemblePIV": lambda: models.EnsemblePIV(PIVConfig(frame_shape=SHAPE, multipass=1)),
    "MultiDtPIV": lambda: models.MultiDtPIV(PIVConfig(frame_shape=SHAPE)),
    "FolkiPIV": lambda: models.FolkiPIV(SHAPE),
    "FolkiPIV hybrid": lambda: models.FolkiPIV(SHAPE, 32, 16, piv_config=PIVConfig(
        frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2)),
    "PTV": lambda: models.PTV(SHAPE),
    "snr_map": lambda: _quality().snr_map(*particle_pair(SHAPE, (1, 1)), 32, 16),
    "peak_width_map": lambda: _quality().peak_width_map(*particle_pair(SHAPE, (1, 1)), 32, 16),
    "uncertainty_map": lambda: _quality().uncertainty_map(*particle_pair(SHAPE, (1, 1)), 32, 16),
}


def _quality():
    from torchpiv_tpu_torch.stats import quality

    return quality


@pytest.mark.parametrize("entry", sorted(NEW_ENTRY_POINTS))
def test_new_entry_points_need_the_card_by_default(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NEW_ENTRY_POINTS[entry]()
