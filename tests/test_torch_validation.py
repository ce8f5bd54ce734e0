"""The port's vector-field validation (``ops/validation.py``) against the JAX
package's on the same numpy inputs: neighbour stacks and the NaN-aware
median (exact), the median and normalized-median tests, the acceptance test
of secondary-peak substitution, velocity limits and the global sigma test
(masks equal).  The port's functions take a leading pair axis and keep every
statistic per pair; the JAX functions see one field, so each pair of a batch
is held to the JAX result on that pair alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.ops import validation as jval
from torchpiv_tpu_torch.ops import validation as tval

SHAPES = [(12, 15), (5, 7), (3, 3), (1, 6)]


def _fields(seed, shape, batch=3, outliers=0.08, holes=0.1):
    """Smooth fields with a few outliers per pair, and an invalid mask that
    differs between the pairs of the batch."""
    rng = np.random.default_rng(seed)
    R, C = shape
    yy, xx = np.mgrid[:R, :C]
    u = np.stack([2.0 + 0.05 * (b + 1) * xx + rng.normal(0, 0.05, shape)
                  for b in range(batch)]).astype(np.float32)
    v = np.stack([-1.0 + 0.03 * (b + 1) * yy + rng.normal(0, 0.05, shape)
                  for b in range(batch)]).astype(np.float32)
    bad = rng.uniform(size=u.shape) < outliers
    u[bad] += rng.choice([-6.0, 7.0], bad.sum()).astype(np.float32)
    v[bad] -= rng.choice([-5.0, 4.0], bad.sum()).astype(np.float32)
    inval = rng.uniform(size=u.shape) < holes
    return u, v, inval


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ring", [1, 2])
def test_neighbour_stacks_exact(shape, ring):
    u, _, inval = _fields(0, shape)
    u[inval] = np.nan
    tfn, jfn = ((tval._neighbors, jval._neighbors) if ring == 1 else
                (tval._neighbors_ring2, jval._neighbors_ring2))
    got = tfn(torch.from_numpy(u)).numpy()
    assert got.shape == (8 * ring, *u.shape)
    for b in range(u.shape[0]):
        np.testing.assert_array_equal(got[:, b], np.asarray(jfn(jnp.asarray(u[b]))))
    # a single field takes the same path
    np.testing.assert_array_equal(tfn(torch.from_numpy(u[0])).numpy(), got[:, 0])


@pytest.mark.parametrize("members", [8, 16])
@pytest.mark.parametrize("nan_share", [0.0, 0.3, 0.9])
def test_nanmedian_averages_the_middle_pair(members, nan_share):
    rng = np.random.default_rng(members)
    stack = rng.normal(size=(members, 2, 6, 9)).astype(np.float32)
    stack[rng.uniform(size=stack.shape) < nan_share] = np.nan
    stack[:, 0, 0, 0] = np.nan  # no valid member: 0
    stack[1:, 0, 0, 1] = np.nan  # one valid member: itself
    stack[0, 0, 0, 1] = 1.25
    got = tval._nanmedian8(torch.from_numpy(stack)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jval._nanmedian8(jnp.asarray(stack[:, b]))))
    assert got[0, 0, 0] == 0.0 and got[0, 0, 1] == stack[0, 0, 0, 1]
    if nan_share == 0.0:
        # the mean of the two middle values, not torch.median's lower one
        np.testing.assert_allclose(got[1], np.median(stack[:, 1], axis=0),
                                   rtol=0, atol=1e-6)
        lower = torch.from_numpy(stack[:, 1]).median(dim=0).values.numpy()
        assert not np.array_equal(got[1], lower)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", [0.5, 2.0])
@pytest.mark.parametrize("test", ["median_test", "normalized_median_test"])
def test_median_tests_match_jax(test, threshold, shape):
    u, v, _ = _fields(1, shape)
    got = getattr(tval, test)(torch.from_numpy(u), torch.from_numpy(v), threshold).numpy()
    assert got.dtype == bool and got.shape == u.shape
    for b in range(u.shape[0]):
        want = np.asarray(getattr(jval, test)(jnp.asarray(u[b]), jnp.asarray(v[b]),
                                              threshold))
        np.testing.assert_array_equal(got[b], want)
    if shape == SHAPES[0]:
        assert got.any() and not got.all()


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("mode", ["median", "normmedian"])
def test_apply_median_filter_matches_jax(mode, with_mask):
    u, v, inval = _fields(2, (12, 15))
    got = tval.apply_median_filter(
        torch.from_numpy(u), torch.from_numpy(v),
        torch.from_numpy(inval) if with_mask else None, mode, 1.5).numpy()
    for b in range(u.shape[0]):
        want = np.asarray(jval.apply_median_filter(
            jnp.asarray(u[b]), jnp.asarray(v[b]),
            jnp.asarray(inval[b]) if with_mask else None, mode, 1.5))
        np.testing.assert_array_equal(got[b], want)
    if with_mask:
        assert (got | ~inval).all()  # what was invalid stays invalid


def test_apply_median_filter_rejects_unknown_mode():
    z = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="median_filter"):
        tval.apply_median_filter(z, z, None, "mean")


@pytest.mark.parametrize("shape", [(12, 15), (7, 7), (4, 9)])
@pytest.mark.parametrize("options", [{}, dict(threshold=1.0), dict(min_neighbors=3),
                                     dict(eps=0.5, threshold=4.0)])
def test_second_peak_acceptance_matches_jax(options, shape):
    u, v, inval = _fields(3, shape, holes=0.15)
    rng = np.random.default_rng(4)
    # candidates: near the truth at some sites, far at others
    cu = (u + rng.normal(0, 0.05, u.shape) + (rng.uniform(size=u.shape) < 0.4) * 5).astype(np.float32)
    cv = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    got = tval.second_peak_acceptance(
        *(torch.from_numpy(a) for a in (u, v, inval, cu, cv)), **options).numpy()
    for b in range(u.shape[0]):
        want = np.asarray(jval.second_peak_acceptance(
            *(jnp.asarray(a[b]) for a in (u, v, inval, cu, cv)), **options))
        np.testing.assert_array_equal(got[b], want)
    assert not (got & ~inval).any()  # a subset of the invalid sites
    if shape == (12, 15) and not options:
        assert got.any()


@pytest.mark.parametrize("u_limits,v_limits", [
    ((1.0, 3.0), None), (None, (-2.0, 0.5)), ((1.5, 2.5), (-1.5, 0.0)), (None, None)])
def test_velocity_limits_match_jax(u_limits, v_limits):
    u, v, _ = _fields(5, (12, 15))
    got = tval.velocity_limits_test(torch.from_numpy(u), torch.from_numpy(v),
                                    u_limits, v_limits).numpy()
    for b in range(u.shape[0]):
        np.testing.assert_array_equal(got[b], np.asarray(jval.velocity_limits_test(
            jnp.asarray(u[b]), jnp.asarray(v[b]), u_limits, v_limits)))
    assert got.any() == (u_limits is not None or v_limits is not None)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("k", [1.5, 3.0])
def test_global_std_is_per_pair_and_matches_jax(k, with_mask):
    u, v, inval = _fields(6, (12, 15), batch=4)
    u[2] += 40.0  # a pair far from the others: batch statistics would flag it whole
    mask = torch.from_numpy(inval) if with_mask else None
    got = tval.global_std_test(torch.from_numpy(u), torch.from_numpy(v), k, mask).numpy()
    for b in range(u.shape[0]):
        want = np.asarray(jval.global_std_test(
            jnp.asarray(u[b]), jnp.asarray(v[b]), k,
            jnp.asarray(inval[b]) if with_mask else None))
        assert np.mean(got[b] != want) == 0.0
    assert not got[2].all()
    one = tval.global_std_test(torch.from_numpy(u[1]), torch.from_numpy(v[1]), k,
                               None if mask is None else mask[1]).numpy()
    np.testing.assert_array_equal(one, got[1])


def test_global_std_with_everything_invalid_flags_nothing_new():
    u, v, _ = _fields(7, (6, 6), batch=1)
    inval = np.ones(u.shape, bool)
    got = tval.global_std_test(torch.from_numpy(u), torch.from_numpy(v), 3.0,
                               torch.from_numpy(inval)).numpy()
    want = np.asarray(jval.global_std_test(jnp.asarray(u[0]), jnp.asarray(v[0]), 3.0,
                                           jnp.asarray(inval[0])))
    np.testing.assert_array_equal(got[0], want)
