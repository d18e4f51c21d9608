"""The port's table gradient (armnet_tpu_torch.kernels.scatter_cuda) against
the JAX package's Pallas kernel `_table_grad_tpu_v4` in interpret mode, on
the cases of tests/test_scatter_pallas.py (drawn with that file's
jax.random keys and handed to both sides as numpy arrays), and the embedding
gather's autograd backward against the JAX custom VJP. The Pallas kernel
carries ~1e-5 relative error (its bf16 hi/lo split), so it is held at rtol
1e-5, atol 2e-5, the JAX file's own tolerance; the exact scatter-add
(.at[].add) at 1e-6. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.scatter_pallas import (BUCKET, CHUNK,
                                               _sorted_prep,
                                               _table_grad_tpu_v4,
                                               _wrap_negative_ids,
                                               table_grad_reference)
from armnet_tpu.ops.embedding import scaled_embedding_lookup
from armnet_tpu_torch.kernels import bench, scatter_cuda
from armnet_tpu_torch.ops.embedding import embedding_bag, table_grad
from armnet_tpu_torch.utils import tracing

RTOL, ATOL = 1e-5, 2e-5


def _case(n, e, nrows, seed, lo=0, hi=None):
    """(g [n, e] f32, ids [n] int32) as tests/test_scatter_pallas.py draws
    them from jax.random.key(seed)."""
    k = jax.random.split(jax.random.key(seed), 2)
    ids = jax.random.randint(k[0], (n,), lo, nrows if hi is None else hi,
                             dtype=jnp.int32)
    g = jax.random.normal(k[1], (n, e), jnp.float32)
    return np.array(g), np.array(ids)


def _check(g, ids, nrows):
    """Port plain version vs the Pallas kernel (interpret) on wrapped ids,
    and vs .at[].add on the raw ids."""
    got = scatter_cuda.table_grad_plain(torch.from_numpy(g),
                                        torch.from_numpy(ids), nrows).numpy()
    jg, jids = jnp.asarray(g), jnp.asarray(ids)
    kernel = _table_grad_tpu_v4(jg, _wrap_negative_ids(jids, nrows), nrows,
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(table_grad_reference(jg, jids, nrows)), rtol=1e-6,
        atol=1e-6)
    return got


def test_random_duplicates():
    _check(*_case(5000, 10, 6000, seed=0), 6000)


def test_all_same_id():
    g = np.ones((3000, 6), np.float32)
    got = _check(g, np.full((3000,), 1234, np.int32), 4096)
    assert got[1234, 0] == 3000.0 and np.count_nonzero(got) == 6


def test_small_n_and_ragged_rows():
    _check(*_case(37, 4, 3001, seed=1), 3001)


def test_boundary_ids():
    nrows = 3 * BUCKET
    ids = np.asarray([0, BUCKET - 1, BUCKET, 2 * BUCKET - 1, nrows - 1, 0],
                     np.int32)
    g = np.arange(6 * 5, dtype=np.float32).reshape(6, 5)
    _check(g, ids, nrows)


@pytest.mark.parametrize("n,e,nrows", [
    (900, 10, 5003),       # duplicates + ragged rows
    (500, 1, 16999),       # e=1
    (800, 16, 9000),       # e divides 128 exactly
])
def test_shape_coverage(n, e, nrows):
    _check(*_case(n, e, nrows, seed=7), nrows)


def test_multichunk_bucket():
    """Far more than CHUNK updates in one of the Pallas kernel's buckets."""
    _check(*_case(4 * CHUNK + 57, 6, 8192, seed=7, hi=100), 8192)


def test_negative_ids_wrap():
    nrows = 2048
    _check(*_case(300, 6, nrows, seed=11, lo=-nrows), nrows)


def test_out_of_range_ids_are_dropped():
    """Ids outside [-nrows, nrows) add nothing, as .at[].add drops them
    (their forward rows were NaN)."""
    nrows = 700
    g, ids = _case(400, 4, nrows, seed=12, lo=-nrows)
    ids[:5] = [nrows, nrows + 3, -nrows - 1, -5 * nrows, 2 ** 31 - 1]
    got = _check(g, ids, nrows)
    keep = _check(g[5:], ids[5:], nrows)
    np.testing.assert_array_equal(got, keep)


def test_sort_keys_drop_and_wrap():
    keys, order = scatter_cuda.sort_ids_plain(
        torch.tensor([3, -1, 10, -11, 3, 0]), 10)
    assert keys.dtype == torch.int32 and order.dtype == torch.int32
    assert keys.tolist() == [0, 3, 3, 9, 10, 10]
    assert order.tolist() == [5, 0, 4, 1, 2, 3]        # stable
    with pytest.raises(ValueError, match="nrows"):
        scatter_cuda.sort_ids_plain(torch.tensor([0]), 0)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_cuda.sort_ids(torch.tensor([0]), 10)


def _ids_with_every_kind(nrows, seed):
    """int32 ids in [-2 nrows, 2 nrows): wrapped, dropped and duplicated."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(-2 * nrows, 2 * nrows, 700).astype(np.int32)
    ids[:200] = rng.randint(-nrows, nrows, 200)
    ids[200:260] = 5                                   # duplicates
    ids[260:270] = [nrows, -nrows - 1, -nrows, nrows - 1, -1, 0,
                    2 ** 31 - 1, -2 ** 31, 3 * nrows, 5]
    return ids


@pytest.mark.parametrize("nrows", [7, 2048, 3001])
def test_key_prep_matches_jax_prep(nrows):
    """keys_plain against the JAX package's `_wrap_negative_ids`: the same
    key for every id it keeps, and nrows for every id that JAX's kernel
    leaves outside [0, nrows) (which it drops)."""
    ids = _ids_with_every_kind(nrows, seed=nrows)
    keys = scatter_cuda.keys_plain(torch.from_numpy(ids), nrows).numpy()
    jw = np.asarray(_wrap_negative_ids(jnp.asarray(ids), nrows))
    want = np.where((jw >= 0) & (jw < nrows), jw, nrows)
    np.testing.assert_array_equal(keys, want)
    assert keys.dtype == np.int32


@pytest.mark.parametrize("nrows", [7, 2048, 3001])
def test_sorted_prep_matches_jax_sorted_prep(nrows):
    """sort_ids_plain against the JAX package's `_sorted_prep` (lax.sort of
    (ids, iota), num_keys=1) on the same keys: the same sorted keys and the
    same permutation, so equal keys keep their order in both."""
    ids = _ids_with_every_kind(nrows, seed=nrows + 1)
    keys = scatter_cuda.keys_plain(torch.from_numpy(ids), nrows)
    sid, perm = scatter_cuda.sort_ids_plain(torch.from_numpy(ids), nrows)
    order, jsid, _ = _sorted_prep(jnp.asarray(keys.numpy()), nrows, BUCKET)
    np.testing.assert_array_equal(sid.numpy(), np.asarray(jsid))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(order))


def test_cpu_dispatch_takes_plain_version_without_launch():
    before = tracing.counts("armnet.kernel.")
    g, ids = _case(50, 3, 80, seed=13)
    got = table_grad(torch.from_numpy(g), torch.from_numpy(ids), 80)
    assert tracing.counts("armnet.kernel.") == before
    np.testing.assert_array_equal(
        got.numpy(), scatter_cuda.table_grad_plain(
            torch.from_numpy(g), torch.from_numpy(ids), 80).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        scatter_cuda.table_grad(torch.from_numpy(g), torch.from_numpy(ids),
                                80)


@pytest.mark.parametrize("nrows", [200, 600])    # JAX one-hot and flat paths
def test_embedding_bag_grads_match_jax(nrows):
    """dtable and dvalues of the port's autograd Function against jax.grad
    of the JAX lookup, with wrapped and repeated ids."""
    rng = np.random.RandomState(3)
    table = rng.randn(nrows, 8).astype(np.float32)
    ids = rng.randint(-nrows, nrows, (16, 5)).astype(np.int32)
    ids[0, :3] = 7                                      # duplicates
    values = rng.uniform(0.1, 1.0, (16, 5)).astype(np.float32)
    dout = rng.randn(16, 5, 8).astype(np.float32)

    jt = (jnp.asarray(table.reshape(-1)) if nrows > 512
          else jnp.asarray(table))
    gt, gv = jax.grad(
        lambda t, v: jnp.sum(scaled_embedding_lookup(
            t, jnp.asarray(ids), v, nemb=8) * jnp.asarray(dout)),
        argnums=(0, 1))(jt, jnp.asarray(values))

    tt = torch.from_numpy(table).requires_grad_()
    tv = torch.from_numpy(values).requires_grad_()
    (embedding_bag(tt, torch.from_numpy(ids), tv)
     * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(),
                               np.asarray(gt).reshape(nrows, 8), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv), rtol=1e-5,
                               atol=1e-6)


def test_embedding_bag_skips_what_needs_no_grad():
    """values that need no gradient get none; the table still does."""
    table = torch.randn(30, 4, requires_grad=True)
    out = embedding_bag(table, torch.tensor([[1, 2], [2, 29]]),
                        torch.ones(2, 2))
    out.sum().backward()
    assert table.grad[2].tolist() == [2.0] * 4
    assert float(table.grad.sum()) == 16.0


@pytest.mark.parametrize("zipf", [None, 0.99, 1.5])
def test_bench_ids_keep_criteo_geometry(zipf):
    """The timed table-gradient batches (kernels/bench.py): every id inside
    its field's range; with a Zipf exponent s, the hottest id of a field is
    drawn 1 / sum_k k^-s of the time, within 5 standard deviations."""
    nfeat, rows = 20000, 2048
    sizes = bench.field_sizes(nfeat, 39)
    assert sizes.sum() == nfeat and len(sizes) == 39
    ids = bench.criteo_ids(rows, nfeat, 39, np.random.RandomState(0),
                           zipf=zipf)
    lo = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    assert ids.shape == (rows, 39)
    assert ((ids >= lo) & (ids < lo + sizes)).all()
    if zipf is None:
        return
    for f in (0, 20):
        top = np.bincount(ids[:, f]).max() / rows
        p1 = 1.0 / np.sum(np.arange(1, sizes[f] + 1, dtype=np.float64)
                          ** -zipf)
        assert abs(top - p1) <= 5 * np.sqrt(p1 * (1 - p1) / rows)
