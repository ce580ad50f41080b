"""The row-block CSR kernel (``spmv_tpu.csr_kernel``) in Pallas's
interpreter, its plain-XLA reference, and the block-shape rule.  The
compiled kernel is checked on the GPU by ``tests/test_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu import synth
from spmv_tpu.csr_kernel import (RAGGED, REGULAR, block_shape, csr_product,
                                 reference, rowblock)
from spmv_tpu.device import csr, split_x2
from spmv_tpu.oracle import EPSILON, fp32_check, golden_spmv

MATRICES = {
    "power_law": lambda: synth.power_law(n=700, avg_nnz_per_row=9,
                                         bandwidth=150, seed=2),
    "band": lambda: synth.synthetic_cant(n=500, avg_nnz_per_row=16,
                                         bandwidth=40, seed=3),
    **{e: (lambda e=e: synth.edge_case(e))
       for e in ("empty_rows", "single_row", "ragged", "rectangular",
                 "one_element")},
}


def _arrays(info, r, c, v):
    order = np.lexsort((c, r))
    d = csr(np.asarray(r)[order], np.asarray(c)[order],
            np.asarray(v)[order], info.nrows)
    return d.ptr, d.cols, d.vals


@pytest.mark.parametrize("block", [REGULAR, RAGGED, (16, 16, 4)],
                         ids=lambda b: "%dx%dw%d" % b)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_rowblock_matches_oracle(name, block):
    info, r, c, v = MATRICES[name]()
    ptr, cols, vals = _arrays(info, r, c, v)
    x = np.random.default_rng(0).standard_normal(info.ncols).astype(
        np.float32)
    y = rowblock(ptr, cols, vals, None, jnp.asarray(x), block=block,
                 interpret=True)
    assert y.shape == (info.nrows,) and y.dtype == jnp.float32
    assert fp32_check(info.nrows, r, c, v, x, np.asarray(y)).ok


@pytest.mark.parametrize("R,block_r", [(1, 8), (2, 8), (9, 8), (33, 16),
                                       (5, 4)])
def test_rowblock_block_of_rhs(R, block_r):
    """X (ncols, R): a second grid axis over column blocks of X, masked
    where R is not a multiple of the block."""
    info, r, c, v = MATRICES["power_law"]()
    ptr, cols, vals = _arrays(info, r, c, v)
    X = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(
        np.float32)
    Y = rowblock(ptr, cols, vals, None, jnp.asarray(X), block=RAGGED,
                 block_r=block_r, interpret=True)
    assert Y.shape == (info.nrows, R)
    assert fp32_check(info.nrows, r, c, v, X, np.asarray(Y)).ok


@pytest.mark.parametrize("block", [REGULAR, RAGGED],
                         ids=lambda b: "%dx%dw%d" % b)
def test_rowblock_fp64_planes(block):
    """fp64 x with (hi, lo) value planes: an fp64 sum within EPSILON."""
    info, r, c, v = MATRICES["power_law"]()
    v = np.asarray(v) * (1 + 1e-9 * np.arange(v.size))
    order = np.lexsort((c, r))
    hi, lo = split_x2(v[order])
    ptr, cols, _ = _arrays(info, r, c, v)
    x = np.random.default_rng(1).standard_normal(info.ncols)
    with jax.enable_x64(True):
        y = rowblock(ptr, cols, jnp.asarray(hi), jnp.asarray(lo),
                     jnp.asarray(x), block=block, interpret=True)
        assert y.dtype == jnp.float64
    assert np.abs(np.asarray(y) - golden_spmv(info.nrows, r, c, v, x)).max() \
        < EPSILON


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_reference_matches_oracle(name):
    info, r, c, v = MATRICES[name]()
    ptr, cols, vals = _arrays(info, r, c, v)
    x = np.random.default_rng(4).standard_normal(info.ncols).astype(
        np.float32)
    y = reference(ptr, cols, vals, None, jnp.asarray(x))
    assert fp32_check(info.nrows, r, c, v, x, np.asarray(y)).ok


def test_reference_drops_slots_past_the_last_row():
    """Stacked shards pad their slot arrays past ptr[-1]; those slots
    belong to no row."""
    ptr = jnp.asarray([0, 1, 2], jnp.int32)
    cols = jnp.asarray([0, 1, 0, 1], jnp.int32)
    vals = jnp.asarray([2.0, 3.0, 100.0, 100.0], jnp.float32)
    x = jnp.asarray([1.0, 1.0])
    for y in (reference(ptr, cols, vals, None, x),
              rowblock(ptr, cols, vals, None, x, interpret=True)):
        np.testing.assert_array_equal(np.asarray(y), [2.0, 3.0])


def test_csr_product_lowers_to_the_reference_off_gpu():
    """On the CPU the product is plain XLA: no Pallas kernel is lowered."""
    info, r, c, v = MATRICES["band"]()
    ptr, cols, vals = _arrays(info, r, c, v)
    x = jnp.ones(info.ncols, jnp.float32)
    hlo = jax.jit(lambda *a: csr_product(*a, None, x)).lower(
        ptr, cols, vals).as_text()
    assert "csr_rowblock" not in hlo and "custom_call" not in hlo
    assert "scatter" in hlo


@pytest.mark.parametrize("lengths,expected", [
    (np.full(1000, 16), REGULAR),
    (np.full(1000, 30), REGULAR),
    (np.r_[np.full(999, 4), 600], RAGGED),
    (np.tile([1, 40], 500), RAGGED),
], ids=["uniform16", "uniform30", "one-hub", "alternating"])
def test_block_shape_rule(lengths, expected):
    """64-row programs unless they would walk more than twice the
    nonzeros (ragged rows), then 8-row programs."""
    assert block_shape(lengths) == expected


@pytest.mark.parametrize("name,expected", [("band", REGULAR),
                                           ("power_law", RAGGED)])
def test_block_shape_of_the_test_matrices(name, expected):
    info, r, _, _ = MATRICES[name]()
    assert block_shape(np.bincount(r, minlength=info.nrows)) == expected


def test_block_shape_of_an_empty_matrix():
    assert block_shape(np.zeros(0, np.int64)) == REGULAR
    assert block_shape(np.zeros(10, np.int64)) == REGULAR


@pytest.mark.parametrize("shape,block,kernel", [
    ((40,), REGULAR, True), ((40,), RAGGED, True),
    ((40, 3), REGULAR, True), ((40, 3), RAGGED, False)])
def test_csr_product_choice(shape, block, kernel):
    """The kernel is traced for the GPU branch unless x is a block and the
    rows are ragged; then only the reference is."""
    ptr = jnp.asarray(np.arange(0, 81, 2), jnp.int32)
    cols = jnp.asarray(np.arange(80) % 40, jnp.int32)
    vals = jnp.ones(80, jnp.float32)
    x = jnp.ones(shape, jnp.float32)
    jaxpr = str(jax.make_jaxpr(
        lambda *a: csr_product(*a, block=block))(ptr, cols, vals, None, x))
    assert ("pallas_call" in jaxpr) == kernel


@pytest.mark.parametrize("shape,hint", [((40,), False), ((40, 4), False),
                                        ((40, 15), False), ((40, 16), True),
                                        ((40, 100), True)])
def test_reference_sorted_hint(shape, hint):
    """The reference tells segment_sum its rows are sorted only for X with
    SORTED_FROM_R columns or more."""
    ptr = jnp.asarray(np.arange(0, 81, 2), jnp.int32)
    cols = jnp.asarray(np.arange(80) % 40, jnp.int32)
    vals = jnp.ones(80, jnp.float32)
    x = jnp.ones(shape, jnp.float32)
    hlo = jax.jit(reference).lower(ptr, cols, vals, None, x).as_text()
    assert ("indices_are_sorted = true" in hlo) == hint
    np.testing.assert_array_equal(np.asarray(reference(ptr, cols, vals, None,
                                                       x)),
                                  np.full((40,) + shape[1:], 2.0))
