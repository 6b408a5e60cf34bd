"""The port's collectives on 8 gloo ranks, against numpy.

One spawn of 8 ranks per module (``_torch_ranks.run_ranks``, ``file://``
rendezvous, 60 s join timeout) runs every collective on both axes of the
(data 4, pod 2) mesh; the tests read its results.  Rank ``r`` sits at
``(data, pod) = divmod(r, 2)``, as in the reference's
``Mesh(devices.reshape(4, 2), ("data", "pod"))``, and device ``i`` of an
axis owns chunk ``i`` of the padded payload.

Tolerances: with integer-valued f32 inputs every sum is exact in any order,
so reduce-scatter and all-gather are held bit for bit; with normal inputs
the sums are taken in another order than numpy's, within rtol 1e-6.
"""

import numpy as np
import pytest

from _torch_ranks import MESH_SHAPE, collectives_body, rank_input, run_ranks

WORLD = 8
SIZES = (1, 37, 513)
RS = ("rs_ring", "rs_a2a")
AG = ("ag_ring", "ag_a2a")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_ranks(collectives_body, WORLD, tmp_path_factory.mktemp("collectives"), SIZES)


def _line(rank: int, axis: str) -> tuple[list[int], int]:
    """The global ranks of ``rank``'s line along ``axis`` and its index there."""
    d, p = divmod(rank, MESH_SHAPE["pod"])
    if axis == "data":
        return [i * MESH_SHAPE["pod"] + p for i in range(MESH_SHAPE["data"])], d
    return [d * MESH_SHAPE["pod"] + i for i in range(MESH_SHAPE["pod"])], p


def _padded_sum(line, n, kind):
    s = len(line)
    total = sum(np.pad(rank_input(r, n, kind), (0, (-n) % s)).astype(np.float64)
                for r in line)
    return total.astype(np.float32), s


def _check(got, want, kind):
    assert got.shape == want.shape and got.dtype == np.float32
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mesh_coordinates(results):
    assert [r["coords"] for r in results] == [
        {"data": d, "pod": p} for d in range(4) for p in range(2)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ("int", "rand"))
@pytest.mark.parametrize("axis", ("data", "pod"))
@pytest.mark.parametrize("fn", RS)
def test_reduce_scatter_owns_chunk_i(results, n, kind, axis, fn):
    for rank, res in enumerate(results):
        line, idx = _line(rank, axis)
        total, s = _padded_sum(line, n, kind)
        _check(res[n, kind, axis][fn], total.reshape(s, -1)[idx], kind)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ("int", "rand"))
@pytest.mark.parametrize("axis", ("data", "pod"))
@pytest.mark.parametrize("fn", AG)
def test_all_gather_inverts_reduce_scatter(results, n, kind, axis, fn):
    for rank, res in enumerate(results):
        line, _ = _line(rank, axis)
        total, _ = _padded_sum(line, n, kind)
        _check(res[n, kind, axis][fn], total, kind)
        # every rank of the line ends with the same bits
        for peer in line:
            np.testing.assert_array_equal(results[peer][n, kind, axis][fn],
                                          res[n, kind, axis][fn])


@pytest.mark.parametrize("axis", ("data", "pod"))
def test_alltoall_row_i_comes_from_index_i(results, axis):
    for rank, res in enumerate(results):
        line, idx = _line(rank, axis)
        want = np.array([[float(src), float(idx)] for src in line], np.float32)
        np.testing.assert_array_equal(res["a2a", axis], want)
