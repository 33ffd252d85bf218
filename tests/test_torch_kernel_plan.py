"""K6's launch planner (``alevin_fry_tpu_torch/ops/em.py::launch_plan``),
which runs on the host: every cell lands in exactly one route, each
launch's shared bytes stay within the limit it was given, a bootstrap
tile's states fit beside the layout, and a cell one byte over a
threshold moves to the next route.  The kernel traps if a block's layout overruns
the shared bytes it was launched with; these tests hold the planner to
the same byte counts.  Imports no JAX."""

import numpy as np
import pytest

from alevin_fry_tpu_torch.ops import em
from em_cases import BOOT_CASES, EM_CASES, boot_case, em_case, usa_offsets

H100_LIMIT = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100


def _sizes(plan):
    return (np.diff(plan.cell_cls), np.diff(plan.lab_off[plan.cell_cls]), np.diff(plan.dict_off))


def _random_sizes(seed, n=3000):
    """Cell sizes from a few ids to past every route's threshold."""
    rng = np.random.RandomState(seed)
    nu = (10 ** rng.uniform(0, 5.2, n)).astype(np.int64)
    ne = (nu * rng.uniform(0.2, 2.0, n)).astype(np.int64)
    nl = ne + (ne * rng.uniform(0, 3, n)).astype(np.int64)
    ne[:5], nl[:5], nu[:5] = 0, 0, 0  # cells with no class
    return ne, nl, nu


def _route_of(ne, nl, nu, usa, weighted, limit):
    staged, shared = em.cell_bytes(ne, nl, nu, usa, weighted, 1)
    return np.where(staged <= limit, 0, np.where(shared <= limit, 1, 2))


def _check_plan(ne, nl, nu, n_rep, usa, weighted, limit):
    launches, scratch_off, n_scratch = em.launch_plan(ne, nl, nu, n_rep, usa, weighted, limit)
    cells = np.concatenate([ln.cells for ln in launches])
    assert np.array_equal(np.sort(cells), np.arange(len(ne)))  # each cell exactly once
    want = _route_of(ne, nl, nu, usa, weighted, limit)
    slices = []
    for ln in launches:
        assert (want[ln.cells] == ln.route).all()
        assert ln.threads % 32 == 0 and 64 <= ln.threads <= em.MAX_THREADS
        assert 1 <= ln.tile <= min(n_rep, em.MAX_TILE)
        c = ln.cells
        if ln.route == 0:
            need = em.cell_bytes(ne[c], nl[c], nu[c], usa, weighted, ln.tile)[0]
            assert ln.smem <= limit and (need <= ln.smem).all()
            # the tile is the most replicates that fit, evened out over the blocks
            tiles = -(-n_rep // ln.tile)
            assert -(-n_rep // tiles) == ln.tile
            if tiles > 1:
                more = -(-n_rep // (tiles - 1))
                assert more > em.MAX_TILE or (
                    em.cell_bytes(ne[c], nl[c], nu[c], usa, weighted, more)[0] > limit).all()
            assert (scratch_off[c] == -1).all()
        elif ln.route == 1:
            assert ln.tile == 1 and ln.smem <= limit
            assert (em.cell_bytes(ne[c], nl[c], nu[c], usa, weighted)[1] <= ln.smem).all()
            assert (scratch_off[c] == -1).all()
        else:
            assert ln.tile == 1 and ln.smem == em.HEADER
            words = (em.cell_bytes(ne[c], nl[c], nu[c], usa, weighted)[1] - em.HEADER) // 4
            slices += list(zip(scratch_off[c].tolist(), words.tolist()))
    # the global cells' slices, 16-byte aligned, tile one replicate's scratch
    slices.sort()
    ends = np.cumsum([0] + [w for _, w in slices])
    assert [off for off, _ in slices] == ends[:-1].tolist() and ends[-1] == n_scratch
    assert all(off % 4 == 0 for off, _ in slices)
    return launches


@pytest.mark.parametrize("usa,weighted,n_rep", [
    (False, False, 1), (True, False, 1), (False, True, 1), (False, False, 20), (False, False, 33)])
def test_every_cell_takes_one_route_within_the_limit(usa, weighted, n_rep):
    ne, nl, nu = _random_sizes(n_rep + 7 * usa + 3 * weighted)
    launches = _check_plan(ne, nl, nu, n_rep, usa, weighted, H100_LIMIT)
    assert {ln.route for ln in launches} == {0, 1, 2}
    if n_rep > 1:
        assert max(ln.tile for ln in launches) > 1


@pytest.mark.parametrize("limit", [48 * 1024, 100_000, H100_LIMIT])
def test_launch_groups_respect_a_smaller_limit(limit):
    ne, nl, nu = _random_sizes(5)
    for ln in _check_plan(ne, nl, nu, 20, False, False, limit):
        assert ln.smem <= limit


@pytest.mark.parametrize("usa,weighted,n_rep", [
    (False, False, 1), (True, False, 1), (False, True, 1), (False, False, 2)])
def test_one_byte_over_a_threshold_moves_a_cell_on(usa, weighted, n_rep):
    """A cell of 2,000 classes, 40,000 labels and 2,000 ids: at its route
    (a) bytes it is staged (a tile of one replicate), one byte less sends
    it to route (b); at its route (b) bytes it is shared, one byte less
    sends it to route (c)."""
    ne, nl, nu = np.array([2000]), np.array([40_000]), np.array([2000])
    staged, shared = (int(x[0]) for x in em.cell_bytes(ne, nl, nu, usa, weighted))
    assert staged > shared
    for limit, route in ((staged, 0), (staged - 1, 1), (shared, 1), (shared - 1, 2)):
        (ln,), _, _ = em.launch_plan(ne, nl, nu, n_rep, usa, weighted, limit)
        assert ln.route == route and ln.tile == 1


def test_one_byte_under_a_tile_drops_a_replicate():
    """At the bytes of a tile of t replicates a cell runs t a block; one
    byte less, t - 1 (evened out over the blocks of 32 replicates)."""
    ne, nl, nu = np.array([300]), np.array([900]), np.array([500])
    for t in (2, 5, 8, 16, 32):
        need = int(em.cell_bytes(ne, nl, nu, False, False, t)[0][0])
        (ln,), _, _ = em.launch_plan(ne, nl, nu, 32, False, False, need)
        assert ln.route == 0 and ln.tile == t and ln.smem == need
        (ln,), _, _ = em.launch_plan(ne, nl, nu, 32, False, False, need - 1)
        assert ln.route == 0 and ln.tile == -(-32 // -(-32 // (t - 1)))
    (ln,), _, _ = em.launch_plan(ne, nl, nu, 20, False, False, H100_LIMIT)
    assert ln.tile == 20  # the whole of a cell's replicates on one block


@pytest.mark.parametrize("kind", list(EM_CASES))
@pytest.mark.parametrize("usa", [False, True])
def test_em_cases_routes(kind, usa):
    """The card tests' batches take the routes they are named for:
    global-route has a route (c) cell, shared-route a route (b) cell and
    no route (c) one; every other cell is staged."""
    batch, n_rows = em_case(kind)
    plan = em.plan_cells(*batch, n_rows, usa_offsets(n_rows) if usa else None, False, True)
    routes = {ln.route for ln in _check_plan(*_sizes(plan), 1, usa, False, H100_LIMIT)}
    assert routes == {0, {"global-route": 2, "shared-route": 1}.get(kind, 0)}


@pytest.mark.parametrize("kind", list(BOOT_CASES))
def test_boot_cases_routes(kind):
    """The bootstrap cases: 33 replicates run in tiles of 17 on route (a);
    shared-route's large cell takes route (b), global-route's two take (c)."""
    batch, n_rows = boot_case(kind)
    ceo, lo, labels, counts = batch
    plan = em.plan_cells(ceo, lo, labels, counts, n_rows, None, False, True)
    launches = _check_plan(*_sizes(plan), 33, False, False, H100_LIMIT)
    assert {ln.tile for ln in launches if ln.route == 0} == {17}
    routes = sorted(ln.route for ln in launches for _ in ln.cells)
    assert routes.count(1) == (kind == "shared-route")
    assert routes.count(2) == 2 * (kind == "global-route")


def test_block_threads_fill_the_sm():
    """A block's threads, a power of two from 64 to 512, give each thread
    about four of its items and, with the blocks its shared bytes let an
    SM hold, fill more than half of the SM's 2,048 threads."""
    rng = np.random.RandomState(3)
    items = (10 ** rng.uniform(0, 5, 500)).astype(np.int64)
    smem = rng.randint(em.HEADER, H100_LIMIT + 1, 500)
    threads = em.block_threads(items, smem, H100_LIMIT)
    assert ((threads & (threads - 1)) == 0).all()
    assert ((threads >= 64) & (threads <= em.MAX_THREADS)).all()
    per_sm = np.minimum((H100_LIMIT + em.SM_BLOCK_RESERVE) // (smem + em.SM_BLOCK_RESERVE), 32)
    assert ((2 * threads * per_sm > em.SM_THREADS) | (threads == em.MAX_THREADS)).all()
    assert ((threads >= np.minimum(items // 4, em.MAX_THREADS)) | (threads >= items)).all()
    assert (em.block_threads(np.array([10, 300]), np.array([500, 500]), H100_LIMIT)
            == [64, 128]).all()
