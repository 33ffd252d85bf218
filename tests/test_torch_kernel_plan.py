"""K6's and K7's launch planners (``alevin_fry_tpu_torch/ops/em.py::launch_plan``,
``ops/pug_device.py::launch_plan``), which run on the host: every cell
lands in exactly one route, each launch's shared bytes stay within the
limit it was given, a bootstrap tile's states fit beside the layout, and
a cell one byte over a threshold moves to the next route.  The kernels
trap if a block's layout overruns the shared bytes it was launched with;
these tests hold the planners to the same byte counts.  Imports no JAX."""

import numpy as np
import pytest
import torch

from alevin_fry_tpu_torch.ops import em, pug_device
from em_cases import BOOT_CASES, EM_CASES, boot_case, em_case, usa_offsets
from pug_cases import PUG_CASES, pug_case

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


# --- K7 ------------------------------------------------------------------------------

def _graph_sizes(seed, n=3000):
    """Cell node and entry counts from empty cells to past every route's
    threshold."""
    rng = np.random.RandomState(seed)
    nodes = (10 ** rng.uniform(0, 5, n)).astype(np.int64)
    entries = (nodes * rng.uniform(0, 4, n)).astype(np.int64)
    nodes[:5], entries[:5] = 0, 0  # empty cells
    entries[5:10] = 0  # cells without an edge
    return nodes, entries


def _k7_route_of(n, m, limit):
    _slot, staged, shared = pug_device.cell_bytes(n, m)
    warp = ((m <= pug_device.WARP_ENTRIES) & (n <= pug_device.WARP_NODES)
            & (pug_device.WARPS * pug_device.WARP_SLOT <= limit))
    return np.where(n == 0, -1, np.where(warp, 0, np.where(
        staged <= limit, 1, np.where(shared <= limit, 2, 3))))


def _check_k7_plan(n, m, limit):
    launches, node_off, entry_off, scratch_off, n_scratch = pug_device.launch_plan(n, m, limit)
    cells = np.concatenate([ln.cells for ln in launches] + [np.zeros(0, np.int64)])
    assert np.array_equal(np.sort(cells), np.flatnonzero(n > 0))  # each live cell once
    np.testing.assert_array_equal(node_off, np.concatenate(([0], np.cumsum(n))))
    np.testing.assert_array_equal(entry_off, np.concatenate(([0], np.cumsum(m))))
    want = _k7_route_of(n, m, limit)
    slot, staged, shared = pug_device.cell_bytes(n, m)
    slices = []
    for ln in launches:
        c = ln.cells
        assert (want[c] == ln.route).all() and 0 < ln.smem <= limit
        assert ln.route == 0 or (np.diff(n[c]) <= 0).all()  # most nodes first
        if ln.route == 0:
            assert ln.threads == 32 * pug_device.WARPS and ln.smem % pug_device.WARPS == 0
            assert (slot[c] <= ln.smem // pug_device.WARPS).all()
        else:
            assert ln.threads in (64, 128, 256, 512)
            assert (ln.threads * pug_device.NODES_PER_THREAD >= n[c]).all() \
                or ln.threads == pug_device.MAX_THREADS
            need = {1: staged, 2: shared, 3: np.full(len(n), pug_device.HEADER)}[ln.route]
            assert (need[c] <= ln.smem).all()
        if ln.route >= 2:
            words = pug_device.scratch_words(n[c], m[c], ln.route)
            slices += list(zip(scratch_off[c].tolist(), words.tolist()))
        else:
            assert (scratch_off[c] == -1).all()
    # the scratch slices of routes (b) and (c) tile the scratch
    slices.sort()
    ends = np.cumsum([0] + [w for _, w in slices])
    assert [off for off, _ in slices] == ends[:-1].tolist() and ends[-1] == n_scratch
    return launches


@pytest.mark.parametrize("limit", [48 * 1024, 100_000, H100_LIMIT])
def test_k7_every_live_cell_takes_one_route_within_the_limit(limit):
    n, m = _graph_sizes(limit % 97)
    launches = _check_k7_plan(n, m, limit)
    assert {ln.route for ln in launches} == {0, 1, 2, 3}


def test_k7_empty_cells_launch_nothing():
    assert pug_device.launch_plan(np.zeros(4, np.int64), np.zeros(4, np.int64),
                                  H100_LIMIT)[0] == []
    assert pug_device.launch_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                  H100_LIMIT)[0] == []
    (ln,) = _check_k7_plan(np.array([0, 7, 0]), np.array([0, 2, 0]), H100_LIMIT)
    assert ln.cells.tolist() == [1] and ln.route == 0


@pytest.mark.parametrize("what", ["entries", "nodes", "bytes"])
def test_k7_one_over_the_warp_route_moves_a_cell(what):
    """A cell at route (w)'s most entries, nodes or shared bytes runs on
    one warp; one more sends it to route (a)."""
    n, m = np.array([pug_device.WARP_NODES]), np.array([pug_device.WARP_ENTRIES])
    assert int(pug_device.cell_bytes(n, m)[0][0]) == pug_device.WARP_SLOT
    limit = pug_device.WARPS * pug_device.WARP_SLOT if what == "bytes" else H100_LIMIT
    (ln,) = _check_k7_plan(n, m, limit)[:1]
    assert ln.route == 0
    over = {"entries": (n, m + 1, limit), "nodes": (n + 1, m, limit),
            "bytes": (n, m, limit - 1)}[what]
    launches = _check_k7_plan(*over)
    assert [ln.route for ln in launches] == [1]


def test_k7_one_byte_over_a_threshold_moves_a_cell_on():
    """A cell of 20,000 nodes and 60,000 entries: at its route (a) bytes
    it is staged, one byte less sends it to route (b); at its route (b)
    bytes it is shared, one byte less sends it to route (c); route (b)
    asks for the node-to-rank map's bytes where they fit."""
    n, m = np.array([20_000]), np.array([60_000])
    _slot, staged, shared = (int(x[0]) for x in pug_device.cell_bytes(n, m))
    mapped = shared + 4 * 20_000
    assert staged > mapped
    for limit, route, smem in ((staged, 1, staged), (staged - 1, 2, mapped),
                               (mapped, 2, mapped), (mapped - 1, 2, shared),
                               (shared, 2, shared), (shared - 1, 3, pug_device.HEADER)):
        (ln,) = _check_k7_plan(n, m, limit)
        assert (ln.route, ln.smem, ln.threads) == (route, smem, pug_device.MAX_THREADS)


@pytest.mark.parametrize("kind", PUG_CASES)
def test_k7_pug_cases_routes_and_entry_bases(kind):
    """The card tests' graphs: the entry counts that upload_csr derives
    from the degrees give entry bases equal to a cumsum of the degrees
    at the cells' first nodes; the largest cell of past-smem goes to
    global scratch, of sparse-past-smem (as many nodes, under one in ten
    edged) to route (a), of wide and giant to route (b)."""
    n, deg, nbr = pug_case(kind)
    n2, m, d, _nb = pug_device.upload_csr(n, deg, nbr, torch.device("cpu"))
    assert np.array_equal(n2, n) and int(m.sum()) == len(nbr)
    launches = _check_k7_plan(n2, m, H100_LIMIT)
    node_off, entry_off = pug_device.launch_plan(n2, m, H100_LIMIT)[1:3]
    np.testing.assert_array_equal(entry_off, np.concatenate(([0], np.cumsum(deg)))[node_off])
    route = {int(c): ln.route for ln in launches for c in ln.cells}
    big = {"past-smem": 3, "sparse-past-smem": 1, "wide": 2, "giant": 2}
    if kind in big:
        assert route[int(np.argmax(n))] == big[kind]
    assert (3 in route.values()) == (kind == "past-smem")
