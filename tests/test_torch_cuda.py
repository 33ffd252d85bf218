"""CUDA kernels K1-K8 of alevin_fry_tpu_torch against their plain
PyTorch twins, and the ATAC sort and run-length count and the
multi-word and prefer-ambig cr-like WTA on the card against their CPU
results.

Every test needs a CUDA device and skips without one; whether there is
one is decided inside the ``cuda`` fixture, never at import.  K1-K5's
and K7's outputs are integers and K6's floats (plain, weighted and
bootstrap) and K8's must equal their twins' bit for bit, so every
comparison is exact equality.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from alevin_fry_tpu_torch.interop import barcodes_to_torch
from alevin_fry_tpu_torch.ops import (
    atac_device, bootstrap, em, hamming, mtrand, pug_device, segscan,
)
from em_cases import BOOT_CASES, EM_CASES, boot_case, em_case, label_weights, usa_offsets, \
    weighted_case
from pug_cases import PUG_CASES, pug_case, union_find_labels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _segments(rng, n):
    start = rng.rand(n) < 0.2
    start[0] = True
    return start


def _eq(a, b):
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 32769, 1_000_003])
def test_k1_k2_k3_kernels_match_twins(cuda, n):
    rng = np.random.RandomState(n % 1000)
    x = torch.from_numpy(rng.randint(0, 5, n).astype(np.int32)).to(cuda)
    st = torch.from_numpy(_segments(rng, n)).to(cuda)
    for got, want in zip(segscan.scan_fwd(x, st), segscan.scan_fwd_twin(x, st)):
        _eq(got, want)
    e = torch.from_numpy(rng.randint(-1000, 1000, n).astype(np.int32)).to(cuda)
    for rev in (False, True):
        _eq(segscan.scan_min(e, rev), segscan.scan_min_twin(e, rev))
    w = torch.from_numpy(rng.randint(-(1 << 62), 1 << 62, n, dtype=np.int64)).to(cuda)
    for bigger in (False, True):
        for rev in (False, True):
            _eq(segscan.scan_lex(w, bigger, rev), segscan.scan_lex_twin(w, bigger, rev))


# n of the single-pass scan checks, from the kernels' tile (elements)
LOOKBACK_SIZES = {
    "1": lambda tile: 1, "tile-1": lambda tile: tile - 1, "tile": lambda tile: tile,
    "tile+1": lambda tile: tile + 1, "3tile+5": lambda tile: 3 * tile + 5,
    "1000003": lambda tile: 1_000_003, "30000001": lambda tile: 30_000_001,
}
REPEATS = 50  # launches held against one twin result, to catch a look-back race


def _start_pattern(kind, n, tile, rng):
    start = np.zeros(n, dtype=bool)
    if kind == "row 0":
        start[0] = True
    elif kind == "every row":
        start[:] = True
    elif kind == "tile ends":
        start[tile - 1::tile] = True
    else:
        start = rng.rand(n) < 0.2
    return start


def _same_every_time(launch, want):
    for _ in range(REPEATS):
        got = launch()
        got = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want_t):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["row 0", "every row", "tile ends", "random"])
@pytest.mark.parametrize("size", list(LOOKBACK_SIZES))
def test_k1_k3_single_pass_scan_exact(cuda, size, pattern):
    """K1 and K3 (the single-pass look-back scan) equal their twins at
    tile edges and beyond, on views whose pointer sits 4 or 8 bytes off
    the 16-byte grid (and a K1 mask on another grid than its values),
    with K3 in all four directions, each launch repeated."""
    from alevin_fry_tpu_torch import _kernels

    tile = _kernels.load().aft_segscan_tile(1)
    assert _kernels.load().aft_segscan_tile(3) == tile
    n = LOOKBACK_SIZES[size](tile)
    rng = np.random.RandomState(n % 10007 + len(pattern))
    start = _start_pattern(pattern, n + 1, tile, rng)
    x = torch.from_numpy(rng.randint(0, 5, n + 1).astype(np.int32)).to(cuda)
    st = torch.from_numpy(start).to(cuda)
    views = {"aligned": (x[:n], st[:n]), "offset": (x[1:], st[1:]),
             "mask on its own grid": (x[1:], st[1:].clone())}
    for xv, sv in views.values():
        want = segscan.scan_fwd_twin(xv, sv)
        _same_every_time(lambda: segscan.scan_fwd(xv, sv), want)

    grp = torch.from_numpy(np.cumsum(start).astype(np.int32)).to(cuda)
    lo = torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1, n + 1).astype(np.int32)).to(cuda)
    rising, falling = segscan.pack_pair(grp, lo), segscan.pack_pair(-grp, lo)
    for bigger in (False, True):
        for rev in (False, True):
            # words that keep changing the running value in the scan's direction
            w = rising if bigger != rev else falling
            for wv in (w[:n], w[1:]):
                want = segscan.scan_lex_twin(wv, bigger, rev)
                _same_every_time(lambda: segscan.scan_lex(wv, bigger, rev), want)


def _min_values(kind, n, reverse, rng):
    """K2's int32 inputs: constant; strictly falling in the scan's
    direction (every element lowers the running min); seg_sum's
    where(ends, c, I32_MAX); or random over the whole int32 range with
    INT_MIN and INT_MAX among them."""
    if kind == "constant":
        return np.full(n, 7, dtype=np.int32)
    if kind == "falling":
        e = -np.arange(n, dtype=np.int32)
        return e[::-1].copy() if reverse else e
    if kind == "segment ends":
        ends = np.append(_segments(rng, n)[1:], True)
        c = np.cumsum(rng.randint(0, 5, n)).astype(np.int32)
        return np.where(ends, c, segscan.I32_MAX).astype(np.int32)
    e = rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    e[rng.randint(0, n, 3)] = segscan.I32_MAX
    e[0 if reverse else n - 1] = -(1 << 31)
    return e


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["constant", "falling", "segment ends", "full range"])
@pytest.mark.parametrize("size", list(LOOKBACK_SIZES))
def test_k2_single_pass_scan_exact(cuda, size, pattern):
    """K2 (the single-pass look-back scan) equals its twin in both
    directions at its tile's edges and beyond, on views whose pointer
    sits 0, 4, 8 and 12 bytes off the 16-byte grid (so off the grid the
    output, a fresh aligned tensor, lies on another grid than its
    input), each launch repeated."""
    from alevin_fry_tpu_torch import _kernels

    tile = _kernels.load().aft_segscan_tile(2)
    n = LOOKBACK_SIZES[size](tile)
    rng = np.random.RandomState(n % 10007 + len(pattern))
    for rev in (False, True):
        e = torch.from_numpy(_min_values(pattern, n + 3, rev, rng)).to(cuda)
        for ev in (e[:n], e[1:], e[2:], e[3:]):
            want = segscan.scan_min_twin(ev, rev)
            _same_every_time(lambda: segscan.scan_min(ev, rev), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 40_000])
def test_segment_toolkit_cuda_matches_cpu(cuda, n):
    rng = np.random.RandomState(n)
    start = _segments(rng, n)
    grp_ord = (np.cumsum(start)).astype(np.int32)
    mark = rng.rand(n) < 0.3
    val = rng.randint(0, 1 << 20, n).astype(np.int32)
    x = rng.randint(0, 4, n).astype(np.int32)
    cpu = [torch.from_numpy(a) for a in (x, start, val, mark, grp_ord)]
    dev = [t.to(cuda) for t in cpu]

    def run(x, start, val, mark, grp_ord):
        return (
            *segscan.seg_sum(x, start, with_rank=True),
            segscan.seg_reduce(val, mark, start, grp_ord),
            segscan.last_marked(val, mark, grp_ord),
            segscan.last_marked(val, mark, grp_ord, strict=True),
        )

    for got, want in zip(run(*dev), run(*cpu)):
        _eq(got, want)


# (bases, kept codes, kind): "unique" is a table without duplicates,
# "duplicates" repeats some codes (one of them 40 times), and 40,000
# codes exceed the kernels' shared-memory sample (8,191 codes), so their
# searches finish in device memory
HAMMING_CASES = [(10, 3000, "unique"), (16, 3000, "unique"), (24, 3000, "unique"),
                 (32, 3000, "unique"), (2, 6, "unique"), (32, 3000, "duplicates"),
                 (16, 1, "unique"), (16, 40_000, "unique"), (32, 40_000, "duplicates")]


def _hamming_case(rng, length, nk, kind):
    """Kept codes in ascending unsigned order (bit 63 set in some at 32
    bases) and queries: kept codes, one-substitution mutants at every
    position and random codes (every code at 2 bases)."""
    mask = np.uint64((1 << (2 * length)) - 1) if length < 32 else np.uint64(2**64 - 1)
    draw = lambda k: rng.randint(0, 1 << 63, k, dtype=np.uint64) * np.uint64(3) & mask  # noqa: E731
    kept = np.unique(draw(nk))[:nk]
    if kind == "duplicates":
        kept = np.sort(np.concatenate([kept, kept[rng.randint(0, len(kept), len(kept) // 4)],
                                       np.repeat(kept[len(kept) // 2], 40)]))
    n = 500 if len(kept) > 1 else 30
    pos = rng.randint(0, length, n).astype(np.uint64)
    sub = rng.randint(1, 4, n).astype(np.uint64)
    q = np.concatenate([
        kept[rng.randint(0, len(kept), n)],
        kept[rng.randint(0, len(kept), n)] ^ (sub << (np.uint64(2) * pos)),
        draw(n), np.zeros(1, np.uint64),
        np.arange(16, dtype=np.uint64) if length == 2 else np.zeros(0, np.uint64),
    ])
    if length == 32:
        assert (kept >> np.uint64(63)).any()
    return q, kept


@pytest.mark.cuda
@pytest.mark.parametrize("length,nk,kind", HAMMING_CASES)
def test_k4_kernel_matches_twin(cuda, length, nk, kind):
    """K4 against its brute-force twin and the probe twin."""
    q, kept = _hamming_case(np.random.RandomState(length + nk), length, nk, kind)
    qt = barcodes_to_torch(q).to(cuda)
    kt = barcodes_to_torch(kept).to(cuda)
    got = hamming.neighbor_counts(qt, kt, length)
    torch.cuda.synchronize()
    for want in (hamming.neighbor_counts_twin(qt, kt, length),
                 hamming.neighbor_probe_twin(qt, kt, length)):
        for g, w in zip(got, want):
            _eq(g, w)
    if len(kept) > 16:
        assert bool((got[0] == 1).any()) and bool((got[0] == 0).any())
    if kind == "duplicates":
        assert bool((got[0] > 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("length,nk,kind", HAMMING_CASES + [(0, 3000, "mixed lengths")])
def test_k5_kernel_matches_twin(cuda, length, nk, kind):
    """K5 on a shuffled kept table (codes of 8..16 bases in the mixed
    case) against its brute-force twin, the probe twin and K4."""
    rng = np.random.RandomState(100 + length + nk)
    if kind == "mixed lengths":
        parts = [_hamming_case(rng, b, nk // 9, "unique") for b in range(8, 17)]
        q = np.concatenate([p[0] for p in parts])
        kept = np.unique(np.concatenate([p[1] for p in parts]))
    else:
        q, kept = _hamming_case(rng, length, nk, kind)
    qt = barcodes_to_torch(q).to(cuda)
    kt = barcodes_to_torch(kept).to(cuda)
    perm = torch.from_numpy(rng.permutation(len(kept))).to(cuda)
    got = hamming.neighbor_counts_brute(qt, kt[perm])
    torch.cuda.synchronize()
    probe = hamming.neighbor_probe_twin(qt, kt, hamming.used_positions(qt, kt), values=True)
    for want in (hamming.neighbor_counts_brute_twin(qt, kt[perm]), probe):
        for g, w in zip(got, want):
            _eq(g, w)
    if len(kept) > 16:
        assert bool((got[0] == 1).any()) and bool((got[0] == 0).any())
    if length:
        cnt4, idx4 = hamming.neighbor_counts(qt, kt, length)
        hit = cnt4 > 0
        _eq(got[0], cnt4)
        _eq(got[1][hit], kt[idx4[hit].long()])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5000, 300_000])
def test_sort_rle_cuda_matches_cpu(cuda, n):
    rng = np.random.RandomState(n)
    cols = [rng.randint(0, 20, n), rng.randint(0, 1 << 28, n) % 997,
            rng.randint(0, 2000, n),
            rng.randint(0, 1 << 63, n, dtype=np.uint64) % np.uint64(7) << np.uint64(61)]
    got, cnt = atac_device.sort_rle(cols, cuda)
    want, want_cnt = atac_device.sort_rle(cols, torch.device("cpu"))
    np.testing.assert_array_equal(cnt, want_cnt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def wide_key_words(n: int, seed: int):
    """(cell, umi, gene) int64 words of ``n`` read-gene pairs too wide to
    pack: 32-base UMIs, which use bit 63, from a pool small enough that
    (cell, umi) groups hold several genes and ties; 14-bit genes."""
    rng = np.random.RandomState(seed)
    cell = np.sort(rng.randint(0, 20_000, n)).astype(np.int64)
    pool = rng.randint(0, 1 << 63, 16, dtype=np.uint64) | np.uint64(1 << 63)
    umi = pool[rng.randint(0, len(pool), n)].view(np.int64)
    gene = rng.randint(0, 1 << 14, n).astype(np.int64)
    return [torch.from_numpy(w) for w in (cell, umi, gene)]


@pytest.mark.cuda
@pytest.mark.parametrize("usa", [False, True])
def test_wide_key_wta_cuda_matches_cpu(cuda, usa):
    """The multi-word WTA on the card (its sorts, and K1-K3) equals its
    CPU result."""
    from alevin_fry_tpu_torch.ops.crlike_device import resolve_crlike_wta_words

    words = wide_key_words(1_000_003, 5)
    n_rows = 3 * (1 << 13) if usa else 1 << 14
    before = dict(segscan.LAUNCHES)
    got = resolve_crlike_wta_words(*(w.to(cuda) for w in words), 14, n_rows, usa=usa)
    want = resolve_crlike_wta_words(*words, 14, n_rows, usa=usa)
    assert all(segscan.LAUNCHES[k] > before[k] for k in ("K1", "K2", "K3"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 10_000


def _k6_plan(kind, usa, with_last_round, init_uniform):
    batch, n_rows = em_case(kind)
    return em.plan_cells(*batch, n_rows, usa_offsets(n_rows) if usa else None, init_uniform,
                         with_last_round)


def _bits(t):
    return t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("init_uniform", [False, True])
@pytest.mark.parametrize("with_last_round", [True, False])
@pytest.mark.parametrize("usa", [False, True])
@pytest.mark.parametrize("kind", list(EM_CASES))
def test_k6_matches_twin(cuda, kind, usa, with_last_round, init_uniform):
    """K6 equals its twin bit for bit, values and rounds: all-singleton
    and empty cells, zero-length classes, a 100-round cell, a cell past
    the shared-memory limit (global scratch) and 10,000 random cells."""
    plan = _k6_plan(kind, usa, with_last_round, init_uniform)
    want = em.em_run_twin(plan.to("cpu"))
    launches, global_cells = em.LAUNCHES["K6"], em.STATS["global_cells"]
    got = em.em_run(plan.to(cuda))
    assert em.LAUNCHES["K6"] > launches
    assert (em.STATS["global_cells"] > global_cells) == (kind == "global-route")
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert int(want[1].max()) == 100


@pytest.mark.cuda
def test_k6_repeated_launches_equal(cuda):
    """50 launches of one input give one result: no run-to-run change."""
    plan = _k6_plan("10k-cells", True, True, False).to(cuda)
    want = [_bits(x) for x in em.em_run(plan)]
    for _ in range(REPEATS):
        for g, w in zip(em.em_run(plan), want):
            assert torch.equal(_bits(g), w)


@pytest.mark.cuda
@pytest.mark.parametrize("words", [False, True])
def test_prefer_ambig_wta_cuda_matches_cpu(cuda, words):
    """The gene-pair WTA on the card equals its CPU result."""
    from alevin_fry_tpu_torch.ops.crlike_device import (
        resolve_crlike_wta_device, resolve_crlike_wta_words,
    )

    rng = np.random.RandomState(9)
    n, gbits, n_rows = 1_000_003, 14, 3 * (1 << 13)
    cell = np.sort(rng.randint(0, 20_000, n)).astype(np.int64)
    umi = rng.randint(0, 64, n).astype(np.int64)
    gene = rng.randint(0, 1 << gbits, n).astype(np.int64)
    if words:
        args = [torch.from_numpy(w) for w in (cell, umi, gene)]
        run = lambda dev: resolve_crlike_wta_words(  # noqa: E731
            *(a.to(dev) for a in args), gbits, n_rows, usa=True, prefer_ambig=True)
    else:
        key = torch.from_numpy((cell << (6 + gbits)) | (umi << gbits) | gene)
        run = lambda dev: resolve_crlike_wta_device(  # noqa: E731
            key.to(dev), 6, gbits, n_rows, usa=True, prefer_ambig=True)
    for g, w in zip(run(cuda), run(torch.device("cpu"))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("init_uniform", [False, True])
@pytest.mark.parametrize("kind", list(EM_CASES) + ["long-classes"])
def test_k6_weighted_matches_twin(cuda, kind, init_uniform):
    """The weighted K6 (the long-read EM) equals its twin bit for bit,
    values and rounds, on em_cases' batches with label weights (one past
    the shared-memory limit) and on cells whose longest class crosses 8
    and 128 labels; 50 launches give one result."""
    if kind == "long-classes":
        batch, n_rows, w = weighted_case()
    else:
        batch, n_rows = em_case(kind)
        w = label_weights(len(batch[2]))
    plan = em.plan_cells(*batch, n_rows, None, init_uniform, False, w)
    want = [_bits(x) for x in em.em_run_twin(plan.to("cpu"))]
    t = plan.to(cuda)
    launches, global_cells = em.LAUNCHES["K6"], em.STATS["global_cells"]
    for _ in range(REPEATS):
        for g, x in zip(em.em_run(t), want):
            assert torch.equal(_bits(g), x)
    assert em.LAUNCHES["K6"] > launches
    assert (em.STATS["global_cells"] > global_cells) == (kind == "global-route")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PUG_CASES)
def test_k7_matches_twin_and_union_find(cuda, kind):
    """K7's labels equal a union-find's and its twin's on the card:
    random cells, isolated nodes, long chains, one giant component, a
    cell past the shared-memory limit (global scratch), a sparse cell as
    large (staged), a cell whose adjacency does not fit (shared); 50
    launches give one result."""
    graph = pug_case(kind)
    want = union_find_labels(*graph)
    t = pug_device.upload_csr(*graph, cuda)
    launches, global_cells = pug_device.LAUNCHES["K7"], pug_device.STATS["global_cells"]
    for _ in range(REPEATS):
        labels, rounds = pug_device.connected_components(*t)
        np.testing.assert_array_equal(labels.cpu().numpy(), want)
    assert pug_device.LAUNCHES["K7"] > launches
    assert (pug_device.STATS["global_cells"] > global_cells) == (kind == "past-smem")
    assert bool((rounds.cpu().numpy()[t[0] > 0] >= 1).all())
    twin, _ = pug_device.connected_components_twin(t[0], t[2], t[3])
    np.testing.assert_array_equal(twin.cpu().numpy(), want)


@pytest.mark.cuda
def test_k7_takes_every_route(cuda):
    """Across tests/pug_cases.py's graphs K7 runs cells on each of its
    routes, (w) one warp, (a) staged, (b) shared and (c) global, and each
    result equals the union-find's."""
    since = dict(pug_device.STATS)
    for kind in PUG_CASES:
        graph = pug_case(kind)
        labels, _ = pug_device.connected_components(*pug_device.upload_csr(*graph, cuda))
        np.testing.assert_array_equal(labels.cpu().numpy(), union_find_labels(*graph))
    taken = {k: pug_device.STATS[k] - since[k] for k in since}
    assert all(taken[f"{r}_cells"] > 0 for r in pug_device.ROUTES), taken


@pytest.mark.cuda
def test_k7_refuses_bad_inputs(cuda):
    """The wrapper raises on types the kernel does not take, on tensors
    on two devices, on node counts that do not match the degrees, and on
    entry counts per cell of the wrong type or that do not sum to the
    degrees."""
    n, e, deg, nbr = pug_device.upload_csr(*pug_case("isolated"), cuda)
    with pytest.raises(ValueError):
        pug_device.connected_components(n, e, deg, nbr.long())
    with pytest.raises(ValueError):
        pug_device.connected_components(n, e, deg.cpu(), nbr)
    with pytest.raises(ValueError):
        pug_device.connected_components(n.astype(np.int32), e, deg, nbr)
    with pytest.raises(ValueError):
        pug_device.connected_components(n[:-1], e, deg, nbr)
    with pytest.raises(ValueError):
        pug_device.connected_components(n, e.astype(np.int32), deg, nbr)
    with pytest.raises(ValueError):
        pug_device.connected_components(n, e + (np.arange(len(e)) == 3), deg, nbr)
    with pytest.raises(ValueError):
        pug_device.connected_components(n, e[:-1], deg, nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 271828, 2**32 - 1])
def test_k8_matches_numpy_stream_and_twin(cuda, seed):
    """K8 equals NumPy's stream (float32 + 1e-5) over 3,000 doubles (ten
    twists), and its twin on 33 replicates of 50 cells whose ids reach
    20,000."""
    n = 3000
    want = np.random.RandomState(seed).random_sample(n).astype(np.float32) + 1e-5
    launches = mtrand.LAUNCHES["K8"]
    got = mtrand.random_init(torch.tensor([[seed]], device=cuda),
                             torch.tensor([0, n], device=cuda),
                             torch.arange(n, dtype=torch.int32, device=cuda))
    assert mtrand.LAUNCHES["K8"] == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy()[0].view(np.int32), want.view(np.int32))
    rng = np.random.RandomState(seed % 997)
    ids = [np.sort(rng.choice(20_000, rng.randint(1, 400), replace=False)) for _ in range(50)]
    off = torch.from_numpy(np.concatenate(([0], np.cumsum([len(i) for i in ids]))))
    seeds = torch.from_numpy((rng.randint(0, 2**32, (33, 50), dtype=np.int64) ^ seed)
                             & 0xFFFFFFFF)
    ids = torch.from_numpy(np.concatenate(ids).astype(np.int32))
    want = mtrand.random_init_twin(seeds, off, ids)
    for _ in range(REPEATS):
        got = mtrand.random_init(seeds.to(cuda), off.to(cuda), ids.to(cuda))
        assert torch.equal(_bits(got), _bits(want))


def _boot_tensors(kind: str, n: int, device):
    batch, n_rows = boot_case(kind)
    ceo, lo, labels, counts = batch
    cells = np.arange(len(ceo) - 1)
    return bootstrap.replicate_plan(
        ceo, lo, labels, n_rows, bootstrap.cell_widths(ceo, lo),
        bootstrap.resample(counts, ceo, cells, n),
        bootstrap.init_seeds(bootstrap.SEED, cells, n), device)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("kind", list(BOOT_CASES))
def test_k6_bootstrap_matches_twin(cuda, kind, n):
    """K6's bootstrap mode equals its twin bit for bit, values and rounds
    (the twin on the card): rungs at width 4 and 16, a cell past the
    ladder, cells past the shared-memory limit (global scratch per
    replicate); K8's init equals its twin's on the CPU."""
    t = _boot_tensors(kind, n, cuda)
    if kind != "global-route":
        assert torch.equal(_bits(t.boot_init), _bits(_boot_tensors(kind, n, "cpu").boot_init))
    want = [_bits(x) for x in em.em_run_twin(t)]
    launches, global_cells = em.LAUNCHES["K6-boot"], em.STATS["global_cells"]
    for _ in range(3):
        for g, x in zip(em.em_run(t), want):
            assert torch.equal(_bits(g), x)
    assert em.LAUNCHES["K6-boot"] > launches
    assert (em.STATS["global_cells"] > global_cells) == (kind == "global-route")
    assert want[0].shape == (n, len(t.occ_off) - 1)


# the batch that takes each route of K6, by mode (tests/em_cases.py)
ROUTE_CASES = {"plain": {"staged": "small", "shared": "shared-route", "global": "global-route"},
               "boot": {"staged": "rungs", "shared": "shared-route", "global": "global-route"}}


def _k6_mode_tensors(mode: str, kind: str, device):
    """(tensors on ``device``, the twin's bits) of a K6 batch in ``mode``:
    plain (USA, last round), weighted or bootstrap (2 replicates)."""
    if mode == "boot":
        t = _boot_tensors(kind, 2, device)
        return t, [_bits(x) for x in em.em_run_twin(t)]
    batch, n_rows = em_case(kind)
    if mode == "weighted":
        plan = em.plan_cells(*batch, n_rows, None, False, False, label_weights(len(batch[2])))
    else:
        plan = em.plan_cells(*batch, n_rows, usa_offsets(n_rows), False, True)
    return plan.to(device), [_bits(x) for x in em.em_run_twin(plan.to("cpu"))]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["staged", "shared", "global"])
@pytest.mark.parametrize("mode", ["plain", "weighted", "boot"])
def test_k6_each_route_matches_twin(cuda, mode, route):
    """K6 equals its twin bit for bit, values and rounds, on a batch with
    a cell on each of its routes: (a) layout and state staged in shared
    memory, (b) the state alone there, (c) the state in global scratch;
    in the plain (USA), weighted and bootstrap modes."""
    kind = ROUTE_CASES["boot" if mode == "boot" else "plain"][route]
    t, want = _k6_mode_tensors(mode, kind, cuda)
    before = dict(em.STATS)
    for g, w in zip(em.em_run(t), want):
        assert torch.equal(_bits(g), w)
    assert em.STATS[f"{route}_cells"] > before[f"{route}_cells"]


@pytest.mark.cuda
def test_k6_bootstrap_tile_replicates_keep_their_own_rounds(cuda):
    """33 replicates of cells past the ladder run in tiles of 17 over one
    staged layout; within a tile the replicates converge at different
    rounds, one runs 101 (100 and its last round), and every row equals
    the twin's, values and rounds."""
    t = _boot_tensors("past-ladder", 33, cuda)
    want = [_bits(x) for x in em.em_run_twin(t)]
    tiled = em.STATS["tiled_rows"]
    for g, w in zip(em.em_run(t), want):
        assert torch.equal(_bits(g), w)
    assert em.STATS["tiled_rows"] > tiled
    rounds = want[1].numpy()
    assert rounds.max() == 101
    assert any(len(set(rounds[:17, c].tolist())) > 1 for c in range(rounds.shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kind", [("plain", "10k-cells"), ("boot", "rungs")])
def test_k6_staged_and_tiled_launches_equal_the_twin(cuda, mode, kind):
    """50 launches of route (a) (10,000 cells, USA) and of bootstrap tiles
    (20 replicates a block) each equal one twin result: no race in the
    staging or the round masks."""
    if mode == "boot":
        t = _boot_tensors(kind, 20, cuda)
        want = [_bits(x) for x in em.em_run_twin(t)]
    else:
        t, want = _k6_mode_tensors("plain", kind, cuda)
    staged, tiled = em.STATS["staged_cells"], em.STATS["tiled_rows"]
    for _ in range(REPEATS):
        for g, w in zip(em.em_run(t), want):
            assert torch.equal(_bits(g), w)
    assert em.STATS["staged_cells"] > staged
    assert (em.STATS["tiled_rows"] > tiled) == (mode == "boot")


@pytest.mark.cuda
def test_k8_twist_borders_single_entries_and_an_empty_cell(cuda):
    """K8 equals NumPy's stream and its twin for 33 replicates sharing
    each cell's ids: ids on the twist borders (0, 311, 312, 623, 624 and
    19,999), single-entry rows, an empty cell between two others, and a
    cell of 2,000 ids (more than 32 entries a twist)."""
    cells = [[0, 311, 312, 623, 624, 19_999], [311], [], [312], [623], [624], [19_999], [0],
             list(range(0, 6000, 3))]
    rng = np.random.RandomState(17)
    seeds = torch.from_numpy(rng.randint(0, 2**32, (33, len(cells)), dtype=np.int64))
    off = torch.from_numpy(np.cumsum([0] + [len(c) for c in cells]))
    ids = torch.from_numpy(np.concatenate([np.asarray(c, np.int32) for c in cells]))
    want = mtrand.random_init_twin(seeds, off, ids)
    for r in range(33):
        for c, cid in enumerate(cells):
            if cid:
                x = np.random.RandomState(int(seeds[r, c])).random_sample(max(cid) + 1)
                ref = x.astype(np.float32)[cid] + np.float32(1e-5)
                got = want[r, int(off[c]):int(off[c + 1])].numpy()
                np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    args = (seeds.to(cuda), off.to(cuda), ids.to(cuda))
    launches = mtrand.LAUNCHES["K8"]
    for _ in range(REPEATS):
        assert torch.equal(_bits(mtrand.random_init(*args)), _bits(want))
    assert mtrand.LAUNCHES["K8"] == launches + REPEATS


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 20, 33])
def test_replicate_summary_on_the_card_equals_the_cpu(cuda, n):
    """The bootstraps' float64 mean and variance on the card equal the
    CPU's, bit for bit (the divisor is a device tensor)."""
    rng = np.random.RandomState(n)
    alpha = (rng.rand(n, 100_000) * 10.0 ** rng.randint(-2, 4, (n, 100_000))).astype(np.float32)
    got = bootstrap._summarize(torch.from_numpy(alpha).to(cuda))
    want = bootstrap._summarize(torch.from_numpy(alpha))
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_flex_chain_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The Flex stages (gpl -u with its per-sample K4 rescue, the fast
    collate with its K4 1-edit tier, in memory and out of core, quant
    -r cr-like on K1-K3) on the card write the CPU run's bytes."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from alevin_fry_tpu_torch.cli import main
    from reference_host_path import flex_artifacts

    d = tmp_path / "d"
    subprocess.run([sys.executable, str(Path(__file__).parent / "reference_host_path.py"),
                    "make-flex", str(d), "--n-samples", "4", "--n-cells-per-sample", "100",
                    "--n-reads", "60000", "--n-genes", "200", "--permit-size", "5000"],
                   check=True, capture_output=True)
    before = {**hamming.LAUNCHES, **segscan.LAUNCHES}
    for device in ("cpu", "cuda"):
        out = tmp_path / device
        common = ["-t", "2", "--device", device]
        for argv in (
            ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o", str(out / "gpl"),
             "-u", str(d / "permit.txt"), "--sample-bc-list", str(d / "samples.tsv"),
             "--sample-correction-mode", "1-edit"],
            ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad")],
            ["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g.tsv"), "-o", str(out / "quant"),
             "-r", "cr-like"],
        ):
            assert main(argv + common) == 0
    launched = {k: v - before[k] for k, v in {**hamming.LAUNCHES, **segscan.LAUNCHES}.items()}
    # the rescue once per sample, the 1-edit tier once per sample
    assert launched["K4"] >= 8 and all(launched[k] > 0 for k in ("K1", "K2", "K3"))
    arts = flex_artifacts(tmp_path / "cpu")
    assert arts == flex_artifacts(tmp_path / "cuda") and len(arts) == 16
    for name in arts + ("gpl/sample_info.json",):
        assert (tmp_path / "cpu" / name).read_bytes() == (tmp_path / "cuda" / name).read_bytes()
    gpl = tmp_path / "cuda" / "gpl"
    in_mem = (gpl / "map.collated.rad").read_bytes()
    assert main(["collate", "-i", str(gpl), "-r", str(d / "rad"), "-m", "20000",
                 "--device", "cuda"]) == 0
    assert (gpl / "map.collated.rad").read_bytes() == in_mem
    assert json.loads((gpl / "collate.json").read_text())["multi_barcode"] is True


@pytest.mark.cuda
def test_two_process_chain_on_the_card_equals_one_process_cpu(cuda, tmp_path):
    """gpl, collate and quant as two ranks sharing the card (gloo between
    them; K4 on both ranks in gpl, K1-K3 on both in quant) write the
    one-process CPU run's bytes."""
    import subprocess
    import sys
    from pathlib import Path

    from alevin_fry_tpu_torch.cli import main
    from reference_host_path import DATA_ARTIFACTS
    from two_process import run_two

    d = tmp_path / "d"
    subprocess.run([sys.executable, str(Path(__file__).parent / "reference_host_path.py"),
                    "make", str(d), "--n-cells", "200", "--n-reads", "100000",
                    "--n-genes", "500"], check=True, capture_output=True)

    def stages(out, device):
        common = ["-t", "2", "--device", device]
        return [
            ["gpl", ["generate-permit-list", "-i", str(d / "rad"), "-d", "fw", "-o",
                     str(out / "gpl"), "-u", str(d / "permit.txt"), "-m", "10", *common]],
            ["collate", ["collate", "-i", str(out / "gpl"), "-r", str(d / "rad"), *common]],
            ["quant", ["quant", "-i", str(out / "gpl"), "-m", str(d / "t2g_3col.tsv"), "-o",
                       str(out / "quant"), "-r", "cr-like", *common]],
        ]

    for _name, argv in stages(tmp_path / "cpu", "cpu"):
        assert main(argv) == 0
    summaries, _logs = run_two(stages(tmp_path / "cuda", "cuda"), tmp_path / "logs",
                               timeout=300)
    for name in DATA_ARTIFACTS:
        assert (tmp_path / "cpu" / name).read_bytes() == (tmp_path / "cuda" / name).read_bytes()
    for r, s in enumerate(summaries):
        assert s["stages"]["quant"]["device"] == f"cuda:{r % torch.cuda.device_count()}"
        assert s["stages"]["gpl"]["launches"]["K4"] > 0
        assert all(s["stages"]["quant"]["launches"][k] > 0 for k in ("K1", "K2", "K3"))


# --- the device mesh (parallel/mesh.py) --------------------------------------------

WRAPPERS = ("K1", "K2", "K3", "K4", "K5", "K6", "K6-boot", "K7", "K8")


def _wrapper_case(key: str, dev):
    """(the wrapper's outputs on ``dev``, its twin's on the CPU) for one
    small input of kernel ``key``."""
    rng = np.random.RandomState(len(key) * 7 + ord(key[1]))
    on = lambda *ts: [t.to(dev) for t in ts]  # noqa: E731
    if key in ("K1", "K2", "K3"):
        n = 100_003
        x = torch.from_numpy(rng.randint(0, 5, n).astype(np.int32))
        st = torch.from_numpy(_segments(rng, n))
        w = torch.from_numpy(rng.randint(-(1 << 62), 1 << 62, n, dtype=np.int64))
        fn, twin, args = {
            "K1": (segscan.scan_fwd, segscan.scan_fwd_twin, (x, st)),
            "K2": (segscan.scan_min, segscan.scan_min_twin, (x, True)),
            "K3": (segscan.scan_lex, segscan.scan_lex_twin, (w, True, True)),
        }[key]
        dev_args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        got, want = fn(*dev_args), twin(*args)
    elif key in ("K4", "K5"):
        q, kept = _hamming_case(rng, 16, 3000, "unique")
        qt, kt = barcodes_to_torch(q), barcodes_to_torch(kept)
        if key == "K4":
            got = hamming.neighbor_counts(*on(qt, kt), 16)
            want = hamming.neighbor_counts(qt, kt, 16)
        else:
            kt = kt[torch.from_numpy(rng.permutation(len(kt)))]
            got, want = hamming.neighbor_counts_brute(*on(qt, kt)), \
                hamming.neighbor_counts_brute(qt, kt)
    elif key == "K6":
        plan = _k6_plan("small", True, True, False)
        got, want = em.em_run(plan.to(dev)), em.em_run_twin(plan.to("cpu"))
    elif key == "K6-boot":
        got, want = em.em_run(_boot_tensors("rungs", 2, dev)), \
            em.em_run_twin(_boot_tensors("rungs", 2, "cpu"))
    elif key == "K7":
        graph = pug_case("random")
        got = pug_device.connected_components(*pug_device.upload_csr(*graph, dev))[0]
        want = torch.from_numpy(union_find_labels(*graph))
    else:
        ids = [np.sort(rng.choice(5000, rng.randint(1, 300), replace=False)) for _ in range(20)]
        off = torch.from_numpy(np.concatenate(([0], np.cumsum([len(i) for i in ids]))))
        seeds = torch.from_numpy(rng.randint(0, 2**32, (3, 20), dtype=np.int64))
        ids = torch.from_numpy(np.concatenate(ids).astype(np.int32))
        got = mtrand.random_init(*on(seeds, off, ids))
        want = mtrand.random_init_twin(seeds, off, ids)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return [(_bits(g), _bits(w)) for g, w in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("key", WRAPPERS)
def test_each_wrapper_on_each_shard_of_a_mesh_matches_twin(cuda, key):
    """Every wrapper launched on each shard's card of a 2-shard mesh (both
    shards on one card where there is one) equals its twin, and counts
    its launch under that card."""
    from alevin_fry_tpu_torch import _kernels
    from alevin_fry_tpu_torch.parallel import mesh

    for dev in mesh.make_mesh(2, "cuda").devices:
        before = _kernels.BY_CARD.get((dev.index, key), 0)
        for g, w in _wrapper_case(key, dev):
            assert torch.equal(g, w)
        assert _kernels.BY_CARD[(dev.index, key)] > before


@pytest.mark.cuda
@pytest.mark.parametrize("key", WRAPPERS)
def test_each_wrapper_launches_on_its_tensors_card(cuda, key):
    """With card 0 current, every wrapper given tensors on card 1 plans
    for and launches on card 1, and equals its twin (skips on one card)."""
    from alevin_fry_tpu_torch import _kernels

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    before = {c: _kernels.BY_CARD.get((c, key), 0) for c in (0, 1)}
    with torch.cuda.device(0):
        for g, w in _wrapper_case(key, dev):
            assert torch.equal(g, w)
        torch.cuda.synchronize(dev)
    assert _kernels.BY_CARD[(1, key)] > before[1]
    assert _kernels.BY_CARD.get((0, key), 0) == before[0]


@pytest.mark.cuda
def test_mesh_programs_on_two_shards_match_the_cpu(cuda):
    """The mesh programs the stages call, on 2 shards of the card (or of
    two cards), equal their 2-shard CPU results: the histograms and the
    EM (K6)."""
    from alevin_fry_tpu_torch.parallel import mesh

    gm, cm = mesh.make_mesh(2, "cuda"), mesh.make_mesh(2, "cpu")
    rng = np.random.RandomState(7)
    wl = np.unique(rng.randint(0, 1 << 62, 50_000, dtype=np.uint64) * np.uint64(3))
    bcs = np.where(rng.rand(300_001) < 0.7, wl[rng.randint(0, len(wl), 300_001)],
                   rng.randint(0, 1 << 62, 300_001, dtype=np.uint64))
    for g, c in zip(mesh.sharded_histogram(gm, bcs, wl), mesh.sharded_histogram(cm, bcs, wl)):
        np.testing.assert_array_equal(g, c)
    idx = rng.randint(0, 31_000, 500_001)
    np.testing.assert_array_equal(mesh.sharded_bin_histogram(gm, idx, 31_000),
                                  np.bincount(idx, minlength=31_000))
    batch, n_rows = em_case("10k-cells")
    args = (*batch, n_rows, usa_offsets(n_rows), False, True)
    for (gi, gv), (wi, wv) in zip(em.em_cells(*args, cuda, mesh=gm),
                                  em.em_cells(*args, torch.device("cpu"))):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
