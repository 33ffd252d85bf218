"""Inputs of the UMI-graph connected-component tests: per-cell graphs in
the layout ``csrc/radc.cpp::radc_pug_graph_export`` writes (nodes per
cell, degree per node, each node's neighbours as sorted distinct
cell-local ids, every edge both ways), made from numpy seeds, for
tests/test_torch_parsimony.py (kernel K7's twin against the JAX
package), tests/test_torch_cuda.py and chip_smoke.py phase 2 (K7 against
its twin).  Imports nothing of either package."""

import numpy as np

# nodes of a cell whose 4 bytes a node fill the H100's 227 KB of shared
# memory: the old kernel's labels, or K7's parents of as many edged nodes
SMEM_NODES = 232_448 // 4

PUG_CASES = ("random", "isolated", "chains", "giant", "past-smem", "sparse-past-smem", "wide")


def csr_from_edges(n_nodes: np.ndarray, cell: np.ndarray, u: np.ndarray, v: np.ndarray):
    """(nodes per cell int64, degree per node int64, neighbours int32) of
    the undirected graphs with edges (u, v) (cell-local ids) in cells
    ``cell``; self-loops are dropped."""
    n_nodes = np.asarray(n_nodes, np.int64)
    base = np.concatenate(([0], np.cumsum(n_nodes)))[:-1]
    keep = u != v
    gu, gv = base[cell[keep]] + u[keep], base[cell[keep]] + v[keep]
    a, b = np.concatenate([gu, gv]), np.concatenate([gv, gu])
    key = np.unique(a.astype(np.int64) << 32 | b.astype(np.int64))
    src, dst = key >> 32, key & 0xFFFFFFFF
    n = int(n_nodes.sum())
    deg = np.bincount(src, minlength=n).astype(np.int64)
    node_cell = np.repeat(np.arange(len(n_nodes)), n_nodes)
    nbr = (dst - base[node_cell[src]]).astype(np.int32)
    return n_nodes, deg, nbr


def _random_cells(rng, n_cells, max_nodes, mean_degree):
    n_nodes = rng.randint(0, max_nodes + 1, n_cells)
    n_edges = rng.poisson(mean_degree * n_nodes / 2)
    cell = np.repeat(np.arange(n_cells), n_edges)
    top = np.maximum(n_nodes[cell], 1)
    return n_nodes, cell, rng.randint(0, 1 << 30, len(cell)) % top, \
        rng.randint(0, 1 << 30, len(cell)) % top


def _chain(rng, n):
    """A path over the n nodes in random order: the smallest index lies
    anywhere on it, so labels travel far."""
    order = rng.permutation(n)
    return order[:-1], order[1:]


def pug_case(kind: str, seed: int = 7):
    """(nodes per cell, degrees, neighbours) of one of :data:`PUG_CASES`:
    ``random`` 2,000 cells of up to 300 nodes and mean degree 1.5;
    ``isolated`` 100 cells of 500 nodes and no edge; ``chains`` 20 cells
    each a path of 2,000-6,000 nodes, the first in index order and the
    others in random order; ``giant`` a cell of 20,000 nodes with
    mean degree 3 among 500 random cells; ``past-smem`` a cell of
    ``SMEM_NODES + 10,000`` nodes (two chains and random edges) among 300
    random cells; ``sparse-past-smem`` a cell of as many nodes of which
    under one in ten has an edge (paths of 3 and a 500-node chain in
    random order, as in the parsimony quant's graphs) among 300 random
    cells; ``wide`` a cell of 40,000 nodes with mean degree 2.5, whose
    4 bytes an edged node fit in shared memory but whose adjacency does
    not, among 300 random cells."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        return csr_from_edges(*_random_cells(rng, 2000, 300, 1.5))
    if kind == "isolated":
        z = np.zeros(0, np.int64)
        return csr_from_edges(np.full(100, 500), z, z, z)
    if kind == "chains":
        sizes = rng.randint(2000, 6001, 20)
        parts = [_chain(rng, int(n)) for n in sizes[1:]]
        n0 = int(sizes[0])
        parts.insert(0, (np.arange(n0 - 1, 0, -1), np.arange(n0 - 2, -1, -1)))
        cell = np.repeat(np.arange(20), sizes - 1)
        return csr_from_edges(sizes, cell, np.concatenate([p[0] for p in parts]),
                              np.concatenate([p[1] for p in parts]))
    big = {"giant": (20_000, 3.0, 500), "past-smem": (SMEM_NODES + 10_000, 0.5, 300),
           "sparse-past-smem": (SMEM_NODES + 10_000, 0.0, 300), "wide": (40_000, 2.5, 300)}
    n_big, degree, n_small = big[kind]
    n_nodes, cell, u, v = _random_cells(rng, n_small, 300, 1.5)
    m = int(degree * n_big / 2)
    bu, bv = rng.randint(0, n_big, m), rng.randint(0, n_big, m)
    if kind == "sparse-past-smem":
        picked = rng.permutation(n_big)
        paths = picked[:3 * (n_big // 40)].reshape(-1, 3)
        c1 = _chain(rng, 500)
        chain = picked[len(paths) * 3:len(paths) * 3 + 500]
        bu = np.concatenate([paths[:, 0], paths[:, 1], chain[c1[0]]])
        bv = np.concatenate([paths[:, 1], paths[:, 2], chain[c1[1]]])
    if kind == "past-smem":
        half = n_big // 2
        c1, c2 = _chain(rng, half), _chain(rng, n_big - half)
        bu = np.concatenate([bu, c1[0], c2[0] + half])
        bv = np.concatenate([bv, c1[1], c2[1] + half])
    at = n_small // 2
    n_nodes = np.insert(n_nodes, at, n_big)
    cell = np.where(cell >= at, cell + 1, cell)
    return csr_from_edges(n_nodes, np.concatenate([cell, np.full(len(bu), at)]),
                          np.concatenate([u, bu]), np.concatenate([v, bv]))


def union_find_labels(n_nodes: np.ndarray, deg: np.ndarray, nbr: np.ndarray) -> np.ndarray:
    """Per node, the smallest cell-local index of its component, by a
    plain union-find over every cell's edges (the brute oracle)."""
    n = len(deg)
    parent = np.arange(n)
    base = np.concatenate(([0], np.cumsum(n_nodes)))[:-1]
    node_cell = np.repeat(np.arange(len(n_nodes)), n_nodes)
    src = np.repeat(np.arange(n), deg)
    dst = base[node_cell[src]] + nbr

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(src.tolist(), dst.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(x) for x in range(n)], np.int64)
    return (roots - base[node_cell]).astype(np.int32)
