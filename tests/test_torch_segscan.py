"""The port's segment scans (alevin_fry_tpu_torch/ops/segscan.py, the
wrappers of kernels K1-K3) on the CPU, where they run their plain
PyTorch twins, against the reference's Pallas scans in interpret mode
and against its XLA cumulative formulas.

Inputs come from numpy seeds and the outputs are integers, so every
comparison is exact equality.  n = 40000 is larger than the Pallas
block (32768), so it covers the reference's cross-block carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alevin_fry_tpu.ops import crlike_device, pallas_segscan
from alevin_fry_tpu_torch.ops import hamming, segscan

SIZES = [1, 300, 5000, 40000]


def _case(n, seed):
    rng = np.random.RandomState(seed)
    start = rng.rand(n) < 0.2
    start[0] = True
    grp_ord = np.cumsum(start).astype(np.int32)
    mark = rng.rand(n) < 0.3
    val = rng.randint(0, 1 << 20, n).astype(np.int32)
    x = rng.randint(0, 5, n).astype(np.int32)
    return x, start, grp_ord, mark, val


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", SIZES)
def test_seg_sum_matches_pallas_and_xla(n):
    x, start, *_ = _case(n, n)
    tot, rank = segscan.seg_sum(_t(x), _t(start), with_rank=True)
    with jax.enable_x64(True):
        tp, rp = pallas_segscan.seg_sum(
            jnp.asarray(x), jnp.asarray(start), with_rank=True, interpret=True
        )
        tx, rx = crlike_device._seg_sum(jnp.asarray(x), jnp.asarray(start), with_rank=True)
    for want in ((tp, rp), (tx, rx)):
        np.testing.assert_array_equal(tot.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n", SIZES)
def test_seg_reduce_matches_pallas_and_xla(n):
    _, start, grp_ord, mark, val = _case(n, n + 1)
    got = segscan.seg_reduce(_t(val), _t(mark), _t(start), _t(grp_ord))
    with jax.enable_x64(True):
        want_p = pallas_segscan.seg_reduce(
            jnp.asarray(val), jnp.asarray(mark), jnp.asarray(start),
            jnp.asarray(grp_ord), interpret=True,
        )
        want_x = crlike_device._seg_reduce(
            jnp.asarray(val.astype(np.int64)), jnp.asarray(mark),
            jnp.asarray(start), jnp.asarray(grp_ord), val_bits=21,
        )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_x))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("strict", [False, True])
def test_last_marked_matches_pallas_and_xla(n, strict):
    _, start, grp_ord, mark, val = _case(n, n + 2)
    got = segscan.last_marked(_t(val), _t(mark), _t(grp_ord), strict=strict)
    with jax.enable_x64(True):
        want_p = pallas_segscan.last_marked(
            jnp.asarray(val), jnp.asarray(mark), jnp.asarray(grp_ord),
            strict=strict, interpret=True,
        )
        want_x = crlike_device._last_marked(
            jnp.asarray(val.astype(np.int64)), jnp.asarray(mark),
            jnp.asarray(grp_ord), val_bits=21, strict=strict,
        )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_x))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_scan_min_twin_matches_pallas_min_fn(n, reverse):
    """K2's wrapper (its twin, on the CPU) against ``_min_fn`` on the
    input the reference's ``seg_sum`` builds for it: flipped first for
    the reverse scan, padded with I32_MAX to a whole block."""
    rng = np.random.RandomState(n + 7 * reverse)
    # values falling in the scan's direction, so the running min keeps
    # changing, among I32_MAX rows as at seg_sum's segment interiors, and
    # INT_MIN last
    step = rng.randint(0, 1 << 12, n) - (np.arange(n) << 12)
    e = np.where(rng.rand(n) < 0.5, step[::-1] if reverse else step, pallas_segscan.I32_MAX)
    e = e.astype(np.int32)
    e[0 if reverse else n - 1] = pallas_segscan.I32_MIN
    got = segscan.scan_min(_t(e), reverse)
    pad = -n % pallas_segscan.BLOCK
    e2 = np.pad(e[::-1] if reverse else e, (0, pad), constant_values=pallas_segscan.I32_MAX)
    with jax.enable_x64(False):
        out = pallas_segscan._min_fn((n + pad) // pallas_segscan.LANES, interpret=True)(
            jnp.asarray(e2.reshape(-1, pallas_segscan.LANES)))
    want = np.asarray(out).reshape(-1)[:n]
    np.testing.assert_array_equal(got.numpy(), want[::-1] if reverse else want)


@pytest.mark.parametrize("hi,lo", [
    (-(1 << 31), -(1 << 31)), (-1, 0), (0, -1), (7, (1 << 31) - 1),
    ((1 << 31) - 1, (1 << 31) - 1),
])
def test_pair_packing_round_trips_and_orders(hi, lo):
    h = torch.tensor([hi, hi, hi], dtype=torch.int32)
    l = torch.tensor([lo, lo, lo], dtype=torch.int32)
    w = segscan.pack_pair(h, l)
    rh, rl = segscan.unpack_pair(w)
    assert rh.tolist() == h.tolist() and rl.tolist() == l.tolist()
    # signed word order is the lexicographic (hi, lo) order
    rng = np.random.RandomState(hi & 0xFF)
    hs = rng.randint(-3, 3, 500).astype(np.int32)
    ls = rng.randint(-(1 << 31), (1 << 31) - 1, 500).astype(np.int32)
    ws = segscan.pack_pair(_t(hs), _t(ls)).numpy()
    lex = np.lexsort((ls, hs))
    np.testing.assert_array_equal(ws[lex], np.sort(ws))


_I32, _I64, _B = torch.zeros(6, dtype=torch.int32), torch.zeros(6, dtype=torch.int64), torch.zeros(6, dtype=torch.bool)


@pytest.mark.parametrize("call,err", [
    (lambda: segscan.scan_fwd(_I32, _B[:5]), ValueError),
    (lambda: segscan.scan_fwd(_I32.view(2, 3), _B.view(2, 3)), ValueError),
    (lambda: segscan.scan_fwd(_I64, _B), TypeError),
    (lambda: segscan.scan_min(_I32.view(3, 2)), ValueError),
    (lambda: segscan.scan_min(_I64), TypeError),
    (lambda: segscan.scan_lex(_I64.view(2, 3), True), ValueError),
    (lambda: segscan.scan_lex(_I32, True), TypeError),
    (lambda: hamming.neighbor_counts(_I64.view(2, 3), _I64, 8), ValueError),
    (lambda: hamming.neighbor_counts(_I32, _I64, 8), TypeError),
])
def test_wrappers_reject_what_the_kernels_cannot_take(call, err):
    """Shapes and types are checked before any pointer reaches a kernel,
    and the CPU twins are held to the same contract."""
    with pytest.raises(err):
        call()


def _refuse(*_a, **_k):
    raise AssertionError("a twin received a non-CPU tensor")


class _NoKernels(Exception):
    pass


def test_non_cpu_tensors_never_reach_a_twin(monkeypatch):
    """A wrapper takes its twin only for CPU tensors; any other device
    goes to the kernel (here: the kernel loader, stubbed to refuse)."""
    def _load():
        raise _NoKernels

    monkeypatch.setattr(segscan._kernels, "load", _load)
    for name in ("scan_fwd_twin", "scan_min_twin", "scan_lex_twin"):
        monkeypatch.setattr(segscan, name, _refuse)
    for name in ("neighbor_counts_twin", "neighbor_counts_brute_twin", "neighbor_probe_twin"):
        monkeypatch.setattr(hamming, name, _refuse)
    meta = torch.device("meta")
    i32 = torch.empty(8, dtype=torch.int32, device=meta)
    i64 = torch.empty(8, dtype=torch.int64, device=meta)
    st = torch.empty(8, dtype=torch.bool, device=meta)
    calls = [
        lambda: segscan.scan_fwd(i32, st),
        lambda: segscan.scan_min(i32, True),
        lambda: segscan.scan_lex(i64, True, False),
        lambda: hamming.neighbor_counts(i64, i64, 16),
        lambda: hamming.neighbor_counts_brute(i64, i64),
    ]
    for call in calls:
        with pytest.raises((_NoKernels, ValueError)):
            call()
