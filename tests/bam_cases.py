"""Seeded BAM and SAM inputs for ``convert``, written with NumPy and zlib
alone (this module imports neither package).

:func:`make_bam_dataset` writes a 10x v3-shaped alignment file in
transcriptomic coordinates with the CR/UR/AS tags a STARsolo or salmon
run writes, and the files the rest of the RNA path takes:

* ``DIR/aln.bam`` (BGZF, members deflated on a thread pool; or one plain
  gzip member), or ``DIR/aln.sam``;
* ``DIR/permit.txt``: an unfiltered (``-u``) list, a superset of the
  real and ambient barcodes;
* ``DIR/t2g.tsv`` and the 3-column ``DIR/t2g_3col.tsv`` (transcripts
  ``tx_{i}``, four a gene ``g_{i // 4}``, spliced and unspliced in
  turn).

Reads come from real cells (log-normal sizes) and ambient barcodes,
with barcode substitutions (one, so the 1-edit rescue has work, and
two), and carry one to four alignments: the primary, then secondaries
(0x100) that tie its AS or score lower.  The cases convert must handle
are all there, at rates the caller sets: unmapped (0x4) records, some
inside a read's run under its qname, and supplementary (0x800) records
inside runs; reverse-strand alignments; missing AS tags and AS values
stored as C, c, s and i; a B-array tag before AS; reads with one N
(read as A) and two Ns (dropped) in CR or UR; qnames of varying length;
sequences on primary records only.  Records straddle BGZF members:
``block_payload`` need not divide anything.
"""

from __future__ import annotations

import gzip
import json
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_ACGT = np.frombuffer(b"ACGT", np.uint8)
# the core of a BAM record: block_size then the fixed 32 bytes
_CORE = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                  ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"),
                  ("flag", "<u2"), ("l_seq", "<i4"), ("next_ref_id", "<i4"),
                  ("next_pos", "<i4"), ("tlen", "<i4")])
assert _CORE.itemsize == 36
# AS value types: none, then BAM's C, c, s and i (their aux widths)
AS_NONE, AS_C, AS_c, AS_s, AS_i = range(5)
_AS_CODE = b"\0Ccsi"
_AS_WIDTH = np.array([0, 4, 4, 5, 7])
QNAME_MAX = 12  # "r" + up to 10 digits + NUL
# 10x v3 widths, four transcripts a gene, eight ambient barcodes a cell
BC_LEN, UMI_LEN, TXPS_PER_GENE, AMBIENT_FACTOR = 16, 12, 4, 8
READS_PER_BATCH = 200_000  # reads a generation batch (each its own random stream)
DEFLATE_LEVEL = 1  # a fast writer's level; convert's time does not depend on it much

DEFAULT_RATES = {
    "bc_1sub": 0.08,      # reads with one barcode substitution
    "bc_2sub": 0.01,      # and with two
    "reverse": 0.03,      # alignments on the reverse strand
    "tie": 0.4,           # secondaries that tie the primary's AS
    "missing_as": 0.01,   # alignments without AS
    "as_i": 0.3,          # AS stored as i (else the smallest type; s now and then)
    "as_s": 0.05,
    "b_tag": 0.02,        # records with a B-array tag before CR
    "one_n": 0.0007,      # reads with one N in CR or UR
    "two_n": 0.0003,      # and with two
    "unmapped": 0.015,    # unmapped records (a third inside a read's run)
    "supplementary": 0.015,
}


def bgzf_member(payload: bytes, level: int) -> bytes:
    """One BGZF member: a gzip member with the BC subfield."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(payload) + c.flush()
    bsize = 12 + 6 + len(body) + 8
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack("<H", 6)
            + b"BC" + struct.pack("<HH", 2, bsize - 1) + body
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


class BgzfWriter:
    """Cuts a byte stream into members of ``block_payload`` bytes and
    deflates them on ``threads`` threads, in order, then the EOF
    member."""

    def __init__(self, path: Path, block_payload: int = 0xFF00, threads: int = 8):
        self._fh = open(path, "wb")
        self._pool = ThreadPoolExecutor(threads)
        self._pending = []
        self._buf = bytearray()
        self._block = block_payload
        self._max_pending = 4 * threads

    def write(self, data) -> None:
        self._buf += data
        n_full = len(self._buf) // self._block * self._block
        for s in range(0, n_full, self._block):
            self._submit(bytes(self._buf[s:s + self._block]))
        del self._buf[:n_full]

    def _submit(self, payload: bytes) -> None:
        self._pending.append(self._pool.submit(bgzf_member, payload, DEFLATE_LEVEL))
        while len(self._pending) > self._max_pending:
            self._fh.write(self._pending.pop(0).result())

    def close(self) -> None:
        if self._buf:
            self._submit(bytes(self._buf))
        for f in self._pending:
            self._fh.write(f.result())
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self._pool.shutdown()


def bam_header(ref_names) -> bytes:
    text = b"@HD\tVN:1.6\tSO:unsorted\n"
    parts = [b"BAM\x01", struct.pack("<i", len(text)), text, struct.pack("<i", len(ref_names))]
    for n in ref_names:
        nb = n.encode() + b"\0"
        parts += [struct.pack("<i", len(nb)), nb, struct.pack("<i", 1500)]
    return b"".join(parts)


# each byte of a 2-bit packed code as its four bases
_BYTE_BASES = _ACGT[(np.arange(256)[:, None] >> np.array([6, 4, 2, 0])) & 3]


def _ascii(codes: np.ndarray, length: int) -> np.ndarray:
    """2-bit packed codes -> (n, length) ASCII bytes, first base first."""
    nb = (length + 3) // 4
    le = np.ascontiguousarray(codes, "<u8").view(np.uint8).reshape(-1, 8)
    return _BYTE_BASES[le[:, nb - 1::-1]].reshape(-1, 4 * nb)[:, 4 * nb - length:]


def _substitute(rng, codes: np.ndarray, which: np.ndarray, length: int) -> None:
    """One base substitution, at a random position, in ``codes[which]``."""
    idx = np.flatnonzero(which)
    shift = (2 * rng.randint(0, length, idx.size)).astype(np.uint64)
    delta = rng.randint(1, 4, idx.size).astype(np.uint64)
    codes[idx] ^= delta << shift


class _Reads:
    """The per-read table: cell barcode, UMI, gene, alignment count."""

    def __init__(self, rng, n_reads, n_cells, n_genes, rates):
        bc_mask = np.uint64((1 << (2 * BC_LEN)) - 1)
        n_ambient = AMBIENT_FACTOR * n_cells
        pool = np.unique(rng.randint(0, 1 << 62, size=int(2.4 * (n_cells + n_ambient)),
                                     dtype=np.int64).astype(np.uint64) & bc_mask)
        perm = rng.permutation(pool.size)
        self.permit = pool
        real_w = np.exp(rng.normal(0.0, 0.8, n_cells))
        amb_w = rng.exponential(1.0, n_ambient)
        w = np.concatenate([0.92 * real_w / real_w.sum(), 0.08 * amb_w / amb_w.sum()])
        bcs = pool[perm[:n_cells + n_ambient]]
        self.bc = bcs[rng.choice(bcs.size, size=n_reads, p=w)]
        one = rng.rand(n_reads) < rates["bc_1sub"] + rates["bc_2sub"]
        _substitute(rng, self.bc, one, BC_LEN)
        two = one & (rng.rand(n_reads) < rates["bc_2sub"] / max(rates["bc_1sub"]
                                                                 + rates["bc_2sub"], 1e-12))
        _substitute(rng, self.bc, two, BC_LEN)
        self.bc_errors = (int(one.sum() - two.sum()), int(two.sum()))
        self.umi = rng.randint(0, 1 << 62, size=n_reads, dtype=np.int64).astype(np.uint64) \
            & np.uint64((1 << (2 * UMI_LEN)) - 1)
        gw = 1.0 / np.arange(1, n_genes + 1) ** 0.9
        self.gene = rng.choice(n_genes, size=n_reads, p=gw / gw.sum())
        self.n_aln = rng.choice(4, size=n_reads, p=[0.45, 0.3, 0.15, 0.1]) + 1
        # Ns: kind 1 one N, 2 two Ns; in the barcode or the UMI
        u = rng.rand(n_reads)
        self.n_kind = np.where(u < rates["one_n"], 1,
                               np.where(u < rates["one_n"] + rates["two_n"], 2, 0))
        self.n_in_umi = rng.rand(n_reads) < 0.5


def _records(rng, reads, lo, hi, n_genes, read_len, rates):
    """The records of reads [lo, hi) in file order, as BAM bytes and as
    per-record columns (for SAM)."""
    n_aln = reads.n_aln[lo:hi]
    nr = hi - lo
    read = np.repeat(np.arange(nr), n_aln)
    first = np.concatenate([[0], np.cumsum(n_aln)[:-1]])
    k = np.arange(read.size) - first[read]
    gene = reads.gene[lo:hi][read]
    # the primary on the read's gene; secondaries on its other transcripts
    # or its paralog (gene ^ 1)
    other = np.where(rng.rand(read.size) < 0.5, gene, (gene ^ 1) % n_genes)
    tid = np.where(k == 0, gene, other) * TXPS_PER_GENE + (k + rng.randint(0, 2, read.size)) \
        % TXPS_PER_GENE
    flag = np.where(k == 0, 0, 0x100) | np.where(rng.rand(read.size) < rates["reverse"], 0x10, 0)
    base = rng.randint(-20, 120, nr)
    as_val = np.where((k == 0) | (rng.rand(read.size) < rates["tie"]), base[read],
                      base[read] - rng.randint(1, 30, read.size))
    # skipped records: supplementary ones inside runs, unmapped ones
    # inside runs (the read's qname) or between reads (a qname of their own)
    n_supp = rng.binomial(read.size, rates["supplementary"])
    n_unm = rng.binomial(read.size, rates["unmapped"])
    n_inside = n_unm // 3
    at = np.concatenate([rng.randint(0, read.size, n_supp + n_inside),
                         first[rng.randint(0, nr, n_unm - n_inside)] - 0.5])
    ins_read = np.concatenate([read[at[:n_supp + n_inside].astype(np.int64)],
                               -1 - np.arange(n_unm - n_inside)])
    ins_flag = np.concatenate([np.full(n_supp, 0x800), np.full(n_unm, 0x4)])
    ins_tid = np.concatenate([gene[at[:n_supp].astype(np.int64)] * TXPS_PER_GENE,
                              np.full(n_unm, -1)])
    key = np.concatenate([np.arange(read.size, dtype=np.float64), at + 0.25])
    order = np.argsort(key, kind="stable")
    rid = np.concatenate([read, ins_read])[order]
    flag = np.concatenate([flag, ins_flag])[order]
    tid = np.concatenate([tid, ins_tid])[order].astype(np.int32)
    as_val = np.concatenate([as_val, rng.randint(-5, 60, ins_flag.size)])[order]
    n = rid.size
    own = rid >= 0  # the unmapped reads between reads get their own barcodes
    src = np.where(own, rid, rng.randint(0, nr, n)) + lo

    bc = _ascii(reads.bc[src], BC_LEN)
    umi = _ascii(reads.umi[src], UMI_LEN)
    nk = np.where(own, reads.n_kind[src], 0)
    in_umi = reads.n_in_umi[src]
    for n_count in (1, 2):
        for target, width, sel in ((bc, BC_LEN, ~in_umi), (umi, UMI_LEN, in_umi)):
            rows = np.flatnonzero((nk >= n_count) & sel)
            # the read's Ns sit at positions fixed by its number
            pos = (src[rows] * 7 + 3 * (n_count - 1)) % width
            target[rows, pos] = ord("N")
    qname_num = np.where(own, rid + lo, 10**9 + rng.randint(0, 10**9, n))
    digits = np.frombuffer(qname_num.astype("S10").tobytes(), np.uint8).reshape(n, 10)
    qlen = 1 + (digits != 0).sum(axis=1)  # "r" + digits
    as_type = np.where(as_val < 0, AS_c, AS_C)
    as_type = np.where(rng.rand(n) < rates["as_s"], AS_s, as_type)
    as_type = np.where(rng.rand(n) < rates["as_i"], AS_i, as_type)
    as_type = np.where((as_val < -128) | (as_val > 255), AS_i, as_type)
    as_type = np.where(rng.rand(n) < rates["missing_as"], AS_NONE, as_type)
    b_tag = rng.rand(n) < rates["b_tag"]
    mapped = (flag & 0x4) == 0
    has_seq = (flag & 0x900) == 0
    cols = {"qname": qname_num, "flag": flag, "tid": tid, "bc": bc, "umi": umi,
            "as_val": as_val, "as_type": as_type, "has_seq": has_seq}
    return _encode(rng, cols, qlen, digits, mapped, b_tag, read_len), cols


def _encode(rng, cols, qlen, digits, mapped, b_tag, read_len) -> bytes:
    """BAM bytes of the records: each field written at its widest into
    its columns of one matrix, with a length a record; one boolean mask
    then joins each record's bytes."""
    n = qlen.size
    seq_b, seq_q = (read_len + 1) // 2, read_len
    l_seq = np.where(cols["has_seq"], read_len, 0)
    bc, umi = cols["bc"], cols["umi"]
    widths = (36, QNAME_MAX, 4, seq_b, seq_q, 4, 12, bc.shape[1] + 4, umi.shape[1] + 4, 7)
    lens = (np.full(n, 36), qlen + 1, np.where(mapped, 4, 0), np.where(l_seq > 0, seq_b, 0),
            np.where(l_seq > 0, seq_q, 0), np.full(n, 4), np.where(b_tag, 12, 0),
            np.full(n, widths[7]), np.full(n, widths[8]), _AS_WIDTH[cols["as_type"]])
    at = np.concatenate([[0], np.cumsum(widths)])
    mat = np.zeros((n, int(at[-1])), np.uint8)
    mask = np.zeros(mat.shape, bool)
    for j, ln in enumerate(lens):
        mask[:, at[j]:at[j + 1]] = np.arange(widths[j]) < ln[:, None]
    core = np.zeros(n, _CORE)
    core["block_size"] = sum(lens) - 4
    core["ref_id"] = cols["tid"]
    core["pos"] = np.where(mapped, 100, -1)
    core["l_read_name"] = qlen + 1
    core["mapq"] = np.where(mapped, 255, 0)
    core["bin"] = 4680
    core["n_cigar"] = np.where(mapped, 1, 0)
    core["flag"] = cols["flag"]
    core["l_seq"] = l_seq
    core["next_ref_id"] = -1
    core["next_pos"] = -1
    mat[:, :36] = core.view(np.uint8).reshape(n, 36)
    mat[:, at[1]] = ord("r")
    mat[:, at[1] + 1:at[1] + 11] = digits
    mat[:, at[2]:at[3]] = np.frombuffer(struct.pack("<I", max(read_len, 1) << 4), np.uint8)
    if read_len:
        mat[:, at[3]:at[4]] = rng.randint(0, 256, (n, seq_b))
        mat[:, at[4]:at[5]] = rng.randint(2, 42, (n, seq_q))
    mat[:, at[5]:at[6]] = np.frombuffer(b"NHC\x01", np.uint8)
    mat[:, at[6]:at[7]] = np.frombuffer(b"ZBBS" + struct.pack("<iHH", 2, 7, 9), np.uint8)
    for j, tag, seq in ((7, b"CRZ", bc), (8, b"URZ", umi)):
        mat[:, at[j]:at[j] + 3] = np.frombuffer(tag, np.uint8)
        mat[:, at[j] + 3:at[j + 1] - 1] = seq
    mat[:, at[9]:at[9] + 2] = np.frombuffer(b"AS", np.uint8)
    mat[:, at[9] + 2] = np.frombuffer(_AS_CODE, np.uint8)[cols["as_type"]]
    mat[:, at[9] + 3:at[10]] = np.asarray(cols["as_val"], "<i4")[:, None].view(np.uint8)
    return mat[mask].tobytes()


def _sam_lines(cols, names) -> str:
    lines = []
    for i in range(cols["flag"].size):
        tid = int(cols["tid"][i])
        tags = [f"CR:Z:{cols['bc'][i].tobytes().decode()}",
                f"UR:Z:{cols['umi'][i].tobytes().decode()}"]
        if cols["as_type"][i] != AS_NONE:
            tags.append(f"AS:i:{int(cols['as_val'][i])}")
        lines.append("\t".join([
            f"r{int(cols['qname'][i])}", str(int(cols["flag"][i])),
            names[tid] if tid >= 0 else "*", "101" if tid >= 0 else "0", "255",
            "4M" if tid >= 0 else "*", "*", "0", "0", "*", "*", *tags]) + "\n")
    return "".join(lines)


def make_bam_dataset(d: Path, seed: int, n_alignments: int, n_cells: int = 10_000,
                     n_genes: int = 20_000, read_len: int = 0, fmt: str = "bgzf",
                     block_payload: int = 0xFF00, threads: int = 8,
                     rates: dict | None = None) -> dict:
    """Write the dataset into ``d`` (``fmt``: ``bgzf`` or ``gzip`` for
    ``aln.bam``, ``sam`` for ``aln.sam``): about ``n_alignments``
    records, ``read_len`` bases on each primary record, BGZF members of
    ``block_payload`` bytes deflated on ``threads`` threads, the case
    ``rates`` over DEFAULT_RATES; returns its statistics."""
    t0 = time.perf_counter()
    rates = {**DEFAULT_RATES, **(rates or {})}
    rng = np.random.RandomState(seed)
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    mean_aln = 1.9 * (1 + rates["unmapped"] + rates["supplementary"])
    n_reads = max(1, int(n_alignments / mean_aln))
    reads = _Reads(rng, n_reads, n_cells, n_genes, rates)
    names = [f"tx_{i}" for i in range(n_genes * TXPS_PER_GENE)]
    path = d / ("aln.sam" if fmt == "sam" else "aln.bam")
    if fmt == "bgzf":
        sink = BgzfWriter(path, block_payload, threads=threads)
    elif fmt == "gzip":
        sink = gzip.open(path, "wb", compresslevel=DEFLATE_LEVEL)
    else:
        sink = open(path, "w")
        sink.write("@HD\tVN:1.6\tSO:unsorted\n" + "".join(
            f"@SQ\tSN:{n}\tLN:1500\n" for n in names))
    if fmt != "sam":
        sink.write(bam_header(names))
    def batch(lo):
        # each batch draws from its own stream, so batches can run at once
        data, cols = _records(np.random.RandomState([seed, 1 + lo // READS_PER_BATCH]), reads,
                              lo, min(lo + READS_PER_BATCH, n_reads), n_genes, read_len, rates)
        if fmt == "sam":
            data = _sam_lines(cols, names)
        return data, cols["flag"].size, int(((cols["flag"] & 0x804) != 0).sum())

    n_rec = n_skip = raw = 0
    los = list(range(0, n_reads, READS_PER_BATCH))
    with ThreadPoolExecutor(threads) as pool:
        for w in range(0, len(los), threads):  # a window of batches at a time
            for data, nr, ns in pool.map(batch, los[w:w + threads]):
                n_rec, n_skip, raw = n_rec + nr, n_skip + ns, raw + len(data)
                sink.write(data)
    sink.close()
    with open(d / "permit.txt", "w") as fh:
        fh.write("".join(row.tobytes().decode() + "\n"
                         for row in _ascii(np.sort(reads.permit), BC_LEN)))
    n_txps = len(names)
    (d / "t2g.tsv").write_text("".join(f"tx_{i}\tg_{i // TXPS_PER_GENE}\n"
                                       for i in range(n_txps)))
    (d / "t2g_3col.tsv").write_text("".join(
        f"tx_{i}\tg_{i // TXPS_PER_GENE}\t{'S' if (i % TXPS_PER_GENE) % 2 == 0 else 'U'}\n"
        for i in range(n_txps)))
    stats = {
        "seconds": time.perf_counter() - t0, "path": str(path), "bytes": path.stat().st_size,
        "uncompressed_bytes": raw, "records": n_rec, "reads": n_reads,
        "skipped_records": n_skip, "bc_1sub_reads": reads.bc_errors[0],
        "bc_2sub_reads": reads.bc_errors[1], "one_n_reads": int((reads.n_kind == 1).sum()),
        "two_n_reads": int((reads.n_kind == 2).sum()), "permit_entries": int(reads.permit.size),
    }
    (d / "bam_stats.json").write_text(json.dumps(stats))
    return stats
