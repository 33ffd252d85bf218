"""convert: BAM/SAM in transcriptomic coordinates to RAD (port of
``alevin_fry_tpu/pipeline/convert.py``, src/convert.rs:167-594).

Host and native code, as in the reference: the native scanner
(``radc_bam_scan`` in csrc/libradc.so) walks the decompressed BAM
records and returns NumPy columns (flag, ref id, 2-bit packed CR and UR,
AS, whether the qname equals the previous kept record's); BGZF members
inflate on the native thread pool (``radc_bgzf_inflate``).  Without the
library a pure-Python scanner with the same contract reads a plain
gzip stream.  SAM lines are parsed in Python into the same columns, so
both inputs share one vectorized grouping and chunking engine.

Behaviour (the reference's):

* consecutive alignments that share a qname form one read record; runs
  are judged between *kept* records only, so a skipped unmapped (0x4)
  or supplementary (0x800) record does not break a run, across scan
  batches and BGZF members alike;
* the barcode and UMI come from the CR and UR tags, 2-bit packed with
  one N replaced by A; a read whose barcode or UMI holds a second N is
  dropped whole (the JAX package's rule; convert.rs:525-552 can leak the
  previous read's alignments there);
* with ``--filter_best`` only the alignments that tie their read's best
  AS are kept (convert.rs:461-468); a missing AS scores 1;
* the forward orientation sets the high bit of the u32 ref id
  (convert.rs:441-444);
* records are written in chunks of about 10,000 reads, and the header's
  chunk count is patched in at the end (convert.rs:584-590);
* the writer is made at the first kept read, whose CR and UR lengths
  set the record tags' widths; an input without one raises ValueError,
  as does a corrupt BAM record, BGZF member or CRC.

``-t`` sets the native thread pool (the inflate) through the CLI;
``bam2rad`` takes ``num_threads`` and ignores it, as the reference does.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import spans
from ..ops.barcodes import pack_seq
from ..radz import RadHeader, RadPrelude, RadWriter
from ..radz import _native as native
from ..radz import types as rt
from ..radz.types import SECTION_ALN, SECTION_FILE, SECTION_READ, RadType, TagSection
from .logging_ import get_logger

log = get_logger("convert")

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SUPPLEMENTARY = 0x800
FLAG_SKIP = FLAG_UNMAPPED | FLAG_SUPPLEMENTARY
MASK_LOWER_31 = 0x8000_0000
BUF_LIMIT = 10_000  # reads a chunk
AS_MISSING = np.int32(np.iinfo(np.int32).min)
_SCAN_BUF = 1 << 22  # decompressed bytes a scan batch
_SAM_BATCH = 1 << 16  # SAM lines a batch
# the BAM aux value types that hold one number, as struct formats
_AUX_NUMBER = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}
_COLUMNS = ("flags", "tid", "bc", "bclen", "bc_valid", "umi", "umilen", "umi_valid", "as",
            "same_qname")


def _pack_with_n(seq: str) -> Optional[int]:
    """Pack, the first N read as A; None if an N remains
    (convert.rs:525-531)."""
    s = seq.replace("N", "A", 1)
    if "N" in s:
        return None
    return pack_seq(s)


def _bam_scan_py(buf: bytes, qname_state: np.ndarray):
    """The pure-Python scanner, with the native scanner's contract: the
    same columns, the qname state carried in ``qname_state``, and the
    bytes of the complete records consumed."""
    pos, n = 0, len(buf)
    recs: List[tuple] = []
    prev_len = int(qname_state[:2].view(np.uint16)[0])
    prev_q = qname_state[2:2 + prev_len].tobytes()
    while pos + 4 <= n:
        (block_size,) = struct.unpack_from("<I", buf, pos)
        if block_size < 32:
            raise ValueError("structurally invalid BAM record")
        if pos + 4 + block_size > n:
            break
        r = buf[pos + 4:pos + 4 + block_size]
        tid, _pos, l_qname, _mapq, _bin, n_cigar, flag, l_read = struct.unpack_from(
            "<iiBBHHHi", r, 0)
        off = 32 + l_qname + 4 * n_cigar + (l_read + 1) // 2 + l_read
        if l_read < 0 or off > block_size:
            raise ValueError("structurally invalid BAM record")
        qname = r[32:32 + max(l_qname - 1, 0)]
        same = qname == prev_q
        if not flag & FLAG_SKIP:
            prev_q = qname
        cr, ur, as_score = _parse_bam_tags_py(r[off:])
        b = _pack_with_n(cr) if cr is not None else None
        u = _pack_with_n(ur) if ur is not None else None
        recs.append((
            flag, tid,
            b or 0, len(cr) if cr is not None else -1, b is not None,
            u or 0, len(ur) if ur is not None else -1, u is not None,
            as_score if as_score is not None else int(AS_MISSING), same,
        ))
        pos += 4 + block_size
    qname_state[:] = 0
    qname_state[:2] = np.frombuffer(np.uint16(len(prev_q)).tobytes(), np.uint8)
    qname_state[2:2 + len(prev_q)] = np.frombuffer(prev_q, np.uint8)
    a = np.asarray(recs, object) if recs else np.zeros((0, len(_COLUMNS)), object)
    dtypes = (np.uint16, np.int32, np.uint64, np.int32, bool, np.uint64, np.int32, bool,
              np.int32, bool)
    return {k: a[:, i].astype(t) for i, (k, t) in enumerate(zip(_COLUMNS, dtypes))}, pos


def _parse_bam_tags_py(buf: bytes):
    """CR and UR (strings) and AS (an integer) from a BAM record's aux
    fields; an unknown value type ends the walk, as in the native
    scanner."""
    cr = ur = as_score = None
    pos, n = 0, len(buf)
    while pos + 3 <= n:
        tag = buf[pos:pos + 2].decode("ascii", "replace")
        vt = chr(buf[pos + 2])
        pos += 3
        if vt == "A":
            val = chr(buf[pos])
            pos += 1
        elif vt in _AUX_NUMBER:
            val = struct.unpack_from(_AUX_NUMBER[vt], buf, pos)[0]
            pos += struct.calcsize(_AUX_NUMBER[vt])
        elif vt in ("Z", "H"):
            end = buf.index(b"\x00", pos)
            val = buf[pos:end].decode("ascii", "replace")
            pos = end + 1
        elif vt == "B":
            sub = chr(buf[pos])
            cnt = struct.unpack_from("<i", buf, pos + 1)[0]
            if cnt < 0:
                raise ValueError("structurally invalid BAM record")
            pos += 5 + cnt * struct.calcsize(_AUX_NUMBER[sub])
            val = None
        else:
            break
        if tag == "CR" and isinstance(val, str):
            cr = val
        elif tag == "UR" and isinstance(val, str):
            ur = val
        elif tag == "AS" and isinstance(val, int):
            as_score = int(val)
    return cr, ur, as_score


class _BgzfReader:
    """Forward-only BGZF reader.  BAM's container is BGZF: independent
    gzip members of at most 64 KiB, each with its compressed size in a
    BC extra subfield.  The member boundaries are found here in Python,
    one file chunk at a time; the payloads inflate on the native thread
    pool, which checks each member's size and CRC32 (the reference's
    multithreaded reader, convert.rs:205-220)."""

    def __init__(self, path, chunk_bytes: int = 8 << 20):
        self._fh = open(path, "rb")
        self._chunk = chunk_bytes
        self._carry = b""
        self._out = b""
        self._pos = 0
        self._eof = False

    @staticmethod
    def sniff(head: bytes) -> bool:
        """True when ``head`` (18 bytes or more) starts a BGZF member."""
        if len(head) < 18 or head[:2] != b"\x1f\x8b" or head[2] != 8 or not head[3] & 4:
            return False
        xlen = int.from_bytes(head[10:12], "little")
        extra = head[12:12 + min(xlen, len(head) - 12)]
        pos = 0
        while pos + 4 <= len(extra):
            slen = int.from_bytes(extra[pos + 2:pos + 4], "little")
            if extra[pos] == 66 and extra[pos + 1] == 67 and slen == 2:
                return True
            pos += 4 + slen
        return False

    @staticmethod
    def _scan_blocks(raw: bytes):
        """The complete members in ``raw``: their payload offsets and
        lengths, inflated sizes, CRCs, and the bytes they span."""
        offs, lens, isizes, crcs = [], [], [], []
        pos = 0
        while pos + 18 <= len(raw):
            if raw[pos:pos + 2] != b"\x1f\x8b" or raw[pos + 2] != 8:
                raise ValueError("corrupt BGZF member header")
            xlen = int.from_bytes(raw[pos + 10:pos + 12], "little")
            extra = raw[pos + 12:pos + 12 + xlen]
            if len(extra) < xlen:
                break  # the header runs on into the next chunk
            bsize, e = None, 0
            while e + 4 <= xlen:
                slen = int.from_bytes(extra[e + 2:e + 4], "little")
                if extra[e] == 66 and extra[e + 1] == 67 and slen == 2:
                    bsize = int.from_bytes(extra[e + 4:e + 6], "little") + 1
                e += 4 + slen
            if bsize is None:
                raise ValueError("gzip member without a BGZF BC subfield")
            if pos + bsize > len(raw):
                break
            offs.append(pos + 12 + xlen)
            lens.append(bsize - 12 - xlen - 8)
            crcs.append(int.from_bytes(raw[pos + bsize - 8:pos + bsize - 4], "little"))
            isizes.append(int.from_bytes(raw[pos + bsize - 4:pos + bsize], "little"))
            pos += bsize
        return offs, lens, isizes, crcs, pos

    def _fill(self) -> None:
        data = self._fh.read(self._chunk)
        raw = self._carry + data
        if not data:
            self._eof = True
            if raw:
                raise ValueError("truncated BGZF stream")
            return
        offs, lens, isizes, crcs, consumed = self._scan_blocks(raw)
        self._carry = raw[consumed:]
        if not offs:
            return
        out_offs = np.zeros(len(isizes) + 1, np.int64)
        np.cumsum(np.asarray(isizes, np.int64), out=out_offs[1:])
        out = np.empty(int(out_offs[-1]), np.uint8)
        native.bgzf_inflate(np.frombuffer(raw, np.uint8), np.asarray(offs, np.int64),
                            np.asarray(lens, np.int64), out_offs[:-1],
                            np.asarray(isizes, np.int64), out, np.asarray(crcs, np.uint32))
        self._out = self._out[self._pos:] + out.tobytes()
        self._pos = 0

    def read(self, n: int) -> bytes:
        while len(self._out) - self._pos < n and not self._eof:
            self._fill()
        b = self._out[self._pos:self._pos + n]
        self._pos += len(b)
        return b

    def close(self) -> None:
        self._fh.close()


def _open_bam_stream(path: Path):
    """The threaded BGZF reader when the native library is loaded and the
    file is BGZF; a plain ``gzip`` stream otherwise (a BAM in one gzip
    member decodes the same, on one thread)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(64)
    except OSError:
        head = b""
    if native.available() and _BgzfReader.sniff(head):
        return _BgzfReader(path)
    return gzip.open(path, "rb")


def iter_bam_columns(path: Path) -> Tuple[List[str], Iterator[dict]]:
    """The reference names and a generator of column batches of a BAM
    file (the native scanner when the library is loaded, else the
    Python one: the same columns)."""
    fh = _open_bam_stream(path)
    if fh.read(4) != b"BAM\x01":
        fh.close()
        raise ValueError(f"{path} is not a BAM file")
    (l_text,) = struct.unpack("<i", fh.read(4))
    fh.read(l_text)
    (n_ref,) = struct.unpack("<i", fh.read(4))
    names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", fh.read(4))
        names.append(fh.read(l_name)[:-1].decode())
        fh.read(4)  # l_ref

    def gen():
        scan = native.bam_scan if native.available() else _bam_scan_py
        qstate = np.zeros(258, np.uint8)
        carry = b""
        while True:
            data = fh.read(_SCAN_BUF)
            if not data:
                break
            buf = carry + data
            cols, consumed = scan(buf, qstate)
            carry = buf[consumed:]
            if cols["flags"].size:
                yield cols
        fh.close()
        if carry:
            raise ValueError("truncated BAM record at end of file")

    return names, gen()


def iter_sam_columns(path: Path) -> Tuple[List[str], Iterator[dict]]:
    """The reference names and column batches of a SAM file (the BAM
    scanner's columns)."""
    fh = open(path, "r")
    names: List[str] = []
    first_aln = None
    for line in fh:
        if line.startswith("@"):
            if line.startswith("@SQ"):
                names += [tok[3:] for tok in line.rstrip("\n").split("\t")[1:]
                          if tok.startswith("SN:")]
            continue
        first_aln = line
        break
    name_to_id = {n: i for i, n in enumerate(names)}

    def gen():
        prev_qname = None  # the last kept record's qname, across batches

        def emit(lines):
            nonlocal prev_qname
            n = len(lines)
            cols = {
                "flags": np.empty(n, np.uint16), "tid": np.empty(n, np.int32),
                "bc": np.zeros(n, np.uint64), "bclen": np.full(n, -1, np.int32),
                "bc_valid": np.zeros(n, bool), "umi": np.zeros(n, np.uint64),
                "umilen": np.full(n, -1, np.int32), "umi_valid": np.zeros(n, bool),
                "as": np.full(n, AS_MISSING, np.int32), "same_qname": np.zeros(n, bool),
            }
            for i, line in enumerate(lines):
                toks = line.rstrip("\n").split("\t")
                qname, flag = toks[0], int(toks[1])
                cols["flags"][i] = flag
                cols["tid"][i] = name_to_id.get(toks[2], -1)
                cols["same_qname"][i] = qname == prev_qname
                if not flag & FLAG_SKIP:
                    prev_qname = qname
                for t in toks[11:]:
                    if t.startswith(("CR:Z:", "UR:Z:")):
                        key = "bc" if t[0] == "C" else "umi"
                        cols[key + "len"][i] = len(t) - 5
                        packed = _pack_with_n(t[5:])
                        if packed is not None:
                            cols[key][i] = packed
                            cols[key + "_valid"][i] = True
                    elif t.startswith("AS:i:"):
                        cols["as"][i] = int(t[5:])
            return cols

        pending = [] if first_aln is None else [first_aln]
        for line in fh:
            pending.append(line)
            if len(pending) >= _SAM_BATCH:
                yield emit(pending)
                pending = []
        fh.close()
        if pending:
            yield emit(pending)

    return names, gen()


class _GroupEmitter:
    """Vectorized qname-run grouping and chunked RAD writing.

    Takes column batches; the group that may go on into the next batch
    is carried as ``_pend`` and finalized when the next group starts (or
    at close), as the reference's streaming loop does
    (convert.rs:420-560), without per-record Python work."""

    def __init__(self, out_fh, ref_names: List[str], filter_best: bool):
        self.out_fh = out_fh
        self.ref_names = ref_names
        self.filter_best = filter_best
        self.writer: Optional[RadWriter] = None
        self.total_records = 0
        self.n_in = 0
        self._pend: Optional[dict] = None
        # the chunk's groups: barcodes, UMIs, alignment counts, flat refs
        self._g_bc: List[np.ndarray] = []
        self._g_umi: List[np.ndarray] = []
        self._g_cnt: List[np.ndarray] = []
        self._refs: List[np.ndarray] = []
        self._n_groups = 0

    def _ensure_writer(self, bclen: int, umilen: int) -> None:
        if self.writer is not None:
            return
        ft = TagSection(SECTION_FILE)
        ft.add("cblen", RadType(rt.U16))
        ft.add("ulen", RadType(rt.U16))
        rtg = TagSection(SECTION_READ)
        rtg.add("b", RadType(rt.int_type_for_seq_len(bclen)))
        rtg.add("u", RadType(rt.int_type_for_seq_len(umilen)))
        at = TagSection(SECTION_ALN)
        at.add("compressed_ori_refid", RadType(rt.U32))
        prelude = RadPrelude(RadHeader(is_paired=0, ref_names=self.ref_names, num_chunks=0),
                             ft, rtg, at)
        self.writer = RadWriter(self.out_fh, prelude, {"cblen": bclen, "ulen": umilen})

    def _flush_chunk(self) -> None:
        if self._n_groups == 0:
            return
        cnts = np.concatenate(self._g_cnt)
        refs = np.concatenate(self._refs)
        offs = np.zeros(cnts.size + 1, np.int64)
        np.cumsum(cnts, out=offs[1:])
        self.writer.write_chunk(
            {"b": np.concatenate(self._g_bc), "u": np.concatenate(self._g_umi)}, offs,
            (refs & np.uint64(0x7FFFFFFF)).astype(np.uint32),
            (refs & np.uint64(MASK_LOWER_31)) != 0,
        )
        self._g_bc, self._g_umi, self._g_cnt, self._refs = [], [], [], []
        self._n_groups = 0

    def _append_groups(self, bc, umi, cnt, refs) -> None:
        self._g_bc.append(np.ascontiguousarray(bc, np.uint64))
        self._g_umi.append(np.ascontiguousarray(umi, np.uint64))
        self._g_cnt.append(np.ascontiguousarray(cnt, np.int64))
        self._refs.append(np.ascontiguousarray(refs, np.uint64))
        self._n_groups += int(bc.size)
        self.total_records += int(bc.size)
        if self._n_groups >= BUF_LIMIT:
            self._flush_chunk()

    def _finalize_pend(self) -> None:
        p, self._pend = self._pend, None
        if p is None or not p["valid"]:
            return
        refs = np.concatenate(p["refs"])
        if self.filter_best:
            scores = np.concatenate(p["scores"])
            refs = refs[scores >= scores.max()]
        if refs.size == 0:
            return
        self._ensure_writer(p["bclen"], p["umilen"])
        self._append_groups(np.asarray([p["bc"]], np.uint64), np.asarray([p["umi"]], np.uint64),
                            np.asarray([refs.size], np.int64), refs)

    def feed(self, cols: dict) -> None:
        self.n_in += int(cols["flags"].size)
        k = np.flatnonzero((cols["flags"] & FLAG_SKIP) == 0)
        if k.size == 0:
            return
        fwd = (cols["flags"][k] & FLAG_REVERSE) == 0
        enc = cols["tid"][k].astype(np.uint64)
        enc[fwd] |= np.uint64(MASK_LOWER_31)
        if self.filter_best:
            a = cols["as"][k]
            scores = np.where(a == AS_MISSING, np.int32(1), a)
        else:
            scores = np.ones(k.size, np.int32)
        starts = np.flatnonzero(~cols["same_qname"][k])
        if self._pend is None and (starts.size == 0 or starts[0] != 0):
            # no carried group to go on with: the batch starts a group
            starts = np.concatenate([[0], starts]).astype(np.int64)
        if starts.size == 0:
            # the whole batch goes on with the pending group
            self._pend["refs"].append(enc)
            self._pend["scores"].append(scores)
            return
        s0 = int(starts[0])
        if s0 > 0:
            self._pend["refs"].append(enc[:s0])
            self._pend["scores"].append(scores[:s0])
        self._finalize_pend()
        if starts.size > 1:  # groups [starts[i], starts[i + 1]) end in this batch
            self._emit_complete(cols, k, enc, scores, starts[:-1].astype(np.int64),
                                int(starts[-1]))
        sl = int(starts[-1])  # the last group becomes the pending one
        fi = int(k[sl])
        bcl, uml = int(cols["bclen"][fi]), int(cols["umilen"][fi])
        if bcl < 0 or uml < 0:
            raise ValueError("Input record missing CR or UR tag!")
        self._pend = {
            "bc": int(cols["bc"][fi]), "umi": int(cols["umi"][fi]), "bclen": bcl,
            "umilen": uml, "valid": bool(cols["bc_valid"][fi]) and bool(cols["umi_valid"][fi]),
            "refs": [enc[sl:]], "scores": [scores[sl:]],
        }

    def _emit_complete(self, cols, k, enc, scores, starts, end) -> None:
        """Emit the groups that end in this batch (group g spans
        [starts[g], starts[g + 1]), the last one up to ``end``) in one
        vectorized pass."""
        firsts = k[starts]
        bclen, umilen = cols["bclen"][firsts], cols["umilen"][firsts]
        if np.any(bclen < 0) or np.any(umilen < 0):
            raise ValueError("Input record missing CR or UR tag!")
        valid_g = cols["bc_valid"][firsts] & cols["umi_valid"][firsts]
        bounds = np.concatenate([starts, [end]]).astype(np.int64)
        gid = np.repeat(np.arange(starts.size), np.diff(bounds))
        seg_refs = enc[bounds[0]:end]
        seg_scores = scores[bounds[0]:end]
        rel = bounds - bounds[0]
        if self.filter_best:
            keep = seg_scores >= np.maximum.reduceat(seg_scores, rel[:-1])[gid]
        else:
            keep = np.ones(seg_scores.size, bool)
        keep &= valid_g[gid]
        cnt = np.add.reduceat(keep, rel[:-1]) if keep.size else np.zeros(0, np.int64)
        sel_g = valid_g & (cnt > 0)
        if not np.any(sel_g):
            return
        if self.writer is None:
            fv = int(np.flatnonzero(sel_g)[0])
            self._ensure_writer(int(bclen[fv]), int(umilen[fv]))
        self._append_groups(cols["bc"][firsts][sel_g], cols["umi"][firsts][sel_g],
                            cnt[sel_g].astype(np.int64), seg_refs[keep])

    def close(self) -> int:
        self._finalize_pend()
        if self.writer is None:
            raise ValueError("bam file had no records!")
        self._flush_chunk()
        return self.writer.finalize()


def bam2rad(input_file: Path, rad_file: Path, num_threads: int = 1,
            filter_best: bool = False) -> None:
    """Convert ``input_file`` (``.bam`` or ``.sam``) into the RAD file
    ``rad_file``.  ``num_threads`` is accepted and unused, as in the
    reference (the CLI's ``-t`` sizes the native thread pool)."""
    input_file = Path(input_file)
    ext = input_file.suffix.lower()
    if ext == ".bam":
        ref_names, batches = iter_bam_columns(input_file)
    elif ext == ".sam":
        ref_names, batches = iter_sam_columns(input_file)
    else:
        raise ValueError("unsupported input file format, must end with bam/BAM or sam/SAM")
    rad_file = Path(rad_file)
    rad_file.parent.mkdir(parents=True, exist_ok=True)
    with open(rad_file, "wb") as out_fh:
        em = _GroupEmitter(out_fh, ref_names, filter_best)
        for cols in batches:
            em.feed(cols)
        n_chunks = em.close()
    spans.wrote(rad_file)
    log.info("wrote %d records in %d chunks from %d input alignments",
             em.total_records, n_chunks, em.n_in)
