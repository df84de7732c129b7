"""mrsFAST-compatible on-disk index format (reader + writer).

The reference persists its k-mer index in the mrsFAST binary format
(src/mrsfast/HashTable.c). This module reads and writes that format so the
TPU framework's indexes interoperate with the reference binary's
(SURVEY §7 step 2: both the reference file format for parity checks and the
native dense array format). Layout, from the save/load pair
(HashTable.c:106-153 initSavingIHashTable, 143-255 save[Full]HashTable,
584-655 initLoadingHashTableMeta, 971-1057 loadHashTable):

File header:
  u8  magic            2 = counts only ("compact", generateHashTable),
                       3 = full table with GeneralIndex payload
  u8  WINDOW_SIZE
  i8  checkSumLength
  u32 hashTableMemSize max per-contig payload cells (fixed up at finalize,
                       HashTable.c:135-139)
  u32 IOBufferSize     VB-stream chunk buffer size (1<<24, HashTable.c:60)
  u32 CONTIG_MAX_SIZE
  genomeMetaInfo:      i32 n_contigs, then per contig
                       (i32 nameLen, name bytes, i32 length)
                       (inferred from the reader, HashTable.c:623-640 —
                       the writer lives in the missing mrsfast RefGenome.c)

Per contig block (one per packed contig):
  u8  extraInfo        1 if more contigs follow, 0 on the last
  i16 nameLen, name bytes
  i32 refGenOffset     0 (offset of a split piece within its chromosome)
  u32 refGenLength
  u64[ceil(len/21)]    3-bit packed genome: base j of a word at bits
                       (62-3j..60-3j), A0 C1 G2 T3 N4
                       (match_read.cpp:301-332, HashTable.c:786-792)
  u32 hashTableSize    number of window hashes with >0 occurrences
  VB stream in chunks of [i32 nbytes][bytes]: per nonzero hv, varbyte
                       (hvDiff from previous hv, windowCount); 7-bit
                       little-endian groups, high bit marks the LAST byte
                       (encodeVariableByte, HashTable.c:74-83); chunk
                       flushed when fill > IOBufferSize-10
  magic 3 only:
  u32 memSize          total payload cells = sum(windowCount+1)
  GeneralIndex[memSize] 8-byte records {u32 info; i16 checksum; 2 pad}:
                       per hv a block of windowCount+1 cells — header cell
                       info = number of real entries, then entries
                       {info = 1-based k-mer start, checksum} sorted by
                       (checksum, pos) (calculateHashTableOnFly
                       HashTable.c:769-821, sortHashTable 824-839). A
                       window occurrence whose checksum extension is cut
                       off by an N or the contig end occupies an allocated
                       but unfilled tail cell (the reference leaves these
                       uninitialized; we zero them).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..config import Config
from .build import ContigIndex, GenomeIndex

IO_BUFFER_SIZE = 1 << 24
DEF_CONTIG_MAX_SIZE = 1_300_000_000
_GI_DTYPE = np.dtype([("info", "<u4"), ("checksum", "<i2"), ("pad", "<i2")])


# --- varbyte -----------------------------------------------------------------

def encode_vb(value: int, out: bytearray) -> None:
    while True:
        b = value & 127
        value >>= 7
        if value == 0:
            out.append(b | 128)
            return
        out.append(b)


def decode_vb(buf: bytes, i: int) -> Tuple[int, int]:
    """Returns (value, next_index)."""
    result = 0
    shift = 0
    while True:
        t = buf[i]
        result |= (t & 127) << shift
        i += 1
        if t & 128:
            return result, i
        shift += 7


# --- 3-bit genome packing ----------------------------------------------------

def compress_codes(codes: np.ndarray) -> np.ndarray:
    """int8 codes (A0 C1 G2 T3 N>=4) -> u64 words, 21 bases/word."""
    n = codes.shape[0]
    nw = -(-max(n, 1) // 21)
    c = np.minimum(codes.astype(np.uint64), 4)
    pad = np.zeros(nw * 21, np.uint64)
    pad[:n] = c
    pad = pad.reshape(nw, 21)
    shifts = (60 - 3 * np.arange(21, dtype=np.uint64))
    return (pad << shifts).sum(axis=1, dtype=np.uint64)


def decompress_codes(words: np.ndarray, length: int) -> np.ndarray:
    shifts = (60 - 3 * np.arange(21, dtype=np.uint64))
    vals = (words[:, None] >> shifts) & np.uint64(7)
    return vals.reshape(-1)[:length].astype(np.int8)


# --- window counts (the VB stream payload) -----------------------------------

def _window_counts(codes: np.ndarray, w: int):
    """Sorted distinct WINDOW_SIZE-mer hashes and their occurrence counts
    (the reference counts windows, not full k-mers — HashTable.c:316-334;
    a window followed by an N within checkSumLength still owns a payload
    cell)."""
    from .build import _rolling_hash, _valid_windows
    h = _rolling_hash(codes, w)
    ok = _valid_windows(codes, w)
    return np.unique(h[ok], return_counts=True)


# --- writer ------------------------------------------------------------------

def write_mrsfast_index(gi: GenomeIndex, path: str, full: bool = True) -> None:
    cfg = Config(kmer=gi.kmer, window_size=gi.window_size)
    w = gi.window_size

    per_contig = []
    mem_max = 0
    for ci in gi.contigs:
        hvs, wcnt = _window_counts(ci.codes, w)
        mem_max = max(mem_max, int(wcnt.sum()) + len(hvs))
        per_contig.append((hvs, wcnt))

    with open(path, "wb") as f:
        f.write(struct.pack("<BBb", 3 if full else 2, w, gi.checksum_len))
        f.write(struct.pack("<III", mem_max if full else 0, IO_BUFFER_SIZE,
                            DEF_CONTIG_MAX_SIZE))
        f.write(struct.pack("<i", len(gi.contigs)))
        for ci in gi.contigs:
            nm = ci.name.encode()
            f.write(struct.pack("<i", len(nm)) + nm
                    + struct.pack("<i", ci.length))

        for k, ci in enumerate(gi.contigs):
            hvs, wcnt = per_contig[k]
            last = k == len(gi.contigs) - 1
            f.write(struct.pack("<B", 0 if last else 1))
            nm = ci.name.encode()
            f.write(struct.pack("<h", len(nm)) + nm)
            f.write(struct.pack("<iI", 0, ci.length))
            f.write(compress_codes(ci.codes).tobytes())

            f.write(struct.pack("<I", len(hvs)))
            buf = bytearray()
            prev = 0
            for hv, c in zip(hvs.tolist(), wcnt.tolist()):
                encode_vb(hv - prev, buf)
                encode_vb(c, buf)
                prev = hv
                if len(buf) > IO_BUFFER_SIZE - 10:
                    f.write(struct.pack("<i", len(buf)) + bytes(buf))
                    buf.clear()
            if buf:
                f.write(struct.pack("<i", len(buf)) + bytes(buf))

            if full:
                f.write(struct.pack("<I", int(wcnt.sum()) + len(hvs)))
                f.write(_payload_records(ci, hvs, wcnt).tobytes())


def _payload_records(ci: ContigIndex, hvs: np.ndarray,
                     wcnt: np.ndarray) -> np.ndarray:
    """Assemble the GeneralIndex payload for one contig from the dense
    index arrays (entries are already (hv, checksum, pos)-sorted)."""
    n_hv = len(hvs)
    total = int(wcnt.sum()) + n_hv
    rec = np.zeros(total, _GI_DTYPE)

    head = np.zeros(n_hv, np.int64)
    head[1:] = np.cumsum(wcnt[:-1] + 1)

    e_lo = np.searchsorted(ci.entry_hv, hvs, side="left").astype(np.int64)
    e_hi = np.searchsorted(ci.entry_hv, hvs + 1, side="left").astype(np.int64)
    e_cnt = e_hi - e_lo
    rec["info"][head] = e_cnt.astype(np.uint32)

    n_e = int(e_cnt.sum())
    if n_e:
        grp = np.repeat(np.arange(n_hv), e_cnt)          # bucket per entry
        within = np.arange(n_e) - np.repeat(np.cumsum(e_cnt) - e_cnt, e_cnt)
        src = np.repeat(e_lo, e_cnt) + within
        dst = head[grp] + 1 + within
        rec["info"][dst] = ci.entry_pos[src].astype(np.uint32)
        rec["checksum"][dst] = ci.entry_checksum[src]
    return rec


# --- reader ------------------------------------------------------------------

def read_mrsfast_index(path: str) -> GenomeIndex:
    """Load a mrsFAST-format index (either magic) into the native dense
    arrays. Compact indexes (magic 2) rebuild the entry table from the
    packed genome, like the reference's on-the-fly rebuild
    (HashTable.c:1041-1052)."""
    from .build import build_contig_index

    with open(path, "rb") as f:
        magic, w, cs_len = struct.unpack("<BBb", f.read(3))
        if magic not in (2, 3):
            raise ValueError(f"unsupported mrsfast index magic {magic}")
        full = magic == 3
        _mem, io_size, _cmax = struct.unpack("<III", f.read(12))
        (n_contigs,) = struct.unpack("<i", f.read(4))
        metas = []
        for _ in range(n_contigs):
            (nl,) = struct.unpack("<i", f.read(4))
            name = f.read(nl).decode()
            (ln,) = struct.unpack("<i", f.read(4))
            metas.append((name, ln))

        cfg = Config(kmer=w + cs_len, window_size=w)
        contigs: List[ContigIndex] = []
        more = True
        while more:
            hdr = f.read(1)
            if not hdr:
                break
            more = hdr[0] != 0
            (nl,) = struct.unpack("<h", f.read(2))
            name = f.read(nl).decode()
            _off, ln = struct.unpack("<iI", f.read(8))
            nw = -(-max(ln, 1) // 21)
            words = np.frombuffer(f.read(8 * nw), dtype="<u8")
            codes = decompress_codes(words, ln)

            (ht_size,) = struct.unpack("<I", f.read(4))
            hvs = np.zeros(ht_size, np.int64)
            wcnt = np.zeros(ht_size, np.int64)
            i = 0
            hv = 0
            while i < ht_size:
                (nb,) = struct.unpack("<i", f.read(4))
                chunk = f.read(nb)
                idx = 0
                while idx < nb:
                    diff, idx = decode_vb(chunk, idx)
                    c, idx = decode_vb(chunk, idx)
                    hv += diff
                    hvs[i] = hv
                    wcnt[i] = c
                    i += 1

            if full:
                (mem_size,) = struct.unpack("<I", f.read(4))
                rec = np.frombuffer(f.read(8 * mem_size), dtype=_GI_DTYPE)
                contigs.append(_from_payload(name, codes, w, hvs, wcnt, rec))
            else:
                contigs.append(build_contig_index(codes, name, cfg))
    return GenomeIndex(w, cs_len, contigs)


def _from_payload(name: str, codes: np.ndarray, w: int, hvs: np.ndarray,
                  wcnt: np.ndarray, rec: np.ndarray) -> ContigIndex:
    n_hv = len(hvs)
    head = np.zeros(n_hv, np.int64)
    head[1:] = np.cumsum(wcnt[:-1] + 1)
    e_cnt = rec["info"][head].astype(np.int64)

    n_e = int(e_cnt.sum())
    entry_hv = np.repeat(hvs, e_cnt).astype(np.int32)
    checksum = np.zeros(n_e, np.int16)
    pos = np.zeros(n_e, np.int32)
    if n_e:
        within = (np.arange(n_e)
                  - np.repeat(np.cumsum(e_cnt) - e_cnt, e_cnt))
        src = np.repeat(head, e_cnt) + 1 + within
        checksum[:] = rec["checksum"][src]
        pos[:] = rec["info"][src].astype(np.int32)
    return ContigIndex(name=name, length=codes.shape[0], codes=codes,
                       entry_hv=entry_hv, entry_checksum=checksum,
                       entry_pos=pos)
