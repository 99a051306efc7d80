"""BGZF (blocked gzip) reader/writer.

BGZF is the container format under BAM/tabix: a stream of independent gzip
members, each at most 64 KiB of uncompressed payload, carrying the compressed
block size in a gzip extra field (SI 'BC'). Random access uses *virtual file
offsets*: ``(compressed_block_start << 16) | offset_within_block``.

A copy of ``demuxalot_tpu.bamio.bgzf`` (the reference delegated all of this
to pysam/htslib, e.g. demuxalot/snp_counter.py:248).
"""
from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path
from typing import BinaryIO, Optional, Tuple, Union

# Empty BGZF block: the standard EOF marker appended to every BGZF file.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<BBBBIBBH")  # gzip fixed header (10 bytes)
_BC_SUBFIELD = struct.Struct("<BBHH")  # SI1 SI2 SLEN BSIZE

MAX_BLOCK_PAYLOAD = 65280  # htslib uses 0xff00 to leave room for headers


def _parse_block_header(data: bytes, offset: int) -> Tuple[int, int]:
    """Return (xlen, bsize) for the BGZF block starting at ``offset``.

    ``bsize`` is the total compressed block length (BSIZE field + 1).
    """
    if len(data) - offset < 18:
        raise EOFError("truncated BGZF block header")
    id1, id2, cm, flg, _mtime, _xfl, _os, xlen = _HEADER.unpack_from(data, offset)
    if id1 != 0x1F or id2 != 0x8B or cm != 8 or not (flg & 4):
        raise ValueError("not a BGZF block (bad gzip header)")
    # scan extra subfields for the BC one
    extra_start = offset + 12
    pos = extra_start
    bsize = None
    while pos < extra_start + xlen:
        si1, si2, slen = struct.unpack_from("<BBH", data, pos)
        if si1 == 66 and si2 == 67 and slen == 2:
            (bsize_m1,) = struct.unpack_from("<H", data, pos + 4)
            bsize = bsize_m1 + 1
        pos += 4 + slen
    if bsize is None:
        raise ValueError("gzip block without BGZF BC subfield")
    return xlen, bsize


def decompress_block(data: bytes, offset: int) -> Tuple[bytes, int]:
    """Decompress one BGZF block at ``offset`` in ``data``.

    Returns ``(payload, compressed_size)``.
    """
    xlen, bsize = _parse_block_header(data, offset)
    cdata_start = offset + 12 + xlen
    cdata_end = offset + bsize - 8
    payload = zlib.decompress(data[cdata_start:cdata_end], wbits=-15)
    crc, isize = struct.unpack_from("<II", data, offset + bsize - 8)
    if len(payload) != isize:
        raise ValueError(f"BGZF ISIZE mismatch: {len(payload)} != {isize}")
    if zlib.crc32(payload) != crc:
        raise ValueError("BGZF block CRC32 mismatch (corrupt data)")
    return payload, bsize


class BgzfReader:
    """Random-access reader over a BGZF file.

    Exposes both sequential ``read`` and virtual-offset ``seek`` (as needed
    by BAI-driven region fetches). Blocks are read from disk and decompressed
    on demand (a region-shard worker touching one genomic slice never pays
    for the rest of a multi-GB BAM); decompressed blocks are cached.
    """

    def __init__(self, path_or_data: Union[str, Path, bytes]):
        import io

        if isinstance(path_or_data, (str, Path)):
            self._fh: BinaryIO = open(path_or_data, "rb")
        else:
            self._fh = io.BytesIO(bytes(path_or_data))
        self._fh.seek(0, 2)
        self._size = self._fh.tell()
        self._block_cache: dict = {}
        self._coffset = 0  # compressed offset of current block
        self._payload = b""
        self._uoffset = 0  # position within current payload
        try:
            self._load_block(0)
        except (EOFError, ValueError, zlib.error) as e:
            raise ValueError(f"not a BGZF file: {e}") from e

    # -- block management -------------------------------------------------
    def _read_block_at(self, coffset: int) -> Tuple[bytes, int]:
        """Read + decompress the block starting at ``coffset`` from disk."""
        fh = self._fh
        fh.seek(coffset)
        head = fh.read(18)
        if len(head) < 18:
            raise EOFError("truncated BGZF block header")
        id1, id2, cm, flg, _mtime, _xfl, _os, xlen = _HEADER.unpack_from(head, 0)
        if id1 != 0x1F or id2 != 0x8B or cm != 8 or not (flg & 4):
            raise ValueError("not a BGZF block (bad gzip header)")
        extra = head[12:18]
        if xlen > 6:
            extra += fh.read(xlen - 6)
        bsize = None
        pos = 0
        while pos + 4 <= len(extra):
            si1, si2, slen = struct.unpack_from("<BBH", extra, pos)
            if si1 == 66 and si2 == 67 and slen == 2:
                (bsize_m1,) = struct.unpack_from("<H", extra, pos + 4)
                bsize = bsize_m1 + 1
            pos += 4 + slen
        if bsize is None:
            raise ValueError("gzip block without BGZF BC subfield")
        cdata_len = bsize - 12 - xlen - 8
        cdata = fh.read(cdata_len)
        trailer = fh.read(8)
        if len(cdata) < cdata_len or len(trailer) < 8:
            raise EOFError(f"truncated BGZF block at offset {coffset}")
        try:
            payload = zlib.decompress(cdata, wbits=-15)
        except zlib.error as e:
            raise ValueError(f"corrupt BGZF block at offset {coffset}: {e}") from e
        crc, isize = struct.unpack_from("<II", trailer, 0)
        if len(payload) != isize:
            raise ValueError(f"BGZF ISIZE mismatch: {len(payload)} != {isize}")
        if zlib.crc32(payload) != crc:
            raise ValueError("BGZF block CRC32 mismatch (corrupt data)")
        return payload, bsize

    def _load_block(self, coffset: int) -> None:
        if coffset >= self._size:
            self._coffset = coffset
            self._payload = b""
            self._uoffset = 0
            return
        cached = self._block_cache.get(coffset)
        if cached is None:
            payload, bsize = self._read_block_at(coffset)
            if len(self._block_cache) > 64:
                self._block_cache.clear()
            self._block_cache[coffset] = (payload, bsize)
        else:
            payload, bsize = cached
        self._coffset = coffset
        self._payload = payload
        self._bsize = bsize
        self._uoffset = 0

    # -- public API -------------------------------------------------------
    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def virtual_offset(self) -> int:
        return (self._coffset << 16) | self._uoffset

    def seek_virtual(self, voffset: int) -> None:
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        if coffset != self._coffset:
            self._load_block(coffset)
        if uoffset > len(self._payload):
            # a voffset pointing into a block that could not be loaded (past
            # EOF / truncated file) or past the block's payload is corrupt;
            # failing loudly beats silently short-reading stale data
            raise ValueError(
                f"corrupt virtual offset {voffset:#x}: block at {coffset} has "
                f"{len(self._payload)} bytes, in-block offset {uoffset}"
            )
        self._uoffset = uoffset

    def read(self, n: int) -> bytes:
        # fast path: the whole read sits inside the current block (the BAM
        # record loop issues two such reads per record)
        end = self._uoffset + n
        if end <= len(self._payload):
            out = self._payload[self._uoffset : end]
            self._uoffset = end
            return out
        out = []
        need = n
        while need > 0:
            avail = len(self._payload) - self._uoffset
            if avail == 0:
                next_off = self._coffset + getattr(self, "_bsize", 0)
                if next_off >= self._size or next_off == self._coffset:
                    break
                self._load_block(next_off)
                if len(self._payload) == 0:  # EOF marker block
                    next_off = self._coffset + self._bsize
                    if next_off >= self._size:
                        break
                    continue
                continue
            take = min(avail, need)
            out.append(self._payload[self._uoffset : self._uoffset + take])
            self._uoffset += take
            need -= take
        return b"".join(out)

    def read_all(self) -> bytes:
        """Decompress the entire file (fast path for full streaming)."""
        chunks = []
        offset = 0
        while offset < self._size:
            payload, bsize = self._read_block_at(offset)
            chunks.append(payload)
            offset += bsize
        return b"".join(chunks)


def compress_block(payload, level: int) -> bytes:
    """One BGZF block (gzip member with the BC subfield) holding ``payload``."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = c.compress(payload) + c.flush()
    bsize = len(cdata) + 26  # 12 header + 6 extra + 8 trailer
    header = _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    extra = _BC_SUBFIELD.pack(66, 67, 2, bsize - 1)
    trailer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + extra + cdata + trailer


class BgzfWriter:
    """Streaming BGZF writer; appends the standard EOF block on close."""

    def __init__(self, fileobj_or_path: Union[str, Path, BinaryIO], compresslevel: int = 6):
        if isinstance(fileobj_or_path, (str, Path)):
            self._fh: BinaryIO = open(fileobj_or_path, "wb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._buffer = bytearray()
        self._level = compresslevel
        self._closed = False

    @property
    def virtual_offset(self) -> int:
        return (self._fh.tell() << 16) | len(self._buffer)

    def write(self, data: bytes) -> None:
        self._buffer.extend(data)
        while len(self._buffer) >= MAX_BLOCK_PAYLOAD:
            self._flush_block(MAX_BLOCK_PAYLOAD)

    def _flush_block(self, size: Optional[int] = None) -> None:
        if size is None:
            size = len(self._buffer)
        if size == 0:
            return
        payload = bytes(self._buffer[:size])
        del self._buffer[:size]
        self._fh.write(compress_block(payload, self._level))

    def flush(self) -> None:
        self._flush_block()
        self._fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._flush_block()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
        if self._owns:
            self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()
