"""RecordIO file format: MXRecordIO / MXIndexedRecordIO / pack-unpack
(counterpart of ``mxnet_tpu/recordio.py``).

Ref: python/mxnet/recordio.py and dmlc-core recordio. The bytes on disk
are the JAX package's, both ways, and the reference format: records framed as [magic u32][lrec u32][data][pad to 4B]
where lrec encodes cflag (top 3 bits) and length (29 bits); image records
carry an IRHeader (flag, label, id, id2).
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as onp

from .base import DataError, MXNetError

_MAGIC = 0xced7230a

IRHeader = collections.namedtuple('HEADER', ['flag', 'label', 'id', 'id2'])
_IR_FORMAT = 'IfQQ'
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return (lrec >> 29) & 7, lrec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential .rec reader/writer (ref: recordio.py MXRecordIO).

    Backed by the native C++ runtime (csrc/io/mxtpu_io.cc, built by
    ``_native``) when the shared library is available; a pure-Python
    file path otherwise. Both produce identical bytes.
    """

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self._native = None
        self.is_open = False
        self.open()

    def open(self):
        from . import _native
        lib = _native.get_lib()
        if self.flag == 'w':
            self.writable = True
        elif self.flag == 'r':
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")
        if lib is not None:
            path = self.uri.encode()
            h = (lib.mxt_recordio_writer_create(path) if self.writable
                 else lib.mxt_recordio_reader_create(path))
            if not h:
                raise MXNetError(f"cannot open {self.uri}")
            self._native = (lib, h)
            self._wpos = 0  # a reopen truncates; stale offsets corrupt .idx
        else:
            self.handle = open(self.uri, 'wb' if self.writable else 'rb')
        self.is_open = True
        self._read_count = 0   # sequential record index for error context

    def close(self):
        if not self.is_open:
            return
        if self._native is not None:
            lib, h = self._native
            if self.writable:
                lib.mxt_recordio_writer_free(h)
            else:
                lib.mxt_recordio_reader_free(h)
            self._native = None
        if self.handle:
            self.handle.close()
            self.handle = None
        self.is_open = False

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d['handle'] = None
        d['_native'] = None
        d['is_open'] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if not self.is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        if self._native is not None:
            lib, h = self._native
            if self.writable:
                return getattr(self, '_wpos', 0)
            return lib.mxt_recordio_reader_tell(h)
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        # sequential record counting is meaningless after a random seek;
        # None makes read()'s corrupt-record context say "record ?"
        # instead of naming the WRONG record (MXIndexedRecordIO.read_idx
        # fills in the real key)
        self._read_count = None
        if self._native is not None:
            lib, h = self._native
            lib.mxt_recordio_reader_seek(h, pos)
        else:
            self.handle.seek(pos)

    def write(self, buf):
        assert self.writable
        if self._native is not None:
            import ctypes
            lib, h = self._native
            pos = ctypes.c_uint64()
            if lib.mxt_recordio_writer_write(h, bytes(buf), len(buf),
                                             ctypes.byref(pos)) != 0:
                raise MXNetError(f"write failed on {self.uri}")
            # next record's start offset, for MXIndexedRecordIO.write_idx
            self._wpos = pos.value + 8 + len(buf) + (4 - len(buf) % 4) % 4
            return
        lrec = _encode_lrec(0, len(buf))
        self.handle.write(struct.pack('<II', _MAGIC, lrec))
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b'\x00' * pad)

    def _data_error(self, what, pos, detail=''):
        # _read_count is None after a random seek (sequential index
        # unknown) — say "record ?" rather than naming the wrong record
        rec = self._read_count if self._read_count is not None else '?'
        return DataError(
            f"{what} in {self.uri} (record {rec} at offset {pos}"
            + (f": {detail}" if detail else '') + ')',
            index=self._read_count, offset=pos, path=self.uri)

    def read(self):
        assert not self.writable
        if self._native is not None:
            import ctypes
            lib, h = self._native
            out = ctypes.c_char_p()
            n = lib.mxt_recordio_reader_read(h, ctypes.byref(out))
            if n == -1:
                return None
            if n < 0:
                # tell() only on the error path (a failed read does not
                # advance past the bad record) — the happy path stays at
                # one FFI call per record
                raise self._data_error('invalid record magic',
                                       lib.mxt_recordio_reader_tell(h))
            if self._read_count is not None:
                self._read_count += 1
            return ctypes.string_at(out, n)
        pos = self.handle.tell()
        head = self.handle.read(8)
        if not head:
            return None
        if len(head) < 8:
            raise self._data_error('truncated record header', pos)
        magic, lrec = struct.unpack('<II', head)
        if magic != _MAGIC:
            raise self._data_error('invalid record magic', pos)
        _, length = _decode_lrec(lrec)
        buf = self.handle.read(length)
        if len(buf) < length:
            raise self._data_error(
                'truncated record payload', pos,
                f'read {len(buf)} of {length} bytes')
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        if self._read_count is not None:
            self._read_count += 1
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec with .idx (ref: recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split('\t')
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, 'w') as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        try:
            return self.read()
        except DataError as e:
            # random access knows the real record key — restore the
            # context the sequential counter lost at seek()
            raise DataError(
                f"record {idx!r} in {self.uri} (offset {e.offset}): {e}",
                index=idx, offset=e.offset, path=self.uri) from e

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """Pack a string with IRHeader (ref: recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id, header.id2)
        return hdr + s
    label = onp.asarray(header.label, dtype=onp.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """Unpack to (IRHeader, payload) (ref: recordio.py unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    header, img_bytes = unpack(s)
    import io as _io
    from PIL import Image
    img = onp.asarray(Image.open(_io.BytesIO(img_bytes)))
    return header, img


def pack_img(header, img, quality=95, img_fmt='.jpg'):
    import io as _io
    from PIL import Image
    buf = _io.BytesIO()
    fmt = 'JPEG' if img_fmt in ('.jpg', '.jpeg') else 'PNG'
    Image.fromarray(onp.asarray(img)).save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())
