"""RecordIO of the port: sequential and indexed record files (the
port's own copy of ``incubator_mxnet_tpu/recordio.py``; reference
python/mxnet/recordio.py ``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack``/``unpack``/``pack_img``/``unpack_img``).

The on-disk format is dmlc-core's, so a file written by either package
(or by the reference's im2rec) is read back by the other, byte for
byte, and the ``.idx`` sidecar is the same ``key\tpos`` text::

    record := uint32 magic (0xced7230a)
              uint32 lrec   (cflag in upper 3 bits, length in lower 29)
              payload[length]
              padding to a 4-byte boundary

cflag: 0 = complete record, 1/2/3 = first/middle/last chunk of a split
record (large records are written in chunks; readers reassemble).

Reads and writes go through Python file objects; the JAX package's
optional native C++ reader (``_native.py``) is not ported (ROADMAP
A9).  ``pack_img``/``unpack_img`` import OpenCV (``cv2``) when called.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_K_MAGIC = 0xCED7230A
_LEN_BITS = 29
_LEN_MASK = (1 << _LEN_BITS) - 1
# largest payload a single chunk can carry
_MAX_CHUNK = _LEN_MASK
_WORD = struct.Struct("<II")


def _pad4(n):
    return (4 - n % 4) % 4


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference recordio.py:MXRecordIO;
    format from dmlc-core recordio)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError(f"Invalid flag {self.flag}")
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Override pickling behaviour: reopen on unpickle (reference does
        the same so DataLoader workers can carry readers across fork)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d["record"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if self.is_open:
            self.is_open = False
            self.open()

    def close(self):
        if not self.is_open:
            return
        self.record.close()
        self.is_open = False

    def reset(self):
        """Reset pointer to first item; truncates the file in write mode."""
        self.close()
        self.open()

    def write(self, buf):
        """Append one record (bytes); splits into chunks if > 2^29-1."""
        assert self.writable
        if isinstance(buf, str):
            buf = buf.encode("utf-8")
        n = len(buf)
        if n <= _MAX_CHUNK:
            self._write_chunk(buf, 0)
        else:
            pos = 0
            first = True
            while pos < n:
                chunk = buf[pos:pos + _MAX_CHUNK]
                pos += len(chunk)
                if first:
                    cflag = 1
                    first = False
                elif pos >= n:
                    cflag = 3
                else:
                    cflag = 2
                self._write_chunk(chunk, cflag)

    def _write_chunk(self, chunk, cflag):
        lrec = (cflag << _LEN_BITS) | len(chunk)
        self.record.write(_WORD.pack(_K_MAGIC, lrec))
        self.record.write(chunk)
        self.record.write(b"\x00" * _pad4(len(chunk)))

    def read(self):
        """Read one record; returns bytes or None at EOF."""
        assert not self.writable
        parts = []
        while True:
            head = self.record.read(8)
            if len(head) < 8:
                return b"".join(parts) if parts else None
            magic, lrec = _WORD.unpack(head)
            if magic != _K_MAGIC:
                raise IOError(
                    f"invalid RecordIO magic {magic:#x} in {self.uri}")
            cflag = lrec >> _LEN_BITS
            length = lrec & _LEN_MASK
            data = self.record.read(length)
            if len(data) != length:
                raise IOError(f"truncated record in {self.uri}")
            self.record.read(_pad4(length))
            parts.append(data)
            if cflag in (0, 3):
                return b"".join(parts)

    def tell(self):
        """Current file position (valid to pass to MXIndexedRecordIO.seek)."""
        return self.record.tell()

    def _seek(self, pos):
        """Reposition a reader at a byte offset obtained from tell()."""
        assert not self.writable
        self.record.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a .idx sidecar for random access
    (reference recordio.py:MXIndexedRecordIO; idx lines are 'key\\tpos')."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = None
            with open(self.idx_path) as f:
                for line in f:
                    line = line.strip().split("\t")
                    if len(line) < 2:
                        continue
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d

    def seek(self, idx):
        """Position the reader at record `idx`."""
        assert not self.writable
        pos = self.idx[idx]
        self.record.seek(pos)

    def read_idx(self, idx):
        """Random-access read of record `idx`."""
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        """Append record and register it under key `idx`."""
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


# ---------------------------------------------------------------- image pack
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
IRHeader.__doc__ = """Header of an image record (reference recordio.py:291).

flag: 0 when label is a scalar; >0 = number of float32 label values
      prepended to the payload.
label: scalar label, or (after unpack of flag>0) a float32 array.
id / id2: low / high 64 bits of a record id (id2 usually 0)."""

_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + raw bytes into an image-record payload
    (reference recordio.py:pack)."""
    header = IRHeader(*header)
    if isinstance(s, str):
        s = s.encode("utf-8")
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                       int(header.id), int(header.id2)) + s


def unpack(s):
    """Unpack an image-record payload into (IRHeader, bytes)
    (reference recordio.py:unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=np.frombuffer(s, np.float32, header.flag))
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image array and pack it (reference recordio.py:pack_img)."""
    import cv2
    encode_params = None
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack payload and decode the image (reference recordio.py:unpack_img).
    Returns (IRHeader, HxWxC uint8 array)."""
    import cv2
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    img = cv2.imdecode(img, iscolor)
    return header, img
