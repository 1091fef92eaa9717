"""Native runtime: C++ FASTQ/FASTA parser, packer, quality-window scanner
and formatter with ctypes bindings.

``fastq.cpp`` is compiled with ``g++`` at first use into the package's
``build/`` directory (rebuilt when the source is newer) and loaded with
``ctypes``. Counterpart of ``atropos_tpu/runtime/__init__.py``, from the
same source; a failed build raises, since the turbo runner has no other
parser.
"""
import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastq.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libfastq.so")

_lib = None
_lock = threading.Lock()


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(_LIB_PATH, os.getpid())
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp,
    ]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(
            "building the native fastq runtime failed:\n" + done.stderr
        )
    os.replace(tmp, _LIB_PATH)


def lib():
    """The loaded native library, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load():
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(
        _LIB_PATH
    ) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.fastq_parse.restype = ctypes.c_int64
    lib.fastq_parse.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i64p, i32p, i64p, i32p, i64p, i32p, i64p,
    ]
    lib.gather_padded.restype = None
    lib.gather_padded.argtypes = [
        u8p, i64p, i32p, ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.fasta_parse.restype = ctypes.c_int64
    lib.fasta_parse.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i64p, i32p, i64p, u8p, i64p, i64p,
    ]
    lib.fasta_format_trimmed.restype = ctypes.c_int64
    lib.fasta_format_trimmed.argtypes = [
        u8p, i64p, i32p, i64p,
        i32p, i32p, u8p, ctypes.c_int64,
        u8p, ctypes.c_int64,
    ]
    lib.scan_alphabet.restype = None
    lib.scan_alphabet.argtypes = [u8p, i64p, i32p, ctypes.c_int64, u8p]
    lib.quality_trim_windows.restype = None
    lib.quality_trim_windows.argtypes = [
        u8p, i64p, i64p, i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p,
    ]
    lib.gather_packed.restype = None
    lib.gather_packed.argtypes = [
        u8p, i64p, i32p, ctypes.c_int64, ctypes.c_int64,
        u8p, ctypes.c_int64, u8p,
    ]
    lib.fastq_format_trimmed.restype = ctypes.c_int64
    lib.fastq_format_trimmed.argtypes = [
        u8p,
        i64p, i32p, i64p, i64p, i32p, i64p,
        i32p, i32p, u8p, ctypes.c_int64,
        u8p, ctypes.c_int64,
        u8p, i64p, i64p, i64p,
        i64p, i32p, i64p, i32p,
    ]
    return lib


def available():
    """Whether the native runtime can be used (builds it if need be)."""
    lib()
    return True


def _u8(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class FastqChunk:
    """Parsed index over a raw FASTQ buffer."""

    __slots__ = (
        "buf", "n", "consumed",
        "name_off", "name_len", "seq_off", "seq_len",
        "plus_off", "plus_len", "qual_off", "qual_len",
        "_alphabet",
    )

    def __init__(self, buf, n, consumed, arrays):
        self.buf = buf
        self.n = n
        self.consumed = consumed
        self._alphabet = None
        (
            self.name_off, self.name_len,
            self.seq_off, self.seq_len,
            self.plus_off, self.plus_len,
            self.qual_off, self.qual_len,
        ) = arrays

    @property
    def alphabet(self):
        """Sorted array of distinct sequence byte values in this chunk
        (computed once, native scan)."""
        if self._alphabet is None:
            present = np.zeros(256, np.uint8)
            if self.n:
                lib().scan_alphabet(
                    _u8(self.buf), _i64(self.seq_off), _i32(self.seq_len),
                    self.n, _u8(present),
                )
            self._alphabet = np.nonzero(present)[0].astype(np.uint8)
        return self._alphabet

    def padded_sequences(self, width=None):
        """Zero-padded [n, width] uint8 matrix of the sequences."""
        if width is None:
            width = int(self.seq_len.max()) if self.n else 0
        out = np.zeros((self.n, width), dtype=np.uint8)
        lib().gather_padded(
            _u8(self.buf), _i64(self.seq_off), _i32(self.seq_len),
            self.n, width, _u8(out),
        )
        return out

    def padded_qualities(self, width=None):
        if width is None:
            width = int(self.qual_len.max()) if self.n else 0
        out = np.zeros((self.n, width), dtype=np.uint8)
        lib().gather_padded(
            _u8(self.buf), _i64(self.qual_off), _i32(self.qual_len),
            self.n, width, _u8(out),
        )
        return out

    def format_trimmed(self, keep_start, keep_stop, keep=None):
        """Assemble trimmed FASTQ bytes for kept records."""
        keep_start = np.ascontiguousarray(keep_start, dtype=np.int32)
        keep_stop = np.ascontiguousarray(keep_stop, dtype=np.int32)
        if keep is None:
            keep = np.ones(self.n, dtype=np.uint8)
        else:
            keep = np.ascontiguousarray(keep, dtype=np.uint8)
        cap = int(
            self.n * 8
            + self.name_len.sum()
            + self.plus_len.sum()
            + 2 * np.maximum(keep_stop - keep_start, 0).sum()
        ) + 16
        out = np.empty(cap, dtype=np.uint8)
        written = lib().fastq_format_trimmed(
            _u8(self.buf),
            _i64(self.name_off), _i32(self.name_len),
            _i64(self.seq_off),
            _i64(self.plus_off), _i32(self.plus_len),
            _i64(self.qual_off),
            _i32(keep_start), _i32(keep_stop), _u8(keep),
            self.n,
            _u8(out), cap,
            None, None, None, None, None, None, None, None,
        )
        if written < 0:
            raise RuntimeError("fastq_format_trimmed: output capacity exceeded")
        return out[:written].tobytes()


class FastqParseError(Exception):
    pass


class FastaParseError(Exception):
    """Malformed FASTA content; ``offset`` is the offending line's byte
    offset in the parsed buffer (for exact error-message reconstruction)."""

    def __init__(self, message, offset):
        super().__init__(message)
        self.offset = offset


def parse_fasta_chunk(buf, final=False, max_records=None):
    """Parse a bytes/ndarray FASTA buffer into a :class:`FastqChunk`
    (qual/plus fields zeroed; ``chunk.buf`` is a NORMALIZED buffer with
    names and compacted sequences — wrapped records become contiguous).

    Unless ``final``, the trailing record is left unconsumed (a record
    only completes at the next '>' line); ``chunk.consumed`` reports the
    input bytes used.
    """
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if max_records is None:
        max_records = max(16, int(np.count_nonzero(buf == ord(">"))) + 2)
    name_off = np.empty(max_records, np.int64)
    name_len = np.empty(max_records, np.int32)
    seq_off = np.empty(max_records, np.int64)
    seq_len = np.empty(max_records, np.int32)
    consumed = np.zeros(1, np.int64)
    out = np.empty(buf.size + 1, np.uint8)
    out_used = np.zeros(1, np.int64)
    err_off = np.zeros(1, np.int64)
    n = lib().fasta_parse(
        _u8(buf), buf.size, max_records, 1 if final else 0,
        _i64(name_off), _i32(name_len),
        _i64(seq_off), _i32(seq_len),
        _i64(consumed), _u8(out), _i64(out_used), _i64(err_off),
    )
    if n == -1:
        raise FastaParseError(
            "FASTA content line outside any record", int(err_off[0])
        )
    if n < 0:
        raise FastqParseError(_ERRORS.get(int(n), "unknown error {}".format(n)))
    n = int(n)
    zeros64 = np.zeros(n, np.int64)
    zeros32 = np.zeros(n, np.int32)
    arrays = (
        name_off[:n], name_len[:n],
        seq_off[:n], seq_len[:n],
        zeros64, zeros32,          # plus
        zeros64.copy(), zeros32.copy(),  # qual
    )
    return FastqChunk(out, n, int(consumed[0]), arrays)


_ERRORS = {
    -1: "malformed record start (expected '@')",
    -2: "missing '+' separator line",
    -3: "sequence/quality length mismatch",
    -4: "record capacity exceeded",
}


def parse_chunk(buf, max_records=None):
    """Parse a bytes/ndarray FASTQ buffer into a :class:`FastqChunk`.

    The final record must be complete (ends with a newline or the chunk
    is truncated before it; ``chunk.consumed`` reports how many bytes were
    used, so streaming callers can carry the remainder forward).
    """
    if isinstance(buf, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(buf, dtype=np.uint8)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if max_records is None:
        # exact bound from the newline count (4 lines per record); the
        # byte scan is ~memory-bandwidth, far cheaper than allocating
        # index arrays for the worst-case 8-bytes-per-record estimate
        max_records = max(16, int(np.count_nonzero(buf == 10)) // 4 + 2)
    name_off = np.empty(max_records, np.int64)
    name_len = np.empty(max_records, np.int32)
    seq_off = np.empty(max_records, np.int64)
    seq_len = np.empty(max_records, np.int32)
    plus_off = np.empty(max_records, np.int64)
    plus_len = np.empty(max_records, np.int32)
    qual_off = np.empty(max_records, np.int64)
    qual_len = np.empty(max_records, np.int32)
    consumed = np.zeros(1, np.int64)
    n = lib().fastq_parse(
        _u8(buf), buf.size, max_records,
        _i64(name_off), _i32(name_len),
        _i64(seq_off), _i32(seq_len),
        _i64(plus_off), _i32(plus_len),
        _i64(qual_off), _i32(qual_len),
        _i64(consumed),
    )
    if n < 0:
        raise FastqParseError(_ERRORS.get(int(n), "unknown error {}".format(n)))
    n = int(n)
    arrays = tuple(
        arr[:n]
        for arr in (
            name_off, name_len, seq_off, seq_len,
            plus_off, plus_len, qual_off, qual_len,
        )
    )
    return FastqChunk(buf, n, int(consumed[0]), arrays)
