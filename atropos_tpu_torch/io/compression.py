"""Compressed-file codecs (.gz/.bz2/.xz).

Gzip throughput matters more than any other codec here: FASTQ inputs are
almost always gzipped, and Python's zlib binding runs decompression on
the GIL-holding thread. When a system ``gzip`` binary exists we pipe
through it instead, so (de)compression runs in its own process and
overlaps with parsing — the same trick the reference uses
(``atropos/io/compression.py:17-135``).
"""
import bz2
import gzip
import io
import lzma
import os
import shutil
from dataclasses import dataclass
from subprocess import DEVNULL, PIPE, Popen


def get_program_path(program):
    """Locate an executable on $PATH (cached)."""
    try:
        return _PROGRAM_PATHS[program]
    except KeyError:
        found = shutil.which(program)
        _PROGRAM_PATHS[program] = found
        return found


_PROGRAM_PATHS = {}


class PipedGzipWriter:
    """File-like object compressing through an external gzip process.

    Deliberately not an io.IOBase subclass: IOBase owns ``closed`` as a
    read-only property and calls close() from __del__, which interacts
    badly with the child process teardown order.
    """

    readable = seekable = staticmethod(lambda: False)

    def __init__(self, path, mode="w"):
        self.name = path
        self.outfile = open(path, mode)
        self.closed = False
        try:
            self.process = Popen(
                [get_program_path("gzip")],
                stdin=PIPE,
                stdout=self.outfile,
                stderr=DEVNULL,
                close_fds=True,
            )
        except IOError:
            self.outfile.close()
            raise

    def writable(self):
        return True

    def write(self, data):
        self.process.stdin.write(data)

    def flush(self):
        self.process.stdin.flush()

    def close(self):
        self.closed = True
        self.process.stdin.close()
        status = self.process.wait()
        self.outfile.close()
        if status != 0:
            raise IOError(
                "Output gzip process terminated with exit code {0}".format(status)
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()


class PipedGzipReader:
    """File-like object decompressing through an external gzip process."""

    writable = seekable = staticmethod(lambda: False)

    def __init__(self, path):
        self.name = path
        self.process = Popen([get_program_path("gzip"), "-cd", path], stdout=PIPE)
        self.closed = False

    def readable(self):
        return True

    def flush(self):
        pass

    def read(self, *args):
        data = self.process.stdout.read(*args)
        if not args or args[0] <= 0:
            # whole-file read: the process must be done for error checking
            self.process.wait()
        self._check_status()
        return data

    def __iter__(self):
        yield from self.process.stdout
        self.process.wait()
        self._check_status()

    def close(self):
        if self.closed:
            return
        self.closed = True
        if self.process.poll() is None:
            # closed before gzip exited (early, or between the end of its
            # output and its exit): the status of a process stopped here
            # says nothing of the input, so it is reaped and not checked
            self.process.terminate()
            self.process.wait()
            return
        self._check_status()

    def _check_status(self):
        status = self.process.poll()
        if status:  # None (still running) and 0 are both fine
            raise EOFError(
                "gzip process returned non-zero exit code {0}. Is the "
                "input file truncated or corrupt?".format(status)
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()


def _open_gzip(filename, mode, use_system=True):
    if use_system and get_program_path("gzip"):
        try:
            if "r" in mode:
                stream = PipedGzipReader(filename)
            else:
                stream = PipedGzipWriter(filename)
            return io.TextIOWrapper(stream) if "t" in mode else stream
        except Exception:
            pass  # fall through to the library implementation
    stream = gzip.open(filename, mode)
    if "b" in mode:
        wrap = io.BufferedReader if "r" in mode else io.BufferedWriter
        stream = wrap(stream)
    return stream


def _open_bz2(filename, mode, **_kwargs):
    if "t" in mode:
        return io.TextIOWrapper(bz2.BZ2File(filename, mode[0]))
    return bz2.BZ2File(filename, mode)


def _open_lzma(filename, mode, **_kwargs):
    return lzma.open(filename, mode)


@dataclass(frozen=True)
class Codec:
    """One compression format: its extension, library module, and opener."""

    extension: str
    module: object
    opener: object


_CODECS = (
    Codec(".gz", gzip, _open_gzip),
    Codec(".bz2", bz2, _open_bz2),
    Codec(".xz", lzma, _open_lzma),
)
_BY_EXTENSION = {codec.extension: codec for codec in _CODECS}


def _codec_for(filename):
    return _BY_EXTENSION.get(os.path.splitext(filename)[1])


def can_use_system_compression():
    """True when the external-gzip fast path is available."""
    return get_program_path("gzip") is not None


def get_compressor(filename):
    """The compression library module for ``filename``, or None."""
    codec = _codec_for(filename)
    return codec.module if codec else None


def get_file_opener(filename):
    """The open() replacement for ``filename``, or None if uncompressed."""
    codec = _codec_for(filename)
    return codec.opener if codec else None


def open_compressed_file(filename, mode):
    """Open a compressed file, selecting the codec by extension."""
    opener = get_file_opener(filename)
    if opener is None:
        raise ValueError(
            "{} is not a recognized compression format".format(filename)
        )
    return opener(filename, mode)


def splitext_compressed(name):
    """Split a path into (stem, format_ext, compression_ext_or_None).

    ``reads.fastq.gz`` -> (``reads``, ``.fastq``, ``.gz``).
    """
    compression_ext = None
    for ext in _BY_EXTENSION:
        if name.endswith(ext):
            compression_ext = ext
            name = name[: -len(ext)]
            break
    stem, format_ext = os.path.splitext(name)
    return stem, format_ext, compression_ext
