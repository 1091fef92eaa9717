"""Path checking and transparent file opening.

The special names ``-`` and ``_`` stand for stdout and stderr (stdin when
reading), matching the reference CLI conventions
(``atropos/io/__init__.py:9-10,128-173``). Compressed files are opened
through the codec registry in :mod:`atropos_tpu_torch.io.compression`.
"""
import contextlib
import errno
import os
import sys

from atropos_tpu_torch.io.compression import get_file_opener

STDOUT = "-"
STDERR = "_"


def abspath(path):
    return os.path.abspath(os.path.expanduser(path))


def resolve_path(path, parent=None):
    """Absolute path of ``path``, trying ``parent`` as a base if needed."""
    resolved = abspath(path)
    if not os.path.exists(resolved) and parent is not None:
        resolved = abspath(os.path.join(parent, path))
    if not os.path.exists(resolved):
        raise IOError(errno.ENOENT, "%s does not exist" % resolved, resolved)
    return resolved


def check_path(path, ptype=None, access=None):
    """Validate that ``path`` is the right kind of entry and accessible."""
    if ptype == "f" and not (path.startswith("/dev/") or os.path.isfile(path)):
        raise IOError(errno.EISDIR, "{} is not a file".format(path), path)
    if ptype == "d" and not os.path.isdir(path):
        raise IOError(errno.ENOTDIR, "{} is not a directory".format(path), path)
    if not os.path.exists(path):
        raise IOError(errno.ENOENT, "{} does not exist".format(path), path)
    if access is not None and not os.access(path, access):
        raise IOError(errno.EACCES, "{} is not accessable".format(path), path)
    return path


def check_writeable(rawpath, ptype=None):
    """Validate that ``rawpath`` can be written, creating parent dirs."""
    if rawpath in (STDOUT, STDERR):
        return rawpath
    rawpath = abspath(rawpath)
    try:
        return check_path(resolve_path(rawpath), ptype, os.W_OK)
    except IOError:
        parent = os.path.dirname(rawpath)
        if os.path.exists(parent):
            check_path(parent, "d", os.W_OK)
        else:
            os.makedirs(parent)
        return os.path.join(parent, os.path.basename(rawpath))


_TEXT_DEFAULT = {"r": "rt", "w": "wt", "a": "at"}


def _normalize_mode(mode, allowed):
    mode = _TEXT_DEFAULT.get(mode, mode)
    if mode not in allowed:
        raise ValueError("mode '{0}' not supported".format(mode))
    return mode


def _stdio_stream(filename, mode):
    """The standard stream a special filename maps to, matching binarity."""
    if "r" in mode:
        stream = sys.stdin
    elif filename == STDERR:
        stream = sys.stderr
    else:
        stream = sys.stdout
    return stream.buffer if "b" in mode else stream


def open_output(filename, mode="w", context_wrapper=False):
    """Open a file for writing/appending; '-'/'_' map to stdout/stderr.

    With ``context_wrapper``, standard streams come wrapped so that
    ``with`` blocks don't close them.
    """
    mode = _normalize_mode(mode, ("wt", "wb", "at", "ab"))
    if not isinstance(filename, str):
        raise ValueError("the filename must be a string")
    if filename in (STDOUT, STDERR):
        stream = _stdio_stream(filename, mode)
        if context_wrapper:
            return contextlib.nullcontext(stream)
        return stream
    return open(check_writeable(filename, "f"), mode)


def xopen(filename, mode="r", use_system=True):
    """Open a possibly-compressed file; '-'/'_' map to standard streams."""
    mode = _normalize_mode(mode, ("rt", "rb", "wt", "wb", "at", "ab"))
    if not isinstance(filename, str):
        raise ValueError("the filename must be a string")
    if filename in (STDOUT, STDERR):
        return _stdio_stream(filename, mode)
    opener = get_file_opener(filename)
    if opener is not None:
        return opener(filename, mode, use_system=use_system)
    return open(filename, mode)
