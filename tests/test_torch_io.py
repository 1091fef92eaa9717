"""The port's gzip reader, which pipes the input through a system ``gzip``.

A reader closed while its gzip process still runs stops the process. That
happens when a reader closes early, and also between the end of gzip's
output and gzip's exit, a window that a loaded host widens. The stopped
process's status says nothing of the input: the port's reader reaps it and
does not check it, where ``atropos_tpu``'s raises ``EOFError`` for the
signal's status (ROADMAP.md queue 3 item 6). A gzip that exits on its own
is still checked, as in the reference: a truncated input raises in both.
"""
import gzip
import signal

import pytest

from atropos_tpu.io import compression as jax_compression
from atropos_tpu_torch.io import compression as port_compression

pytestmark = pytest.mark.skipif(
    port_compression.get_program_path("gzip") is None, reason="no system gzip"
)


class _RunsUntilTerminated:
    """A gzip process that is still running when its reader closes and
    exits on the reader's SIGTERM before the reader looks again."""

    def __init__(self):
        self.terminated = False

    def poll(self):
        return -signal.SIGTERM if self.terminated else None

    def terminate(self):
        self.terminated = True

    def wait(self):
        return self.poll()


def _fastq_gz(path, n_records):
    with gzip.open(str(path), "wt") as handle:
        for idx in range(n_records):
            handle.write("@r{}\nACGTACGTACGTACGTAAAA\n+\nIIIIIIIIIIIIIIIIIIII\n".format(idx))
    return str(path)


def test_reader_closed_while_gzip_runs_is_no_error(tmp_path):
    path = _fastq_gz(tmp_path / "in.fastq.gz", 10)
    port_reader = port_compression.PipedGzipReader(path)
    port_reader.process.wait()
    port_reader.process = _RunsUntilTerminated()
    port_reader.close()
    assert port_reader.process.terminated

    jax_reader = jax_compression.PipedGzipReader(path)
    jax_reader.process.wait()
    jax_reader.process = _RunsUntilTerminated()
    with pytest.raises(EOFError):
        jax_reader.close()


def test_reader_closed_early_stops_and_reaps_gzip(tmp_path):
    path = _fastq_gz(tmp_path / "in.fastq.gz", 200000)
    reader = port_compression.PipedGzipReader(path)
    assert reader.read(100).startswith(b"@r0\n")
    reader.close()
    assert reader.process.returncode is not None
    reader.close()


@pytest.mark.parametrize("package", [jax_compression, port_compression],
                         ids=["jax", "port"])
def test_truncated_input_still_raises(tmp_path, package):
    path = _fastq_gz(tmp_path / "in.fastq.gz", 2000)
    with open(path, "rb") as handle:
        data = handle.read()
    with open(path, "wb") as handle:
        handle.write(data[: len(data) // 2])
    reader = package.PipedGzipReader(path)
    with pytest.raises(EOFError):
        reader.read()
    reader.process.stdout.close()
