"""The port's FASTA + qual, colorspace, SAM/BAM and SRA readers against the
JAX package's, record by record, and the trim command on each input.

Inputs are a few hundred records made with numpy from a seed. Each reader
of ``atropos_tpu_torch.io.seqio`` must give the records of its
``atropos_tpu`` counterpart (name, sequence, qualities, primer), the same
reader summary and the same errors (type and message); BAM without
``pysam`` and ``-sra`` without ``srastream`` fail as in the reference.
The optional modules are stood in for by stubs where a test needs them
(``tests/test_seqio.py`` and ``tests/test_trim_se.py`` drive the
reference the same way). Tolerance 0.
"""
import gzip
import os
import sys
import types

import numpy as np
import pytest

from atropos_tpu.io import seqio as jax_seqio
from atropos_tpu_torch.io import seqio as port_seqio

from .test_torch_align import seeded
from .test_torch_engine_cli import run_both, tail

SEQIOS = (jax_seqio, port_seqio)
BASES = np.frombuffer(b"ACGTN", np.uint8)


def _records(reader):
    out = []
    for item in reader:
        reads = item if isinstance(item, tuple) else (item,)
        out.append(tuple(
            (type(read).__name__, read.name, read.sequence, read.qualities,
             getattr(read, "primer", None))
            for read in reads
        ))
    return out


def _outcome(make):
    """(records, summary) of the reader ``make`` builds, or the type and
    text of what building or reading it raised."""
    try:
        reader = make()
        records = _records(reader)
        summary = reader.summarize() if hasattr(reader, "summarize") else None
        if hasattr(reader, "close"):
            reader.close()
        return records, summary
    except Exception as err:  # pylint: disable=broad-except
        return type(err).__name__, str(err)


def both(make):
    """``make(seqio)`` through both packages: equal outcomes; returns the
    port's."""
    jax_out, port_out = (_outcome(lambda s=seqio: make(s)) for seqio in SEQIOS)
    assert jax_out == port_out
    return port_out


def random_reads(rng, n, alphabet=BASES[:4], min_len=0, max_len=60):
    lengths = rng.integers(min_len, max_len + 1, n)
    return [
        alphabet[rng.integers(0, len(alphabet), int(length))].tobytes().decode()
        for length in lengths
    ]


# -- FASTA + qual ------------------------------------------------------------------


def write_fasta_qual(folder, rng, n, colorspace=False, low=0, high=41, drop=0):
    """A FASTA (or colorspace FASTA: primer base then colors) and its
    ``.qual`` with space-separated Phred values in ``[low, high)``;
    ``drop`` > 0 leaves the last ``drop`` records out of the FASTA, < 0 out
    of the ``.qual``."""
    fasta = os.path.join(folder, "in.csfasta" if colorspace else "in.fasta")
    qual = os.path.join(folder, "in.qual")
    names = ["r{}_{} comment".format(i, int(rng.integers(0, 999))) for i in range(n)]
    digits = np.frombuffer(b"0123", np.uint8)
    with open(fasta, "w") as fa, open(qual, "w") as qu:
        for i, name in enumerate(names):
            length = int(rng.integers(1 if colorspace else 0, 70))
            if colorspace:
                seq = "ACGT"[int(rng.integers(4))] + digits[
                    rng.integers(0, 4, length)].tobytes().decode()
                n_quals = length
            else:
                seq = random_reads(rng, 1, BASES, length, length)[0]
                n_quals = length
            values = rng.integers(low, high, n_quals)
            if not (drop > 0 and i >= n - drop):
                fa.write(">{}\n{}\n".format(name, seq))
            if not (drop < 0 and i >= n + drop):
                qu.write(">{}\n{}\n".format(name, " ".join(str(v) for v in values)))
    return fasta, qual


@pytest.mark.parametrize("colorspace,low,high,drop", [
    (False, 0, 41, 0), (False, -5, 41, 0), (True, -5, 30, 0), (False, 0, 41, 3),
    (False, 0, 41, -3),
])
def test_fasta_qual_reader(tmp_path, colorspace, low, high, drop):
    """FASTA + qual (negative SOLiD values among them; a FASTA or a qual
    with fewer records than the other): the same records in both
    packages."""
    rng = seeded("fastaqual", int(colorspace) * 10 + low + drop)
    fasta, qual = write_fasta_qual(str(tmp_path), rng, 200, colorspace, low, high, drop)
    records, summary = both(lambda seqio: seqio.open_reader(
        fasta, qualfile=qual, colorspace=colorspace, quality_base=33))
    assert len(records) == 200 - abs(drop)
    assert summary["has_qualfile"] and summary["colorspace"] == colorspace


@pytest.mark.parametrize("fault", ["names", "value", "length"])
def test_fasta_qual_errors(tmp_path, fault):
    """A qual whose names differ from the FASTA's, a value outside the
    table, a qual line of the wrong length: the same error."""
    fasta = str(tmp_path / "in.fasta")
    qual = str(tmp_path / "in.qual")
    with open(fasta, "w") as handle:
        handle.write(">a\nACGT\n>b\nGGCC\n")
    qual_text = {
        "names": ">a\n30 30 30 30\n>c\n30 30 30 30\n",
        "value": ">a\n30 30 30 30\n>b\n30 -6 30 30\n",
        "length": ">a\n30 30 30\n>b\n30 30 30 30\n",
    }[fault]
    with open(qual, "w") as handle:
        handle.write(qual_text)
    outcome = both(lambda seqio: seqio.open_reader(fasta, qualfile=qual))
    assert isinstance(outcome[0], str) and "Error" in outcome[0]


def test_qual_without_its_fasta_on_the_command_line(tmp_path, capsys):
    """``-sq`` without ``-se``: both parsers refuse the command line."""
    from atropos_tpu import commands as jax_commands
    from atropos_tpu_torch import commands as port_commands

    argv = ["-a", "ACGT", "-sq", str(tmp_path / "in.qual"), "-o", str(tmp_path / "o.fastq")]
    with open(argv[3], "w") as handle:
        handle.write(">a\n30\n")
    messages = []
    for execute in (
        lambda: jax_commands.get_command("trim").execute(argv),
        lambda: port_commands.get_command("trim").execute(argv, device="cpu"),
    ):
        with pytest.raises(SystemExit) as err:
            execute()
        messages.append((err.value.code, capsys.readouterr().err.splitlines()[-1]))
    assert messages[0] == messages[1] and messages[0][0] == 2


@pytest.mark.parametrize("colorspace", [False, True])
def test_fasta_qual_trim(tmp_path, monkeypatch, colorspace):
    """``-se in.fasta -sq in.qual -q 20`` (colorspace: ``-c``), through
    both packages: the pipeline, same bytes, summary and report."""
    rng = seeded("fastaqual-trim", int(colorspace))
    fasta, qual = write_fasta_qual(str(tmp_path), rng, 300, colorspace, -5 if colorspace else 0)
    out = str(tmp_path / "out.fastq")
    argv = ["-a", "ad=" + ("330201030313112312" if colorspace else "TTAGACATATCTCCGTCG"),
            "-q", "20", "-se", fasta, "-sq", qual, "-o", out] + tail(tmp_path)
    if colorspace:
        argv = ["-c"] + argv
    run_both(argv, [out], str(tmp_path / "report.txt"), monkeypatch)


# -- colorspace FASTA/FASTQ and SRA-FASTQ -------------------------------------------


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "sra-fastq"])
def test_colorspace_readers(tmp_path, fmt):
    rng = seeded("colorspace-reader", len(fmt))
    digits = np.frombuffer(b"0123.", np.uint8)
    path = str(tmp_path / ("in.fastq" if fmt != "fasta" else "in.csfasta"))
    with open(path, "w") as handle:
        for i in range(150):
            length = int(rng.integers(1, 50))
            seq = "ACGT"[int(rng.integers(4))] + digits[
                rng.integers(0, 5, length)].tobytes().decode()
            if fmt == "fasta":
                handle.write(">c{}\n{}\n".format(i, seq))
            else:
                quals = length + (1 if fmt == "sra-fastq" else 0)
                qual = (33 + rng.integers(0, 40, quals)).astype(np.uint8).tobytes().decode()
                handle.write("@c{}\n{}\n+\n{}\n".format(i, seq, qual))
    records, _ = both(lambda seqio: seqio.open_reader(
        path, colorspace=True, file_format=fmt, quality_base=33))
    assert len(records) == 150 and records[0][0][0] == "ColorspaceSequence"


def test_colorspace_primer_error(tmp_path):
    path = str(tmp_path / "in.csfasta")
    with open(path, "w") as handle:
        handle.write(">a\nT0123\n>b\nN0123\n")
    outcome = both(lambda seqio: seqio.open_reader(path, colorspace=True))
    assert outcome[0] == "FormatError"


# -- SAM / BAM --------------------------------------------------------------------------


def write_sam(path, rng, n, paired=False, unaligned_flag=4):
    """A SAM of ``n`` unaligned records (pairs: flags 77 and 141,
    queryname-sorted), as ``samtools view`` prints an unaligned BAM."""
    with open(path, "w") as out:
        out.write("@HD\tVN:1.6\tSO:queryname\n@RG\tID:x\n")
        for i in range(n):
            flags = (77, 141) if paired else (unaligned_flag,)
            for flag in flags:
                seq = random_reads(rng, 1, BASES, 2, 80)[0]
                qual = (33 + rng.integers(2, 41, len(seq))).astype(np.uint8).tobytes().decode()
                out.write("\t".join([
                    "q{}".format(i), str(flag), "*", "0", "0", "*", "*", "0", "0", seq, qual,
                    "RG:Z:x",
                ]) + "\n")
    return path


@pytest.mark.parametrize("paired,input_read", [
    (False, None), (True, None), (True, 1), (True, 2),
])
def test_text_sam_readers(tmp_path, paired, input_read):
    rng = seeded("sam", int(paired) * 3 + (input_read or 0))
    path = write_sam(str(tmp_path / "in.sam"), rng, 200, paired)
    records, summary = both(lambda seqio: seqio.open_reader(
        path, interleaved=paired and input_read is None, input_read=input_read,
        quality_base=33))
    assert len(records) == 200
    assert summary["file_format"] == "SAM"


def test_paired_sam_out_of_order(tmp_path):
    path = str(tmp_path / "in.sam")
    with open(path, "w") as out:
        for name, flag in (("a", 77), ("b", 141)):
            out.write("\t".join([name, str(flag), "*", "0", "0", "*", "*", "0", "0",
                                 "ACGT", "IIII"]) + "\n")
    outcome = both(lambda seqio: seqio.open_reader(path, interleaved=True))
    assert outcome[0] == "AtroposError"


def test_bam_without_pysam(tmp_path, monkeypatch):
    """BAM without ``pysam``: the same ImportError from both readers, and
    the same failed run from both trim commands."""
    from atropos_tpu import commands as jax_commands
    from atropos_tpu_torch import commands as port_commands

    monkeypatch.setitem(sys.modules, "pysam", None)
    bam = str(tmp_path / "in.bam")
    with gzip.open(bam, "wb") as out:
        out.write(b"BAM\x01" + b"\x00" * 16)
    outcome = both(lambda seqio: seqio.open_reader(bam))
    assert outcome == ("ImportError", "Reading BAM files requires the pysam library")
    argv = ["-a", "ad=ACGTACGT", "-se", bam, "-o", str(tmp_path / "o.fastq")] + tail(tmp_path)
    results = []
    for execute in (
        lambda: jax_commands.get_command("trim").execute(argv),
        lambda: port_commands.get_command("trim").execute(argv, device="cpu"),
    ):
        retcode, summary = execute()
        results.append((retcode, summary.get("exception", {}).get("message")))
    assert results[0] == results[1] and results[0][0] != 0


@pytest.mark.parametrize("aligner", ["adapter", "insert"])
def test_sam_trim(tmp_path, monkeypatch, aligner):
    """``-se in.sam`` and ``-l in.sam`` (paired): the pipeline and its
    batched engine in both packages, same bytes, summary and report."""
    rng = seeded("sam-trim", len(aligner))
    se = write_sam(str(tmp_path / "se.sam"), rng, 150)
    pe = write_sam(str(tmp_path / "pe.sam"), rng, 150, paired=True)
    out = str(tmp_path / "out.fastq")
    run = run_both(["-a", "ad=ACGTACGTGG", "-q", "15", "-se", se, "-o", out] + tail(tmp_path),
                   [out], str(tmp_path / "report.txt"), monkeypatch)
    assert run[4][0] == {"engine": 1, "fallback": 0}
    outs = [str(tmp_path / "o1.fastq"), str(tmp_path / "o2.fastq")]
    run = run_both(["--aligner", aligner, "-a", "ad1=ACGTACGTGG", "-A", "ad2=TTGGCCAAGG",
                    "-l", pe, "-o", outs[0], "-p", outs[1]] + tail(tmp_path),
                   outs, str(tmp_path / "report.txt"), monkeypatch)
    assert run[4][0] == {"engine": 1, "fallback": 0}


# -- SRA ----------------------------------------------------------------------------


class FakeSraStream:
    """Stands in for ``srastream.SraReader``: an iterable of lists of
    (name, sequence, qualities) tuples with a ``paired`` property."""

    def __init__(self, reads, paired):
        self.reads = reads
        self.paired = paired
        self.finished = 0

    def __iter__(self):
        return iter(self.reads)

    def finish(self):
        self.finished += 1


def _sra_reads(rng, n, paired):
    reads = []
    for i in range(n):
        mates = []
        for _ in range(2 if paired else 1):
            seq = random_reads(rng, 1, BASES, 1, 60)[0]
            mates.append(("s{}".format(i), seq,
                          (33 + rng.integers(2, 41, len(seq))).astype(np.uint8).tobytes().decode()))
        reads.append(mates)
    return reads


@pytest.mark.parametrize("paired,input_read", [
    (False, None), (True, 3), (True, 1), (True, 2),
])
def test_sra_readers(paired, input_read):
    rng = seeded("sra", int(paired) * 4 + (input_read or 0))
    reads = _sra_reads(rng, 100, paired)
    streams = []

    def make(seqio):
        streams.append(FakeSraStream(reads, paired))
        return seqio.sra_reader(streams[-1], input_read=input_read, quality_base=33)

    records, _ = both(make)
    assert len(records) == 100
    assert [stream.finished for stream in streams] == [1, 1] or input_read in (1, 2)


@pytest.mark.parametrize("paired", [False, True])
def test_sra_trim_with_a_stub(tmp_path, monkeypatch, paired):
    """``-sra ACCESSION`` with a stub ``srastream`` in both packages: the
    same bytes, summary and report, and each stream finished once."""
    rng = seeded("sra-trim", int(paired))
    reads = _sra_reads(rng, 120, paired)
    finished = []

    class FakeSraReader(FakeSraStream):
        def __init__(self, accession, batch_size=1000):
            super().__init__(reads, paired)
            self.name = accession
            finished.append(self)

        def start(self):
            pass

    fake = types.ModuleType("srastream")
    fake.SraReader = FakeSraReader
    monkeypatch.setitem(sys.modules, "srastream", fake)
    outs = [str(tmp_path / "o1.fastq")]
    argv = ["-a", "ad1=ACGTACGTGG", "-sra", "SRR000001", "-o", outs[0]]
    if paired:
        outs.append(str(tmp_path / "o2.fastq"))
        argv += ["-A", "ad2=TTGGCCAAGG", "-p", outs[1]]
    run_both(argv + tail(tmp_path), outs, str(tmp_path / "report.txt"), monkeypatch)
    assert [reader.finished for reader in finished] == [1, 1]


def test_sra_without_srastream(tmp_path, monkeypatch, capsys):
    """``-sra`` without ``srastream``: both parsers report the accession
    and exit with code 2; neither imported the module at import time."""
    from atropos_tpu import commands as jax_commands
    from atropos_tpu_torch import commands as port_commands

    monkeypatch.setitem(sys.modules, "srastream", None)
    argv = ["-a", "ACGT", "-sra", "SRR000001", "-o", str(tmp_path / "o.fastq"),
            "--quiet"]
    messages = []
    for execute in (
        lambda: jax_commands.get_command("trim").execute(argv),
        lambda: port_commands.get_command("trim").execute(argv, device="cpu"),
    ):
        with pytest.raises(SystemExit) as err:
            execute()
        messages.append((err.value.code, capsys.readouterr().err.splitlines()[-1]))
    assert messages[0] == messages[1] and messages[0][0] == 2
    assert "Unable to read from accession SRR000001" in messages[1][1]
