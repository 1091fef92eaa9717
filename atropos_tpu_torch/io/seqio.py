"""Sequence I/O: reading/writing FASTA and FASTQ (single, paired or
interleaved), FASTA + quality files, SOLiD colorspace, SAM/BAM and SRA
streams. Counterpart of ``atropos_tpu/io/seqio.py``; ``pysam`` (BAM) and
the SRA stream are optional and imported only where they are used.

Host-side record model and streaming readers. The record model keeps the
reference's provenance semantics (``atropos/io/_seqio.pyx``): ``clipped``
tracks bases cut before/after adapter matching at each end, which feeds
MinCutter and the info-file output; output formatting is byte-compatible
with the reference formatters (``atropos/io/seqio.py:642-764``).

Unlike the reference (per-line Python parsing, ``_seqio.pyx:163-245``),
the object-level FASTQ reader here runs on the same native C chunk
parser the turbo path uses (:mod:`atropos_tpu_torch.runtime`): records are
indexed in bulk and materialized as :class:`Sequence` objects from the
chunk buffer. A compact line-mode parser remains for file-like inputs
and as the error-reporting authority (its messages match the reference
byte for byte — including the reference's quirk of reporting the
4-line-cycle position, not the absolute line number).
"""
import sys

from atropos_tpu_torch import AtroposError
from atropos_tpu_torch.io import STDOUT, xopen
from atropos_tpu_torch.io.compression import splitext_compressed
from atropos_tpu_torch.util import ALPHABETS, Summarizable, reverse_complement, truncate_string

SINGLE = 0
READ1 = 1
READ2 = 2
PAIRED = 1 | 2


class FormatError(AtroposError):
    """Raised when an input file (FASTA or FASTQ) is malformatted."""


class UnknownFileType(AtroposError):
    """Raised when open could not autodetect the file type."""


class Sequence:
    """A sequencing read: name, sequence, qualities (phred+33 ASCII), plus
    trim provenance (``clipped``: [front-pre, back-pre, front-post,
    back-post] bases cut before/after adapter matching), the adapter
    ``match``/``match_info``, and pair-level flags."""

    __slots__ = (
        "name",
        "sequence",
        "qualities",
        "name2",
        "original_length",
        "match",
        "match_info",
        "clipped",
        "insert_overlap",
        "merged",
        "corrected",
    )

    def __init__(
        self,
        name,
        sequence,
        qualities=None,
        name2="",
        original_length=None,
        match=None,
        match_info=None,
        clipped=None,
        insert_overlap=False,
        merged=False,
        corrected=0,
        alphabet=None,
    ):
        if qualities is not None and len(sequence) != len(qualities):
            rname = truncate_string(name)
            raise FormatError(
                "In read named {0!r}: length of quality sequence ({1}) and "
                "length  of read ({2}) do not match".format(
                    rname, len(qualities), len(sequence)
                )
            )
        if alphabet:
            sequence = alphabet.resolve_string(sequence)
        self.name = name
        self.sequence = sequence
        self.qualities = qualities
        self.name2 = name2
        self.original_length = original_length or len(sequence)
        self.match = match
        self.match_info = match_info
        self.clipped = clipped or [0, 0, 0, 0]
        self.insert_overlap = insert_overlap
        self.merged = merged
        self.corrected = corrected

    def subseq(self, begin=0, end=None):
        """Slice [begin:end], updating clip provenance. Returns
        (front_bases, back_bases, new_read)."""
        if end is None:
            new_read = self[begin:]
            end_bases = 0
        else:
            new_read = self[begin:end]
            end_bases = len(self) - end
        offset = 2 if self.match else 0
        if begin:
            new_read.clipped[offset] += begin
        if end_bases:
            new_read.clipped[offset + 1] += end_bases
        return (begin, end_bases, new_read)

    def clip(self, front=0, back=0):
        """Cut ``front`` bases from the start and ``-back`` from the end."""
        if back < 0:
            new_read = self[front:back]
            back *= -1
        else:
            new_read = self[front:]
        offset = 2 if self.match else 0
        if front:
            new_read.clipped[offset] += front
        if back:
            new_read.clipped[offset + 1] += back
        return (front, back, new_read)

    def reverse_complement(self):
        """Copy with sequence reverse-complemented and qualities reversed."""
        import copy as _copy

        flipped = self.__class__(
            self.name,
            reverse_complement(self.sequence),
            self.qualities[::-1] if self.qualities else None,
            self.name2,
            self.original_length,
            None,
            [_copy.copy(m) for m in self.match_info] if self.match_info else None,
            list(self.clipped),
            self.insert_overlap,
            self.merged,
            self.corrected,
        )
        if self.match:
            match = self.match.copy()
            match.read = flipped
            flipped.match = match
        return flipped

    def __getitem__(self, key):
        return self.__class__(
            self.name,
            self.sequence[key],
            self.qualities[key] if self.qualities is not None else None,
            self.name2,
            self.original_length,
            self.match,
            self.match_info,
            list(self.clipped),
            self.insert_overlap,
            self.merged,
            self.corrected,
        )

    def _qual_repr(self):
        if self.qualities is None:
            return ""
        return ", qualities={0!r}".format(truncate_string(self.qualities))

    def __repr__(self):
        return "<Sequence(name={0!r}, sequence={1!r}{2})>".format(
            truncate_string(self.name), truncate_string(self.sequence),
            self._qual_repr(),
        )

    def __len__(self):
        return len(self.sequence)

    def __eq__(self, other):
        return (
            self.name == other.name
            and self.sequence == other.sequence
            and self.qualities == other.qualities
        )

    def __ne__(self, other):
        return not self.__eq__(other)


class ColorspaceSequence(Sequence):
    """Colorspace read: first char is the primer base, remainder colors."""

    __slots__ = ("primer",)

    def __init__(
        self,
        name,
        sequence,
        qualities,
        primer=None,
        name2="",
        original_length=None,
        match=None,
        match_info=None,
        clipped=None,
        insert_overlap=False,
        merged=False,
        corrected=0,
        alphabet=None,
    ):
        if primer is None:
            self.primer = sequence[0:1]
            sequence = sequence[1:]
        else:
            self.primer = primer
        if qualities is not None and len(sequence) != len(qualities):
            rname = truncate_string(name)
            raise FormatError(
                "In read named {0!r}: length of colorspace quality "
                "sequence ({1}) and length of read ({2}) do not match (primer "
                "is: {3!r})".format(rname, len(qualities), len(sequence), self.primer)
            )
        super().__init__(
            name,
            sequence,
            qualities,
            name2,
            original_length,
            match,
            match_info,
            clipped,
            insert_overlap,
            merged,
            corrected,
            alphabet=alphabet,
        )
        if self.primer not in ("A", "C", "G", "T"):
            raise FormatError(
                "Primer base is {0!r} in read {1!r}, but it should be one of "
                "A, C, G, T.".format(self.primer, truncate_string(name))
            )

    def __repr__(self):
        return "<ColorspaceSequence(name={0!r}, primer={1!r}, sequence={2!r}{3})>".format(
            truncate_string(self.name), self.primer,
            truncate_string(self.sequence), self._qual_repr(),
        )

    def __getitem__(self, key):
        return self.__class__(
            self.name,
            self.sequence[key],
            self.qualities[key] if self.qualities is not None else None,
            self.primer,
            self.name2,
            self.original_length,
            self.match,
            self.match_info,
            list(self.clipped),
            self.insert_overlap,
            self.merged,
            self.corrected,
        )


def sra_colorspace_sequence(name, sequence, qualities, name2, alphabet=None):
    """SRA colorspace reads carry one extra leading quality value."""
    return ColorspaceSequence(
        name, sequence, qualities[1:], name2=name2, alphabet=alphabet
    )


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------


class SequenceReaderBase(Summarizable):
    """Interface: input_names, input_read, file_format, delivers_qualities,
    has_qualfile, quality_base, colorspace, interleaved."""

    _SUMMARY_FIELDS = (
        "input_names", "input_read", "file_format", "delivers_qualities",
        "quality_base", "has_qualfile", "colorspace", "interleaved",
    )

    def summarize(self):
        return {field: getattr(self, field) for field in self._SUMMARY_FIELDS}

    def close(self):  # pragma: no cover - overridden where needed
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def _close_owned(reader):
    """Close a reader's underlying file iff the reader opened it."""
    if reader._close_on_exit and reader._file is not None:
        reader._file.close()
        reader._file = None


class SequenceReader(SequenceReaderBase):
    """Reader over a possibly-compressed file path or file-like object."""

    delivers_qualities = False
    has_qualfile = False
    colorspace = False
    interleaved = False
    input_read = SINGLE
    _close_on_exit = False

    def __init__(self, path, mode="r", quality_base=None, alphabet=None):
        self.quality_base = quality_base
        self.alphabet = alphabet
        if isinstance(path, str):
            self.name = path
            self._file = xopen(path, mode)
            self._close_on_exit = True
        else:
            self.name = getattr(path, "name", path.__class__)
            self._file = path

    @property
    def input_names(self):
        return (self.name, None)

    def close(self):
        _close_owned(self)

    def __enter__(self):
        if self._file is None:
            raise ValueError("I/O operation on closed SequenceReader")
        return self


class FileWithPrependedLine:
    """File-like that replays one already-consumed line before the rest
    (needed for content-based format autodetection on streams)."""

    def __init__(self, file, line):
        if not line.endswith("\n"):
            line += "\n"
        self.first_line = line
        self._file = file

    @property
    def name(self):
        return self._file.name

    def __iter__(self):
        yield self.first_line
        yield from self._file

    def close(self):
        self._file.close()


class FastqReader(SequenceReader):
    """4-line FASTQ parser (no multi-line records), CR/LF tolerant, with
    second-header consistency validation.

    Path inputs stream through the native C chunk parser
    (``runtime/fastq.cpp``) when it is available — records are indexed in
    bulk, then materialized from the buffer. File-like inputs, and any
    malformed region, use the line-mode parser (whose diagnostics match
    the reference byte for byte)."""

    file_format = "FASTQ"
    delivers_qualities = True
    _CHUNK = 16 * 1024 * 1024

    def __init__(self, filename, quality_base=33, sequence_class=Sequence, alphabet=None):
        from atropos_tpu_torch import runtime

        self._native = runtime.available() and isinstance(filename, str)
        super().__init__(
            filename,
            mode="rb" if self._native else "r",
            quality_base=quality_base,
            alphabet=alphabet,
        )
        self.sequence_class = sequence_class

    def __iter__(self):
        if self._native:
            return self._iter_native()
        return self._iter_lines(iter(self._file))

    # -- native chunked path ---------------------------------------------------

    def _iter_native(self):
        from atropos_tpu_torch import runtime

        carry = b""
        at_eof = False
        while not at_eof:
            data = self._file.read(self._CHUNK)
            at_eof = not data
            buf = carry + data
            if at_eof:
                # the tail (possibly missing its final newline, possibly
                # malformed) goes through the line parser, which is the
                # error-reporting authority
                if buf:
                    import io

                    yield from self._iter_lines(
                        io.StringIO(buf.decode("latin-1"))
                    )
                return
            try:
                chunk = runtime.parse_chunk(buf)
            except runtime.FastqParseError:
                chunk = None
            if chunk is None or (chunk.n == 0 and len(buf) > self._CHUNK):
                # malformed (or a pathologically huge record): replay
                # everything from here through the line parser
                import io

                remainder = buf + self._file.read()
                yield from self._iter_lines(
                    io.StringIO(remainder.decode("latin-1"))
                )
                return
            yield from self._records_of_chunk(chunk)
            carry = buf[chunk.consumed:]

    def _records_of_chunk(self, chunk):
        text = chunk.buf.tobytes().decode("latin-1")
        make = self.sequence_class
        alphabet = self.alphabet
        name_off = chunk.name_off
        name_end = name_off + chunk.name_len
        seq_off = chunk.seq_off
        seq_end = seq_off + chunk.seq_len
        plus_off = chunk.plus_off
        plus_len = chunk.plus_len
        qual_off = chunk.qual_off
        qual_end = qual_off + chunk.qual_len
        for i in range(chunk.n):
            name = text[name_off[i]:name_end[i]]
            if plus_len[i]:
                name2 = text[plus_off[i]:plus_off[i] + plus_len[i]]
                if name2 != name:
                    raise FormatError(
                        "At line 3: Sequence descriptions in the "
                        "FASTQ file don't match ({0!r} != {1!r}).\n"
                        "The second sequence description must be "
                        "either empty or equal to the first "
                        "description.".format(name, name2)
                    )
            else:
                name2 = ""
            yield make(
                name,
                text[seq_off[i]:seq_end[i]],
                text[qual_off[i]:qual_end[i]],
                name2=name2,
                alphabet=alphabet,
            )

    # -- line-mode path --------------------------------------------------------

    def _iter_lines(self, lines):
        """4-lines-per-record parser. Diagnostics reproduce the reference
        byte for byte — including its quirk of reporting the position in
        the 4-line cycle ("Line 1"/"Line 3"/"line 4"), not the absolute
        line number (``atropos/io/_seqio.pyx:163-245``)."""
        make = self.sequence_class
        alphabet = self.alphabet
        head = next(lines, None)
        if head is None:
            return
        eol = -2 if head.endswith("\r\n") else -1
        while head is not None:
            if not head.startswith("@"):
                raise FormatError(
                    "Line 1 in FASTQ file is expected to start with '@', "
                    "but found {0!r}".format(head[:10])
                )
            seq_line = next(lines, None)
            plus_line = next(lines, None) if seq_line is not None else None
            qual_line = next(lines, None) if plus_line is not None else None
            if qual_line is None:
                raise FormatError("FASTQ file ended prematurely")
            name = head[1:eol]
            sequence = seq_line[:eol]
            name2 = self._second_header(plus_line, name, eol)
            if len(qual_line) == len(sequence) - eol:
                qualities = qual_line[:eol]
            else:
                qualities = qual_line.rstrip("\r\n")
            try:
                yield make(
                    name, sequence, qualities, name2=name2, alphabet=alphabet
                )
            except Exception as err:
                raise FormatError(
                    "Error creating sequence record at line 4"
                ) from err
            head = next(lines, None)

    @staticmethod
    def _second_header(line, name, eol):
        if line == "+\n":
            return ""
        payload = line[:eol]
        if not payload.startswith("+"):
            raise FormatError(
                "Line 3 in FASTQ file is expected to start "
                "with '+', but found {0!r}".format(payload[:10])
            )
        if len(payload) == 1:
            return ""
        if payload[1:] != name:
            raise FormatError(
                "At line 3: Sequence descriptions in the "
                "FASTQ file don't match ({0!r} != {1!r}).\n"
                "The second sequence description must be "
                "either empty or equal to the first "
                "description.".format(name, payload[1:])
            )
        return name


class FastaReader(SequenceReader):
    """FASTA reader ('#' comment lines skipped, records may wrap)."""

    file_format = "FASTA"

    def __init__(self, path, keep_linebreaks=False, sequence_class=Sequence, alphabet=None):
        super().__init__(path, alphabet=alphabet)
        self.sequence_class = sequence_class
        self._delimiter = "\n" if keep_linebreaks else ""

    def __iter__(self):
        pending = None
        parts = []
        for lineno, raw in enumerate(self._file, 1):
            stripped = raw.strip()
            if not stripped or stripped.startswith("#"):
                continue
            if stripped.startswith(">"):
                if pending is not None:
                    yield self._make(pending, parts)
                pending = stripped[1:]
                parts = []
            elif pending is None:
                raise FormatError(
                    "At line {0}: Expected '>' at beginning of FASTA record, "
                    "but got {1!r}.".format(lineno, truncate_string(stripped))
                )
            else:
                parts.append(stripped)
        if pending is not None:
            yield self._make(pending, parts)

    def _make(self, name, parts):
        return self.sequence_class(
            name, self._delimiter.join(parts), None, alphabet=self.alphabet
        )


class ColorspaceFastaReader(FastaReader):
    colorspace = True

    def __init__(self, path, keep_linebreaks=False, alphabet=None):
        super().__init__(
            path, keep_linebreaks, sequence_class=ColorspaceSequence, alphabet=alphabet
        )


class ColorspaceFastqReader(FastqReader):
    colorspace = True

    def __init__(self, path, quality_base=33, alphabet=None):
        super().__init__(
            path, quality_base=quality_base, sequence_class=ColorspaceSequence,
            alphabet=alphabet,
        )


class SRAColorspaceFastqReader(FastqReader):
    colorspace = True

    def __init__(self, path, quality_base=33, alphabet=None):
        super().__init__(
            path, quality_base=quality_base, sequence_class=sra_colorspace_sequence,
            alphabet=alphabet,
        )


# phred values as they appear in .qual files -> phred+33 ASCII
_QUAL_TO_ASCII = {str(q): chr(q + 33) for q in range(-5, 256 - 33)}


class FastaQualReader(SequenceReaderBase):
    """Paired .(CS)FASTA + .QUAL file reader."""

    file_format = "FastaQual"
    delivers_qualities = True
    has_qualfile = True
    colorspace = False
    interleaved = False
    input_read = SINGLE

    def __init__(self, fastafile, qualfile, quality_base=33, sequence_class=Sequence, alphabet=None):
        self.fastareader = FastaReader(fastafile)
        self.qualreader = FastaReader(qualfile, keep_linebreaks=True)
        self.quality_base = quality_base
        self.sequence_class = sequence_class
        self.alphabet = alphabet

    @property
    def input_names(self):
        return ((self.fastareader.name, self.qualreader.name), None)

    def __iter__(self):
        for bases, quals in zip(self.fastareader, self.qualreader):
            if bases.name != quals.name:
                raise FormatError(
                    "The read names in the FASTA and QUAL file do not match "
                    "({0!r} != {1!r})".format(bases.name, quals.name)
                )
            try:
                qualities = "".join(
                    _QUAL_TO_ASCII[value] for value in quals.sequence.split()
                )
            except KeyError as err:
                raise FormatError(
                    "Within read named {0!r}: Found invalid quality "
                    "value {1}".format(bases.name, err)
                )
            yield self.sequence_class(
                bases.name, bases.sequence, qualities, alphabet=self.alphabet
            )

    def close(self):
        self.fastareader.close()
        self.qualreader.close()


class ColorspaceFastaQualReader(FastaQualReader):
    colorspace = True

    def __init__(self, fastafile, qualfile, quality_base=33, alphabet=None):
        super().__init__(
            fastafile, qualfile, quality_base=quality_base,
            sequence_class=ColorspaceSequence, alphabet=alphabet,
        )


def sequence_names_match(read1, read2):
    """Pair-name check ignoring a trailing 1/2 mate indicator."""
    token1 = read1.name.split(None, 1)[0]
    token2 = read2.name.split(None, 1)[0]
    if token1[-1:] in "12" and token2[-1:] in "12":
        return token1[:-1] == token2[:-1]
    return token1 == token2


class PairedSequenceReader(SequenceReaderBase):
    """Reads from two files in lockstep, validating pairing."""

    input_read = PAIRED
    interleaved = False

    def __init__(self, file1, file2, quality_base=33, colorspace=False, file_format=None, alphabet=None):
        common = dict(
            colorspace=colorspace, quality_base=quality_base,
            file_format=file_format, alphabet=alphabet,
        )
        self.reader1 = open_reader(file1, **common)
        self.reader2 = open_reader(file2, **common)

    @property
    def input_names(self):
        return (self.reader1.input_names[0], self.reader2.input_names[0])

    def __getattr__(self, name):
        return getattr(self.reader1, name)

    def __iter__(self):
        from itertools import zip_longest

        missing = object()
        for read1, read2 in zip_longest(
            self.reader1, self.reader2, fillvalue=missing
        ):
            if read1 is missing:
                raise FormatError(
                    "Reads are improperly paired. There are more reads in "
                    "file 2 than in file 1."
                )
            if read2 is missing:
                raise FormatError(
                    "Reads are improperly paired. There are more reads in "
                    "file 1 than in file 2."
                )
            if not sequence_names_match(read1, read2):
                raise FormatError(
                    "Reads are improperly paired. Read name '{0}' in file 1 "
                    "does not match '{1}' in file 2.".format(read1.name, read2.name)
                )
            yield (read1, read2)

    def close(self):
        self.reader1.close()
        self.reader2.close()


class InterleavedSequenceReader(SequenceReaderBase):
    """Read pairs from an interleaved file."""

    input_read = PAIRED
    interleaved = True

    def __init__(self, path, quality_base=33, colorspace=False, file_format=None, alphabet=None):
        self.reader = open_reader(
            path, quality_base=quality_base, colorspace=colorspace,
            file_format=file_format, alphabet=alphabet,
        )

    def __getattr__(self, name):
        return getattr(self.reader, name)

    def __iter__(self):
        itr = iter(self.reader)
        for read1 in itr:
            read2 = next(itr, None)
            if read2 is None:
                raise FormatError(
                    "Interleaved input file incomplete: Last record has no "
                    "partner."
                )
            if not sequence_names_match(read1, read2):
                raise FormatError(
                    "Reads are improperly paired. Name {0!r} (first) does not "
                    "match {1!r} (second).".format(read1.name, read2.name)
                )
            yield (read1, read2)

    def close(self):
        self.reader.close()


class SAMReader(SequenceReaderBase):
    """SAM/BAM reader via pysam (paired files must be name-sorted)."""

    file_format = "SAM"
    delivers_qualities = True
    interleaved = False
    has_qualfile = False
    colorspace = False

    def __init__(self, path, quality_base=33, sequence_class=Sequence, alphabet=None, pysam_kwargs=None):
        self._close_on_exit = False
        if isinstance(path, str):
            path = xopen(path, "rb")
            self._close_on_exit = True
        self.name = getattr(path, "name", str(path))
        self._file = path
        self.quality_base = quality_base
        self.sequence_class = sequence_class
        self.alphabet = alphabet
        self.pysam_kwargs = pysam_kwargs or dict(check_sq=False)

    @property
    def input_names(self):
        return (self.name, None)

    def __iter__(self):
        try:
            import pysam

            return self._iter(
                pysam.AlignmentFile(self._file, **self.pysam_kwargs)
            )
        except ImportError:
            # fall back to a text-SAM parser with a pysam-compatible
            # record surface (BAM still requires pysam)
            return self._iter(_TextSamFile(self._file))

    def _iter(self, sam):
        raise NotImplementedError()

    def close(self):
        _close_owned(self)

    def _as_sequence(self, read):
        return self.sequence_class(
            read.query_name,
            read.query_sequence,
            "".join(chr(33 + q) for q in read.query_qualities),
            alphabet=self.alphabet,
        )


class _TextSamRecord:
    """pysam.AlignedSegment work-alike over one text SAM line."""

    __slots__ = ("query_name", "flag", "query_sequence", "query_qualities")

    def __init__(self, fields):
        self.query_name = fields[0]
        self.flag = int(fields[1])
        seq = fields[9]
        self.query_sequence = None if seq == "*" else seq
        qual = fields[10]
        if qual == "*":
            self.query_qualities = None
        else:
            self.query_qualities = [ord(ch) - 33 for ch in qual]

    @property
    def is_read1(self):
        return bool(self.flag & 0x40)

    @property
    def is_read2(self):
        return bool(self.flag & 0x80)


class _TextSamFile:
    """Text-only SAM iterator used when pysam is unavailable. Yields every
    alignment record (like pysam's default iteration); rejects BAM."""

    def __init__(self, fileobj):
        self._file = fileobj

    def __iter__(self):
        first = True
        for line in self._file:
            if isinstance(line, bytes):
                if first and line[:2] == b"\x1f\x8b" or line[:4] == b"BAM\x01":
                    raise ImportError(
                        "Reading BAM files requires the pysam library"
                    )
                line = line.decode("ascii")
            first = False
            if not line or line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                raise FormatError(
                    "SAM line has {} fields; expected at least 11".format(
                        len(fields)
                    )
                )
            yield _TextSamRecord(fields)


class SingleEndSAMReader(SAMReader):
    input_read = SINGLE

    def _iter(self, sam):
        return map(self._as_sequence, sam)


class Read1SingleEndSAMReader(SAMReader):
    input_read = READ1

    def _iter(self, sam):
        return (self._as_sequence(r) for r in sam if r.is_read1)


class Read2SingleEndSAMReader(SAMReader):
    input_read = READ2

    def _iter(self, sam):
        return (self._as_sequence(r) for r in sam if r.is_read2)


class PairedEndSAMReader(SAMReader):
    input_read = PAIRED
    interleaved = True

    def _iter(self, sam):
        for reads in zip(sam, sam):
            if reads[0].query_name != reads[1].query_name:
                raise AtroposError(
                    "Consecutive reads {}, {} in paired-end SAM/BAM file do "
                    "not have the same name; make sure your file is "
                    "name-sorted and does not contain any "
                    "secondary/supplementary alignments.",
                    reads[0].query_name,
                    reads[1].query_name,
                )
            if reads[0].is_read1:
                assert reads[1].is_read2
            else:
                assert reads[1].is_read1
                reads = (reads[1], reads[0])
            yield tuple(self._as_sequence(r) for r in reads)


# --------------------------------------------------------------------------
# Output formats / formatters
# --------------------------------------------------------------------------


class SequenceFileFormat:
    def format(self, read):
        raise NotImplementedError()


class FastaFormat(SequenceFileFormat):
    def __init__(self, line_length=None):
        import textwrap

        self.text_wrapper = (
            textwrap.TextWrapper(width=line_length) if line_length else None
        )

    def format(self, read):
        return self.format_entry(read.name, read.sequence)

    def format_entry(self, name, sequence):
        if self.text_wrapper:
            sequence = self.text_wrapper.fill(sequence)
        return ">{0}\n{1}\n".format(name, sequence)


class ColorspaceFastaFormat(FastaFormat):
    def format(self, read):
        return self.format_entry(read.name, read.primer + read.sequence)


class FastqFormat(SequenceFileFormat):
    def format(self, read):
        return self.format_entry(read.name, read.sequence, read.qualities, read.name2)

    def format_entry(self, name, sequence, qualities, name2=""):
        return "@{0}\n{1}\n+{2}\n{3}\n".format(name, sequence, name2, qualities)


class ColorspaceFastqFormat(FastqFormat):
    def format(self, read):
        return self.format_entry(read.name, read.primer + read.sequence, read.qualities)


class SingleEndFormatter:
    """Formats single-end reads into a result dict {path: [strings]}."""

    def __init__(self, seq_format, file1):
        self.seq_format = seq_format
        self.file1 = file1
        self.written = 0
        self.read1_bp = 0
        self.read2_bp = 0

    def format(self, result, read1, read2=None):
        result[self.file1].append(self.seq_format.format(read1))
        self.written += 1
        self.read1_bp += len(read1)

    @property
    def written_bp(self):
        return (self.read1_bp, self.read2_bp)


class InterleavedFormatter(SingleEndFormatter):
    def format(self, result, read1, read2=None):
        result[self.file1].extend(
            (self.seq_format.format(read1), self.seq_format.format(read2))
        )
        self.written += 1
        self.read1_bp += len(read1)
        self.read2_bp += len(read2)


class PairedEndFormatter(SingleEndFormatter):
    def __init__(self, seq_format, file1, file2):
        super().__init__(seq_format, file1)
        self.file2 = file2

    def format(self, result, read1, read2):
        result[self.file1].append(self.seq_format.format(read1))
        result[self.file2].append(self.seq_format.format(read2))
        self.written += 1
        self.read1_bp += len(read1)
        self.read2_bp += len(read2)


# --------------------------------------------------------------------------
# SRA streaming (reference ``atropos/io/seqio.py:165-199,924-956``)
# --------------------------------------------------------------------------


class SraSequenceReader(SequenceReader):
    """Wraps a streaming SRA reader: any iterable with a ``paired``
    property yielding lists of (name, sequence, qualities) tuples."""

    delivers_qualities = True
    file_format = "fastq"

    def __init__(self, reader, quality_base=None, sequence_class=Sequence,
                 alphabet=None):
        super().__init__(reader, quality_base=quality_base, alphabet=alphabet)
        self.input_read = PAIRED if reader.paired else SINGLE
        self.sequence_class = sequence_class

    def __iter__(self):
        if self.input_read == PAIRED:
            return (
                tuple(map(self._as_sequence, read[:2])) for read in self._file
            )
        return (self._as_sequence(read[0]) for read in self._file)

    def _as_sequence(self, frag):
        return self.sequence_class(*frag, alphabet=self.alphabet)

    def close(self):
        self._file.finish()


class SraColorspaceSequenceReader(SraSequenceReader):
    colorspace = True

    def __init__(self, reader, quality_base=33, alphabet=None):
        super().__init__(
            reader, quality_base=quality_base,
            sequence_class=ColorspaceSequence, alphabet=alphabet,
        )


def sra_reader(reader, quality_base=None, colorspace=False, input_read=None,
               alphabet=None):
    """Wrap an existing SRA streaming reader, optionally restricting a
    paired stream to one mate."""
    sra_class = SraColorspaceSequenceReader if colorspace else SraSequenceReader
    wrapped = sra_class(reader, quality_base=quality_base, alphabet=alphabet)
    if not reader.paired or input_read == PAIRED:
        return wrapped
    if input_read == READ1:
        return paired_to_read1(wrapped)
    return paired_to_read2(wrapped)


# --------------------------------------------------------------------------
# Factories
# --------------------------------------------------------------------------


def paired_to_read1(reader):
    for read1, _ in reader:
        yield read1


def paired_to_read2(reader):
    for _, read2 in reader:
        yield read2


def _resolve_alphabet(alphabet):
    if not alphabet or not isinstance(alphabet, str):
        return alphabet
    try:
        return ALPHABETS[alphabet]
    except KeyError:
        raise ValueError("Invalid alphabet {}".format(alphabet))


def _detect_from_content(stream):
    """Content-based format sniff: the first non-comment character decides
    fasta ('>') vs fastq ('@'); the consumed line is replayed."""
    for line in stream:
        file_format = None
        if line.startswith(">"):
            file_format = "fasta"
        elif line.startswith("@"):
            file_format = "fastq"
        if file_format is not None or not line.startswith("#"):
            return file_format, FileWithPrependedLine(stream, line)
    return None, stream


def _open_sam(file1, input_read, interleaved, quality_base, alphabet):
    sam_class = {
        READ1: Read1SingleEndSAMReader,
        READ2: Read2SingleEndSAMReader,
    }.get(input_read, SingleEndSAMReader)
    if interleaved:
        sam_class = PairedEndSAMReader
    return sam_class(file1, quality_base=quality_base, alphabet=alphabet)


def open_reader(
    file1=None,
    file2=None,
    qualfile=None,
    quality_base=None,
    colorspace=False,
    file_format=None,
    interleaved=False,
    input_read=None,
    alphabet=None,
):
    """Reader factory with format autodetection (by extension, then by
    first content character)."""
    if interleaved and (file2 is not None or qualfile is not None):
        raise ValueError("When interleaved is set, file2 and qualfile must be None")
    if file2 is not None and qualfile is not None:
        raise ValueError("Setting both file2 and qualfile is not supported")

    alphabet = _resolve_alphabet(alphabet)

    if file2 is not None:
        return PairedSequenceReader(
            file1, file2, quality_base=quality_base,
            colorspace=colorspace, file_format=file_format,
            alphabet=alphabet,
        )

    if qualfile is not None:
        fq_class = ColorspaceFastaQualReader if colorspace else FastaQualReader
        return fq_class(
            file1, qualfile, quality_base=quality_base, alphabet=alphabet
        )

    if file_format is None and file1 != STDOUT:
        file_format = guess_format_from_name(file1)
    if file_format is None:
        if file1 == STDOUT:
            file1 = sys.stdin
        file_format, file1 = _detect_from_content(file1)

    if file_format is not None:
        file_format = file_format.lower()
        if file_format in ("sam", "bam"):
            if colorspace:
                raise ValueError(
                    "SAM/BAM format is not currently supported for colorspace reads"
                )
            return _open_sam(
                file1, input_read, interleaved, quality_base, alphabet
            )
        if interleaved:
            reader = InterleavedSequenceReader(
                file1, quality_base=quality_base, colorspace=colorspace,
                file_format=file_format, alphabet=alphabet,
            )
            if input_read == READ1:
                return paired_to_read1(reader)
            if input_read == READ2:
                return paired_to_read2(reader)
            return reader
        if file_format == "fasta":
            fasta_class = ColorspaceFastaReader if colorspace else FastaReader
            return fasta_class(file1, alphabet=alphabet)
        if file_format == "fastq":
            fastq_class = ColorspaceFastqReader if colorspace else FastqReader
            return fastq_class(
                file1, quality_base=quality_base, alphabet=alphabet
            )
        if file_format == "sra-fastq" and colorspace:
            return SRAColorspaceFastqReader(
                file1, quality_base=quality_base, alphabet=alphabet
            )

    raise UnknownFileType(
        "File format {0!r} is unknown (expected 'sra-fastq' (only for "
        "colorspace), 'fasta', 'fastq', 'sam', or 'bam').".format(
            file_format or "<Undetected>"
        )
    )


# extension (after compression-suffix stripping) -> format name
_EXTENSION_FORMATS = {
    ".fasta": "fasta", ".fa": "fasta", ".fna": "fasta",
    ".csfasta": "fasta", ".csfa": "fasta",
    ".fastq": "fastq", ".fq": "fastq",
    ".sam": "sam", ".bam": "bam",
}


def guess_format_from_name(path, raise_on_failure=False):
    """Detect format from a file name (handles compression extensions)."""
    name = path if isinstance(path, str) else getattr(path, "name", None)
    ext = None
    if name:
        stem, ext1, _ = splitext_compressed(name)
        ext = ext1.lower()
        fmt = _EXTENSION_FORMATS.get(ext)
        if fmt is None and ext == ".txt" and stem.endswith("_sequence"):
            fmt = "fastq"
        if fmt is not None:
            return fmt
    if raise_on_failure:
        raise UnknownFileType(
            "Could not determine whether file {0!r} is FASTA or FASTQ: file "
            "name extension {1!r} not recognized".format(path, ext)
        )


def create_seq_formatter(file1, file2=None, interleaved=False, **kwargs):
    """Formatter factory (format derived from file extension)."""
    seq_format = get_format(file1, **kwargs)
    if file2 is not None:
        return PairedEndFormatter(seq_format, file1, file2)
    if interleaved:
        return InterleavedFormatter(seq_format, file1)
    return SingleEndFormatter(seq_format, file1)


def get_format(path, file_format=None, colorspace=False, qualities=None, line_length=None):
    """SequenceFileFormat factory."""
    if file_format is None:
        file_format = guess_format_from_name(path, raise_on_failure=qualities is None)
    if file_format is None:
        if qualities is True:
            file_format = "fastq"
        elif qualities is False:
            file_format = "fasta"
        else:
            raise UnknownFileType("Could not determine file type.")

    file_format = file_format.lower()
    if file_format == "fastq":
        if qualities is False:
            raise ValueError(
                "Output format cannot be FASTQ since no quality values are available."
            )
        return ColorspaceFastqFormat() if colorspace else FastqFormat()
    if file_format == "fasta":
        if colorspace:
            return ColorspaceFastaFormat(line_length)
        return FastaFormat(line_length)
    raise UnknownFileType(
        "File format {0!r} is unknown (expected 'fasta' or 'fastq').".format(
            file_format
        )
    )
