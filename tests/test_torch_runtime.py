"""The port's copy of the native runtime against the JAX package's.

Both packages compile the same ``fastq.cpp`` on their own; the port builds
its library at first use into its ``build/`` directory. The same buffers,
made from a seed, go through both: parse index, alphabet scan, padded and
2/4-bit packed gathers, quality windows, FASTQ and FASTA formatting. Every
value is an integer or a byte, so equality is exact.
"""
import os

import numpy as np
import pytest

from atropos_tpu import runtime as jax_runtime
from atropos_tpu.engine import turbo as jax_turbo
from atropos_tpu_torch import runtime as port_runtime
from atropos_tpu_torch.engine import turbo as port_turbo

from .test_torch_align import _bases, seeded

INDEX_FIELDS = (
    "name_off", "name_len", "seq_off", "seq_len",
    "plus_off", "plus_len", "qual_off", "qual_len",
)


def make_fastq(rng, n_reads, alphabet="ACGT", min_len=0, max_len=80,
               crlf=False, repeat_name=False):
    eol = "\r\n" if crlf else "\n"
    lines = []
    for i in range(n_reads):
        length = int(rng.integers(min_len, max_len + 1))
        seq = _bases(rng, length, alphabet)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 41, length))
        name = "read{} len={}".format(i, length)
        plus = name if repeat_name and i % 3 == 0 else ""
        lines.append("@{}{e}{}{e}+{}{e}{}{e}".format(name, seq, plus, qual, e=eol))
    return "".join(lines).encode("ascii")


def make_fasta(rng, n_reads, wrap=None):
    out = []
    for i in range(n_reads):
        seq = _bases(rng, int(rng.integers(0, 90)), "ACGTN")
        if wrap:
            seq = "\n".join(seq[j : j + wrap] for j in range(0, len(seq), wrap))
        out.append(">seq{} x\n{}\n".format(i, seq))
    return "".join(out).encode("ascii")


def assert_same_chunk(a, b):
    assert a.n == b.n and a.consumed == b.consumed
    for field in INDEX_FIELDS:
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert np.array_equal(a.buf, b.buf)
    assert np.array_equal(a.alphabet, b.alphabet)


def test_port_runtime_builds_into_its_own_directory():
    assert port_runtime.available()
    assert os.path.dirname(port_runtime._LIB_PATH) == port_runtime.BUILD_DIR
    assert os.path.basename(port_runtime.BUILD_DIR) == "build"
    assert "atropos_tpu_torch" in port_runtime.BUILD_DIR
    assert os.path.exists(port_runtime._LIB_PATH)
    with open(port_runtime._SRC, "rb") as a, open(
        os.path.join(os.path.dirname(jax_runtime.__file__), "fastq.cpp"), "rb"
    ) as b:
        assert a.read().replace(b"atropos_tpu_torch", b"atropos_tpu") == b.read()


@pytest.mark.parametrize("alphabet", ["ACGT", "ACGTN", "ACGTNacgtnRYKMSWBDHV"])
@pytest.mark.parametrize("crlf", [False, True])
def test_parse_index_and_alphabet(alphabet, crlf):
    rng = seeded("parse", alphabet, crlf)
    data = make_fastq(rng, 150, alphabet, crlf=crlf, repeat_name=True)
    data += b"@partial\nACGT"  # an incomplete trailing record
    assert_same_chunk(
        jax_runtime.parse_chunk(data), port_runtime.parse_chunk(data)
    )


@pytest.mark.parametrize("bad", [
    b"not a fastq\n",
    b"@r\nACGT\nX\n!!!!\n",
    b"@r\nACGT\n+\n!!!\n@x\nA\n+\n!\n",
])
def test_parse_errors_agree(bad):
    with pytest.raises(jax_runtime.FastqParseError) as jax_err:
        jax_runtime.parse_chunk(bad)
    with pytest.raises(port_runtime.FastqParseError) as port_err:
        port_runtime.parse_chunk(bad)
    assert str(jax_err.value) == str(port_err.value)


@pytest.mark.parametrize("wrap", [None, 30])
@pytest.mark.parametrize("final", [False, True])
def test_fasta_parse_and_format(wrap, final):
    rng = seeded("fasta", wrap, final)
    data = make_fasta(rng, 60, wrap)
    a = jax_runtime.parse_fasta_chunk(data, final=final)
    b = port_runtime.parse_fasta_chunk(data, final=final)
    assert a.n == b.n and a.consumed == b.consumed
    used = int((a.seq_off[-1] + a.seq_len[-1])) if a.n else 0
    for field in ("name_off", "name_len", "seq_off", "seq_len"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert np.array_equal(a.buf[:used], b.buf[:used])
    sub = slice(0, a.n)
    start = rng.integers(0, 5, a.n).astype(np.int32)
    stop = np.maximum(start, a.seq_len - rng.integers(0, 5, a.n)).astype(np.int32)
    keep = rng.random(a.n) < 0.8
    assert jax_turbo._format_records(
        a, sub, start, stop, keep, fmt="fasta"
    ) == port_turbo._format_records(b, sub, start, stop, keep, fmt="fasta")


def test_fasta_error_offset_agrees():
    bad = b"ACGT\n>r\nACGT\n"
    with pytest.raises(jax_runtime.FastaParseError) as jax_err:
        jax_runtime.parse_fasta_chunk(bad)
    with pytest.raises(port_runtime.FastaParseError) as port_err:
        port_runtime.parse_fasta_chunk(bad)
    assert jax_err.value.offset == port_err.value.offset


def _lanes():
    """A lane of each package with no stages: only their gather helpers
    are used."""
    kwargs = dict(cut_front=0, cut_back=0, quality=None, nextseq=None,
                  cutter=None, cutter_mod=None)
    return jax_turbo._MateLane(**kwargs), port_turbo._MateLane(
        device="cpu", **kwargs
    )


@pytest.mark.parametrize("alphabet,bits", [("ACGT", 2), ("ACGTNacgtn", 4)])
def test_padded_and_packed_gathers(alphabet, bits):
    rng = seeded("gather", alphabet)
    data = make_fastq(rng, 200, alphabet, max_len=70)
    a = jax_runtime.parse_chunk(data)
    b = port_runtime.parse_chunk(data)
    jax_lane, port_lane = _lanes()
    sub = slice(10, 170)
    batch = 160
    extra = np.minimum(rng.integers(0, 6, batch), a.seq_len[sub]).astype(np.int32)
    width, pad_b = 96, 192
    assert np.array_equal(
        jax_lane._gather(a, sub, a.seq_off, extra, width, pad_b),
        port_lane._gather(b, sub, b.seq_off, extra, width, pad_b),
    )
    assert np.array_equal(
        jax_lane._gather(a, sub, a.qual_off, extra, width),
        port_lane._gather(b, sub, b.qual_off, extra, width),
    )
    jax_pack = jax_turbo._pack_info(a)
    port_pack = port_turbo._pack_info(b)
    assert jax_pack[0] == port_pack[0] == bits
    assert np.array_equal(jax_pack[1], port_pack[1])
    assert np.array_equal(jax_pack[2], port_pack[2])
    expected = jax_lane._gather_packed(
        a, sub, extra, width, pad_b, jax_pack[1], bits
    )
    out = np.full((pad_b, width * bits // 8), 255, np.uint8)
    port_lane._gather_packed(b, sub, extra, width, port_pack[1], bits, out)
    assert np.array_equal(expected, out)


def test_pack_info_declines_wide_alphabets():
    rng = seeded("raw")
    data = make_fastq(rng, 40, "ACGTNacgtnRYKMSWBDHV")
    assert jax_turbo._pack_info(jax_runtime.parse_chunk(data)) is None
    assert port_turbo._pack_info(port_runtime.parse_chunk(data)) is None


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_format_records(fmt):
    rng = seeded("format", fmt)
    data = make_fastq(rng, 120, "ACGTN", repeat_name=True)
    a = jax_runtime.parse_chunk(data)
    b = port_runtime.parse_chunk(data)
    sub = slice(5, 115)
    n = a.seq_len[sub]
    start = np.minimum(rng.integers(0, 8, n.size), n).astype(np.int32)
    stop = np.maximum(start, n - rng.integers(0, 8, n.size)).astype(np.int32)
    keep = rng.random(n.size) < 0.7
    out = port_turbo._format_records(b, sub, start, stop, keep, fmt=fmt)
    assert out == jax_turbo._format_records(a, sub, start, stop, keep, fmt=fmt)
    assert out.count(b"\n") == int(keep.sum()) * (4 if fmt == "fastq" else 2)
    assert a.format_trimmed(
        np.zeros(a.n, np.int32), a.seq_len
    ) == b.format_trimmed(np.zeros(b.n, np.int32), b.seq_len) == data


class _Stage:
    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.trimmed_bases = 0


@pytest.mark.parametrize("nextseq_cut,front,back", [
    (None, 0, 10), (None, 15, 20), (20, 0, 0), (22, 5, 18), (20, None, None),
])
def test_quality_windows(nextseq_cut, front, back):
    rng = seeded("quality", nextseq_cut, front, back)
    data = make_fastq(rng, 180, "ACGTG", max_len=90)
    a = jax_runtime.parse_chunk(data)
    b = port_runtime.parse_chunk(data)
    jax_lane, port_lane = _lanes()
    for lane in (jax_lane, port_lane):
        lane.nextseq = (
            _Stage(cutoff=nextseq_cut, base=33) if nextseq_cut is not None else None
        )
        lane.quality = (
            _Stage(cutoff_front=front, cutoff_back=back, base=33)
            if front is not None
            else None
        )
    sub = slice(0, a.n)
    keep_start = np.minimum(rng.integers(0, 4, a.n), a.seq_len).astype(np.int32)
    win_len = (a.seq_len - keep_start).astype(np.int32)
    expected = jax_lane._native_quality(a, sub, keep_start, win_len, None)
    got = port_lane._native_quality(b, sub, keep_start, win_len)
    for exp, have in zip(expected, got):
        assert np.array_equal(exp, have)
