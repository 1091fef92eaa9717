"""SOLiD colorspace through the port against the JAX package.

The encoding tables and their functions, the colorspace adapter on the
scalar aligner, and the 14 colorspace cases of
``tests/test_trim_colorspace.py`` (``-c`` with FASTA, FASTQ, FASTA + qual
and SRA-FASTQ input; ``--strip-f3``, ``--maq``, ``-x``, ``--trim-primer``,
anchored 5' adapters, ``--no-zero-cap``) through ``atropos_tpu_torch`` on
``cpu``: each must reproduce its golden byte for byte and give the bytes,
summary, report, engine counters and fallback reason ("colorspace": the
engine declines, as the reference's) of ``atropos_tpu``. Tolerance 0.

The case table imports nothing but the port, so that ``chip_smoke.py`` can
run the same cases on the card.
"""
import os

import numpy as np
import pytest

from atropos_tpu_torch.commands import get_command
from atropos_tpu_torch.util import colorspace as port_cs

DATA = os.path.join(os.path.dirname(__file__), "conformance", "data")
EXPECTED = os.path.join(os.path.dirname(__file__), "conformance", "expected")

#: (name, parameters, golden, input, quality file or None): the cases of
#: ``tests/test_trim_colorspace.py`` that compare with a golden
CASES = [
    ("qualtrim_csfastaqual", "-c -q 10", "solidqual.fastq", "solid.csfasta", "solid.qual"),
    ("bwa", "-c -e 0.12 -a 330201030313112312 -x 552: --maq", "solidmaq.fastq",
     "solid.csfasta", "solid.qual"),
    ("bfast", "-c -e 0.12 -a 330201030313112312 -x abc: --strip-f3", "solidbfast.fastq",
     "solid.csfasta", "solid.qual"),
    ("trim_095", "-c -e 0.122 -a 330201030313112312", "solid.fasta", "solid.fasta", None),
    ("solid", "-c -e 0.122 -a 330201030313112312", "solid.fastq", "solid.fastq", None),
    ("solid_basespace_adapter", "-c -e 0.122 -a CGCCTTGGCCGTACAGCAG", "solid.fastq",
     "solid.fastq", None),
    ("solid5p", "-c -e 0.1 --trim-primer -g CCGGAGGTCAGCTCGCTATA", "solid5p.fasta",
     "solid5p.fasta", None),
    ("solid5p_prefix_notrim", "-c -e 0.1 -g ^CCGGAGGTCAGCTCGCTATA",
     "solid5p-anchored.notrim.fasta", "solid5p.fasta", None),
    ("solid5p_prefix", "-c -e 0.1 --trim-primer -g ^CCGGAGGTCAGCTCGCTATA",
     "solid5p-anchored.fasta", "solid5p.fasta", None),
    ("solid5p_fastq", "-c -e 0.1 --trim-primer -g CCGGAGGTCAGCTCGCTATA", "solid5p.fastq",
     "solid5p.fastq", None),
    ("solid5p_prefix_notrim_fastq", "-c -e 0.1 -g ^CCGGAGGTCAGCTCGCTATA",
     "solid5p-anchored.notrim.fastq", "solid5p.fastq", None),
    ("solid5p_prefix_fastq", "-c -e 0.1 --trim-primer -g ^CCGGAGGTCAGCTCGCTATA",
     "solid5p-anchored.fastq", "solid5p.fastq", None),
    ("sra_fastq", "-c -e 0.1 --format sra-fastq -a CGCCTTGGCCGTACAGCAG", "sra.fastq",
     "sra.fastq", None),
    ("no_zero_cap", "--no-zero-cap -c -e 0.122 -a CGCCTTGGCCGTACAGCAG",
     "solid-no-zerocap.fastq", "solid.fastq", None),
]


def case_argv(params, expected, inpath, qualfile, folder):
    """The case's command line (without ``trim``) writing into ``folder``;
    returns (argv, output, report)."""
    out = os.path.join(folder, expected)
    report = os.path.join(folder, "report.txt")
    argv = params.split() + ["-se", os.path.join(DATA, inpath)]
    if qualfile:
        argv += ["-sq", os.path.join(DATA, qualfile)]
    argv += ["-o", out, "--adapter-cache-file", os.path.join(folder, ".adapters"),
             "--report-file", report, "--quiet"]
    return argv, out, report


def test_case_table():
    assert len(CASES) == len({case[0] for case in CASES}) == 14
    assert all(" -c " in " " + case[1] + " " for case in CASES)


def test_tables_equal_the_reference():
    from atropos_tpu.util import colorspace as jax_cs

    assert port_cs.ENCODE == jax_cs.ENCODE
    assert port_cs.DECODE == jax_cs.DECODE


def _outcome(function, argument):
    """The function's result, or the type and text of what it raised."""
    try:
        return function(argument)
    except Exception as err:  # pylint: disable=broad-except
        return type(err).__name__, str(err)


def test_encode_decode_equal_the_reference():
    from atropos_tpu.util import colorspace as jax_cs

    from .test_torch_align import seeded

    rng = seeded("colorspace", 0)
    bases = np.frombuffer(b"ACGTN.", np.uint8)
    for _ in range(300):
        length = int(rng.integers(0, 40))
        nucs = bases[rng.integers(0, 6, length)].tobytes().decode()
        colors = port_cs.encode(nucs)
        assert colors == jax_cs.encode(nucs)
        assert _outcome(port_cs.decode, colors) == _outcome(jax_cs.decode, colors)
        if set(nucs) <= set("ACGT"):
            assert port_cs.decode(colors) == nucs


@pytest.mark.parametrize("where,spec,read", [
    ("back", "330201030313112312", "T0011233" + "330201030313112312" + "012"),
    ("back", "CGCCTTGGCCGTACAGCAG", "G120311" + "3" + port_cs.encode("CGCCTTGGCCGTACAGCAG")[1:]),
    ("front", "CCGGAGGTCAGCTCGCTATA", "T" + port_cs.encode("ACCGGAGGTCAGCTCGCTATAGGT")[1:]),
    ("prefix", "CCGGAGGTCAGCTCGCTATA", "T" + port_cs.encode("TCCGGAGGTCAGCTCGCTATAGGTA")[1:]),
    ("prefix", "CCGGAGGTCAGCTCGCTATA", "G" + port_cs.encode("GCCGGTGGTCAGCTCGCTATAGGTA")[1:]),
])
def test_colorspace_adapter_equals_the_reference(where, spec, read):
    """One adapter, one read: the match and the trimmed read (primer,
    colors, qualities) and the adapter's statistics equal the reference's."""
    from atropos_tpu import adapters as jax_adapters
    from atropos_tpu.io import seqio as jax_seqio
    from atropos_tpu_torch import adapters as port_adapters
    from atropos_tpu_torch.io import seqio as port_seqio

    flag = {"back": "BACK", "front": "FRONT", "prefix": "PREFIX"}[where]
    results = []
    for adapters, seqio in ((jax_adapters, jax_seqio), (port_adapters, port_seqio)):
        adapter = adapters.ColorspaceAdapter(
            spec, getattr(adapters, flag), 0.12, name="cs", min_overlap=3,
        )
        record = seqio.ColorspaceSequence("r", read, "I" * (len(read) - 1))
        match = adapter.match_to(record)
        if match is None:
            results.append(None)
            continue
        trimmed = adapter.trimmed(match)
        results.append((
            (match.astart, match.astop, match.rstart, match.rstop, match.matches,
             match.errors),
            trimmed.primer, trimmed.sequence, trimmed.qualities, adapter.sequence,
            dict(adapter.lengths_front), dict(adapter.lengths_back),
        ))
    assert results[1] is not None and results[0] == results[1]


def test_colorspace_adapter_rejects_what_the_reference_rejects():
    from atropos_tpu import adapters as jax_adapters
    from atropos_tpu_torch import adapters as port_adapters

    for adapters in (jax_adapters, port_adapters):
        with pytest.raises(ValueError, match="5' colorspace adapter"):
            adapters.ColorspaceAdapter("0123", adapters.FRONT, 0.1)
        with pytest.raises(ValueError, match="Wildcards not supported"):
            adapters.ColorspaceAdapter("ACGT", adapters.BACK, 0.1, adapter_wildcards=True)


@pytest.mark.parametrize(
    "name,params,expected,inpath,qualfile", CASES, ids=[case[0] for case in CASES]
)
def test_colorspace_case(tmp_path, monkeypatch, name, params, expected, inpath, qualfile):
    """The golden through the port, then the same argv through both
    packages: same bytes, summary, report, counters and fallback reason."""
    from .conformance_utils import assert_files_equal
    from .test_torch_engine_cli import run_both

    argv, out, report = case_argv(params, expected, inpath, qualfile, str(tmp_path))
    retcode, summary = get_command("trim").execute(argv, device="cpu")
    assert retcode == 0 and "exception" not in summary
    assert summary["mode"] == "serial" and summary["device"] == "cpu"
    assert_files_equal(os.path.join(EXPECTED, expected), out)
    run = run_both(argv, [out], report, monkeypatch)
    build, match = run[4]
    assert build == {"engine": 0, "fallback": 1} and run[5] == "colorspace"
    assert match == {"batched": 0, "scalar_reads": 0}


def test_colorspace_paired_insert_matches_the_reference(tmp_path, monkeypatch):
    """Paired colorspace with the insert aligner: no engine, so each pair's
    insert match runs on the scalar ``MultiAligner`` in both packages."""
    from .test_torch_engine_cli import run_both, tail

    outs = [str(tmp_path / "o1.fastq"), str(tmp_path / "o2.fastq")]
    argv = ["-c", "--aligner", "insert", "-a", "a1=330201030313112312",
            "-A", "a2=330201030313112312", "-e", "0.12",
            "-pe1", os.path.join(DATA, "solid.fastq"),
            "-pe2", os.path.join(DATA, "solid.fastq"),
            "-o", outs[0], "-p", outs[1]] + tail(tmp_path)
    run = run_both(argv, outs, str(tmp_path / "report.txt"), monkeypatch)
    assert run[5] == "colorspace"
