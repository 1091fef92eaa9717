"""The upstream paired-end goldens through the port.

Every case of ``tests/test_trim_pe.py`` is listed here with its command
line and the aligners the reference runs it with. The cases the JAX
package runs through its turbo paired runner go through
``atropos_tpu_torch`` on ``cpu`` and must reproduce
``tests/conformance/expected/`` byte for byte; the others (what the
turbo runner hands to the scalar pipeline, ``--threads``) must raise
``NotPortedError`` naming their ROADMAP.md queue item, before any output
is written.

The case table imports nothing but the port, so that ``chip_smoke.py``
runs the same ported cases on the card.
"""
import os
import shutil

import pytest

from atropos_tpu_torch import ROADMAP_ITEMS, NotPortedError
from atropos_tpu_torch.commands import execute_cli, get_command

CONFORMANCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conformance")


def D(name):
    return os.path.join(CONFORMANCE, "data", name)


def cutpath(name):
    return os.path.join(CONFORMANCE, "expected", name)


def assert_files_equal(expected, actual):
    with open(expected, "rb") as want, open(actual, "rb") as got:
        assert got.read() == want.read(), "{} differs from {}".format(actual, expected)

BOTH = ("adapter", "insert")
ADAPTER = ("adapter",)
INSERT = ("insert",)

#: (name, parameters, input 1, input 2, golden 1, golden 2, aligners);
#: ``{tmp}`` is the test's scratch directory, ``{aligner}`` the aligner
CASES = [
 ("paired_end_legacy", "-a TTAGACATAT -m 14", "paired.1.fastq", "paired.2.fastq",
  "paired.m14.1.fastq", "paired.m14.2.fastq", ADAPTER),
 ("untrimmed_paired_output", "-a TTAGACATAT --untrimmed-output {tmp}/u.1.fastq "
  "--untrimmed-paired-output {tmp}/u.2.fastq", "paired.1.fastq", "paired.2.fastq",
  "paired-trimmed.1.fastq", "paired-trimmed.2.fastq", ADAPTER),
 ("legacy_minlength", "-a XXX -m 27", "paired.1.fastq", "paired.2.fastq",
  "paired-m27.1.fastq", "paired-m27.2.fastq", ADAPTER),
 ("paired_end", "-a TTAGACATAT -A CAGTGGAGTA -m 14", "paired.1.fastq",
  "paired.2.fastq", "paired_{aligner}.1.fastq", "paired_{aligner}.2.fastq", BOTH),
 ("anchored_back_no_indels", "-a BACKADAPTER$ -A BACKADAPTER$ -N --no-indels",
  "anchored-back.fasta", "anchored-back.fasta", "anchored-back.fasta",
  "anchored-back.fasta", ADAPTER),
 ("qualtrim", "-q 20 -a TTAGACATAT -A CAGTGGAGTA -m 14 -M 90", "paired.1.fastq",
  "paired.2.fastq", "pairedq.1.fastq", "pairedq.2.fastq", BOTH),
 ("qualtrim_swapped", "-q 20 -a CAGTGGAGTA -A TTAGACATAT -m 14 "
  "--adapter-max-rmp 0.001", "paired.2.fastq", "paired.1.fastq",
  "pairedq.2.fastq", "pairedq.1.fastq", BOTH),
 ("cut", "-u 3 -u -1 -U 4 -U -2", "paired.1.fastq", "paired.2.fastq",
  "pairedu.1.fastq", "pairedu.2.fastq", ADAPTER),
 ("A_only", "-A CAGTGGAGTA", "paired.1.fastq", "paired.2.fastq",
  "paired-onlyA.1.fastq", "paired-onlyA.2.fastq", ADAPTER),
 ("mask_adapter", "-a CAAG -A TCGA -n 3 --mask-adapter", "back_repeat.1.fastq",
  "back_repeat.2.fastq", "back_repeat.1.fastq", "back_repeat.2.fastq", BOTH),
 ("discard_untrimmed", "-a CTCCAGCTTAGACATATC -A XXXXXXXX --discard-untrimmed",
  "paired.1.fastq", "paired.2.fastq", "empty.fastq", "empty.fastq", ADAPTER),
 ("discard_trimmed", "-A C -O 1 --discard-trimmed", "paired.1.fastq",
  "paired.2.fastq", "empty.fastq", "empty.fastq", ADAPTER),
 ("pair_filter", "--pair-filter=both -a TTAGACATAT -A GGAGTA -m 14",
  "paired.1.fastq", "paired.2.fastq", "paired-filterboth_{aligner}.1.fastq",
  "paired-filterboth_{aligner}.2.fastq", BOTH),
 ("too_short_paired_output", "-a TTAGACATAT -A CAGTGGAGTA -m 14 "
  "--too-short-output {tmp}/s.1.fastq --too-short-paired-output {tmp}/s.2.fastq",
  "paired.1.fastq", "paired.2.fastq", "paired_{aligner}.1.fastq",
  "paired_{aligner}.2.fastq", BOTH),
 ("too_long_output", "-a TTAGACATAT -A CAGTGGAGTA -M 14 "
  "--too-long-output {tmp}/l.1.fastq --too-long-paired-output {tmp}/l.2.fastq",
  "paired.1.fastq", "paired.2.fastq", "paired-too-short.1.fastq",
  "paired-too-short.2.fastq", BOTH),
 ("custom_bisulfite_1", "-a TTAGACATAT -A CAGTGGAGTA -m 14 -q 0 "
  "--bisulfite 2,2,1,1", "paired_bis_{aligner}.1.fastq",
  "paired_bis_{aligner}.2.fastq", "paired_bis1_{aligner}.1.fastq",
  "paired_bis1_{aligner}.2.fastq", BOTH),
 ("custom_bisulfite_2", "-a TTAGACATAT -A CAGTGGAGTA -m 10 -q 0 "
  "--bisulfite 20,20,1,1;0,0,0,0", "paired_bis_{aligner}.1.fastq",
  "paired_bis_{aligner}.2.fastq", "paired_bis2_{aligner}.1.fastq",
  "paired_bis2_{aligner}.2.fastq", BOTH),
 ("no_insert_match", "-a AGATCGGAAGAGCACACGTCTGAACTCCAGTCACCAGATCATCTCGTATGCCGTCTTCTGCTTG "
  "-A AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATT "
  "-e 0.3 --adapter-max-rmp 0.001 -m 25 -q 0 --trim-n", "insert.1.fastq",
  "insert.2.fastq", "insert.1.fastq", "insert.2.fastq", INSERT),
 ("overwrite", "-w 10,30,10", "lowq.fastq", "highq.fastq", "lowq.fastq",
  "highq.fastq", ADAPTER),
 ("issue68", "--error-rate 0.20 --insert-match-error-rate 0.30 --minimum-length 20 "
  "-a AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC "
  "-A AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATT",
  "issue68.1.fq", "issue68.2.fq", "issue68.1.fq", "issue68.2.fq", INSERT),
 ("no_writer_process", "--threads 3 --no-writer-process --batch-size 1 "
  "-a AGATCGGAAGAGCACACGTCTGAACTCCAGTCACACAGTGATCTCGTATGCCGTCTTCTGCTTG "
  "-A AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATT",
  "big.1.fq", "big.2.fq", "out.1.fastq", "out.2.fastq", BOTH),
 ("summary_threads", "--threads 2 "
  "-a AGATCGGAAGAGCACACGTCTGAACTCCAGTCACACAGTGATCTCGTATGCCGTCTTCTGCTTG "
  "-A AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATT",
  "big.1.fq", "big.2.fq", "out.1.fastq", "out.2.fastq", BOTH),
 ("issue122_empty_gz_outputs", "--threads 2 --preserve-order "
  "--no-default-adapters -a TTAGACATAT -A CAGTGGAGTA", "empty.fastq",
  "empty.fastq", "empty.fastq.gz", "empty.fastq.gz", ADAPTER),
]

#: cases outside the slice -> the topic of the ROADMAP.md item they wait for
NOT_PORTED = {
    "mask_adapter": "engine",
    "no_writer_process": "multi-gpu",
    "summary_threads": "multi-gpu",
    "issue122_empty_gz_outputs": "multi-gpu",
}

#: second outputs of the ported cases: file written -> golden file
SIDE_OUTPUTS = {
    "untrimmed_paired_output": (
        ("u.1.fastq", "paired-untrimmed.1.fastq"),
        ("u.2.fastq", "paired-untrimmed.2.fastq"),
    ),
    "too_short_paired_output": (
        ("s.1.fastq", "paired-too-short.1.fastq"),
        ("s.2.fastq", "paired-too-short.2.fastq"),
    ),
    "too_long_output": (
        ("l.1.fastq", "paired_{aligner}.1.fastq"),
        ("l.2.fastq", "paired_{aligner}.2.fastq"),
    ),
}


def _expand(cases):
    return [
        (name, aligner) + tuple(rest)
        for name, *rest, aligners in cases
        for aligner in aligners
    ]


PORTED = _expand(c for c in CASES if c[0] not in NOT_PORTED)
UNPORTED = _expand(c for c in CASES if c[0] in NOT_PORTED)


def _argv(params, aligner, in1, in2, exp1, exp2, tmp_path):
    out1 = str(tmp_path / ("tmp1-" + exp1.format(aligner=aligner)))
    out2 = str(tmp_path / ("tmp2-" + exp2.format(aligner=aligner)))
    argv = params.replace("{tmp}", str(tmp_path)).split()
    argv += ["--aligner", aligner, "-o", out1, "-p", out2]
    argv += ["-pe1", D(in1.format(aligner=aligner))]
    argv += ["-pe2", D(in2.format(aligner=aligner))]
    argv += ["--adapter-cache-file", str(tmp_path / ".adapters")]
    argv += ["--report-file", str(tmp_path / "report.txt"), "--quiet"]
    return argv, out1, out2


def _ids(cases):
    return ["{}-{}".format(c[0], c[1]) for c in cases]


def test_case_table_is_complete():
    assert len({case[0] for case in CASES}) == len(CASES) == 23
    assert set(NOT_PORTED) <= {case[0] for case in CASES}
    assert set(NOT_PORTED.values()) <= set(ROADMAP_ITEMS)
    assert len(PORTED) == 27


@pytest.mark.parametrize(
    "name,aligner,params,in1,in2,exp1,exp2", PORTED, ids=_ids(PORTED)
)
def test_golden(name, aligner, params, in1, in2, exp1, exp2, tmp_path):
    argv, out1, out2 = _argv(params, aligner, in1, in2, exp1, exp2, tmp_path)
    retcode, summary = get_command("trim").execute(argv, device="cpu")
    assert "exception" not in summary, summary.get("exception")
    assert retcode == 0
    assert summary["mode"] == "turbo" and summary["device"] == "cpu"
    assert_files_equal(cutpath(exp1.format(aligner=aligner)), out1)
    assert_files_equal(cutpath(exp2.format(aligner=aligner)), out2)
    for written, golden in SIDE_OUTPUTS.get(name, ()):
        assert_files_equal(
            cutpath(golden.format(aligner=aligner)), str(tmp_path / written)
        )


@pytest.mark.parametrize(
    "name,aligner,params,in1,in2,exp1,exp2", UNPORTED, ids=_ids(UNPORTED)
)
def test_outside_the_slice_raises(name, aligner, params, in1, in2, exp1, exp2,
                                  tmp_path):
    argv, out1, out2 = _argv(params, aligner, in1, in2, exp1, exp2, tmp_path)
    with pytest.raises(NotPortedError) as err:
        get_command("trim").execute(argv, device="cpu")
    assert err.value.topic == NOT_PORTED[name]
    assert ROADMAP_ITEMS[NOT_PORTED[name]] in str(err.value)
    assert not os.path.exists(out1) and not os.path.exists(out2)


@pytest.mark.parametrize("aligner", BOTH)
def test_interleaved(aligner, tmp_path):
    out = str(tmp_path / "interleaved.fastq")
    argv = "-q 20 -a TTAGACATAT -A CAGTGGAGTA -m 14 -M 90".split() + [
        "--aligner", aligner, "-l", D("interleaved.fastq"), "-L", out,
        "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"), "--quiet",
    ]
    retcode, summary = get_command("trim").execute(argv, device="cpu")
    assert retcode == 0 and summary["mode"] == "turbo"
    assert_files_equal(cutpath("interleaved.fastq"), out)


def test_explicit_format_with_paired(tmp_path):
    txt1, txt2 = str(tmp_path / "paired.1.txt"), str(tmp_path / "paired.2.txt")
    shutil.copyfile(D("paired.1.fastq"), txt1)
    shutil.copyfile(D("paired.2.fastq"), txt2)
    out1, out2 = str(tmp_path / "o.1.fastq"), str(tmp_path / "o.2.fastq")
    argv = "--format=fastq -a TTAGACATAT -m 14".split() + [
        "-o", out1, "-p", out2, "-pe1", txt1, "-pe2", txt2,
        "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"), "--quiet",
    ]
    retcode, summary = get_command("trim").execute(argv, device="cpu")
    assert retcode == 0 and summary["mode"] == "turbo"
    assert_files_equal(cutpath("paired.m14.1.fastq"), out1)
    assert_files_equal(cutpath("paired.m14.2.fastq"), out2)


@pytest.mark.parametrize("reverse", [False, True], ids=["legacy", "both"])
def test_no_trimming(reverse):
    """Nothing trimmed must not divide by zero."""
    argv = ["-a", "XXXXX"] + (["-A", "XXXXX"] if reverse else []) + [
        "-o", os.devnull, "-p", os.devnull,
        "-pe1", D("paired.1.fastq"), "-pe2", D("paired.2.fastq"),
        "--no-cache-adapters", "--no-default-adapters", "--quiet",
    ]
    assert execute_cli(["trim"] + argv, device="cpu") == 0


def _truncated(tmp_path, which):
    path = str(tmp_path / "truncated.{}.fastq".format(which))
    with open(D("paired.{}.fastq".format(which))) as infile:
        lines = infile.readlines()[:-4]
    with open(path, "w") as out:
        out.writelines(lines)
    return path


def _swapped(tmp_path, which):
    path = str(tmp_path / "swapped.1.fastq")
    with open(D("paired.1.fastq")) as infile:
        lines = infile.readlines()
    with open(path, "w") as out:
        out.writelines(lines[0:4] + lines[8:12] + lines[4:8] + lines[12:])
    return path


@pytest.mark.parametrize(
    "make,which",
    [(_truncated, 1), (_truncated, 2), (_swapped, 1)],
    ids=["first_too_short", "second_too_short", "unmatched_read_names"],
)
def test_improper_pairs_fail(make, which, tmp_path):
    inputs = [D("paired.1.fastq"), D("paired.2.fastq")]
    inputs[which - 1] = make(tmp_path, which)
    retcode, _ = get_command("trim").execute(
        [
            "-a", "XX", "-o", str(tmp_path / "out1.fastq"),
            "-p", str(tmp_path / "out2.fastq"),
            "-pe1", inputs[0], "-pe2", inputs[1],
            "--no-cache-adapters", "--no-default-adapters", "--quiet",
            "--report-file", str(tmp_path / "r.txt"),
        ],
        device="cpu",
    )
    assert retcode != 0


@pytest.mark.parametrize(
    "argv",
    [
        ["-a", "TTAGACATAT", "-A", "CAGTGGAGTA", "-m", "14",
         "--too-short-output", "{tmp}/s.1.fastq", "-pe1", D("paired.1.fastq"),
         "-pe2", D("paired.2.fastq"), "-o", "{tmp}/o1", "-p", "{tmp}/o2"],
        ["-a", "XX", "--paired-output", "{tmp}/out.fastq",
         "-pe1", D("paired.1.fastq"), "-pe2", D("paired.2.fastq")],
        ["-a", "XX", "-A", "XX", "-l", D("interleaved.fastq"),
         "-o", "{tmp}/out.1.fastq"],
    ],
    ids=["too_short_paired_option_missing", "missing_file",
         "interleaved_no_paired_output"],
)
def test_command_line_errors(argv, tmp_path):
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv] + [
        "--quiet", "--no-cache-adapters", "--no-default-adapters",
    ]
    with pytest.raises(SystemExit):
        get_command("trim").execute(argv, device="cpu")
