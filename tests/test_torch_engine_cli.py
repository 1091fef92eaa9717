"""The per-record pipeline and its batched engine against the JAX package.

Every configuration the turbo runner declines runs through the trim
command's serial mode. The same argv through ``atropos_tpu`` and through
``atropos_tpu_torch`` on ``cpu`` gives ``mode`` "serial" from both,
byte-identical outputs, equal summaries, equal reports (from their
trimming section on: the header holds the times) and equal changes of the
engines' ``BUILD_COUNTS`` and ``MATCH_COUNTS``, over a seeded fuzz of the
options of the slice, single-end and paired-end, also on SAM and FASTA +
qual input and with per-record ``--stats``. For every decline reason of
the turbo runner that the command line can reach, both packages choose
the same mode.

All inputs are made from a seed with numpy; every adapter is named;
tolerance 0.
"""
import itertools
import os
import sys

import pytest
import torch

from atropos_tpu import commands as jax_commands
from atropos_tpu import engine as jax_engine
from atropos_tpu.adapters import parser as jax_parser
from atropos_tpu_torch import commands as port_commands
from atropos_tpu_torch import engine as port_engine
from atropos_tpu_torch.adapters import parser as port_parser

from .conformance_utils import datapath
from .test_torch_align import seeded
from .test_torch_turbo_pe import AD1, AD2, make_pairs, write_pairs
from .test_torch_turbo_se import ANYWHERE, FRONT, TRUSEQ, _comparable, make_reads, write_reads

torch.set_num_threads(1)

LINKED = "link=" + FRONT + "..." + ANYWHERE


def _report_sections(path):
    with open(path, "rb") as handle:
        data = handle.read()
    return data[data.index(b"--------\nTrimming"):]


def _counters(engine_mod):
    return dict(engine_mod.BUILD_COUNTS), dict(engine_mod.MATCH_COUNTS)


def _deltas(before, after):
    return [
        {key: after_part[key] - before_part[key] for key in after_part}
        for before_part, after_part in zip(before, after)
    ]


def run_package(which, argv, out_paths, report, monkeypatch, stdin=None,
                stdout=None):
    """One argv through one package; returns (mode, {path: bytes},
    comparable summary, report sections, counter changes, the fallback
    reason the run recorded, None if it built an engine or none at all). ``stdin``/``stdout`` name files that stand in
    for the standard streams. Both packages number the adapters without a
    name (a linked adapter's parts among them) from 1 for the run, as a
    fresh process would: each keeps its counter for the life of the
    process, and the tests share processes."""
    for path in out_paths + [report]:
        if os.path.exists(path):
            os.remove(path)
    engine_mod = jax_engine if which == "jax" else port_engine
    before = _counters(engine_mod)
    handles = []
    with monkeypatch.context() as patch:
        patch.setattr(jax_parser if which == "jax" else port_parser, "_ADAPTER_IDS",
                      itertools.count(1))
        # the reason this run records: a run that builds no engine (the
        # statistics wrapper) records none, whatever an earlier test left
        patch.setattr(engine_mod, "LAST_FALLBACK_REASON", None)
        if stdin is not None:
            handles.append(open(stdin))
            patch.setattr(sys, "stdin", handles[-1])
        if stdout is not None:
            handles.append(open(stdout, "w"))
            patch.setattr(sys, "stdout", handles[-1])
        try:
            if which == "jax":
                retcode, summary = jax_commands.get_command("trim").execute(argv)
            else:
                retcode, summary = port_commands.get_command("trim").execute(
                    argv, device="cpu"
                )
        finally:
            for handle in handles:
                handle.close()
        reason = engine_mod.LAST_FALLBACK_REASON
    assert retcode == 0
    files = {}
    for path in out_paths + ([stdout] if stdout else []):
        if os.path.exists(path):
            with open(path, "rb") as handle:
                files[path] = handle.read()
    return (
        summary["mode"], files, _comparable(summary), _report_sections(report),
        _deltas(before, _counters(engine_mod)), reason,
    )


def run_both(argv, out_paths, report, monkeypatch, stdin=None, stdout=None,
             mode="serial"):
    """``argv`` through both packages: both choose ``mode`` and agree on
    every output byte, the summary, the report, the counters' changes and
    the fallback reason. Returns the port's result."""
    jax_run = run_package("jax", argv, out_paths, report, monkeypatch, stdin, stdout)
    port_run = run_package("port", argv, out_paths, report, monkeypatch, stdin, stdout)
    label = " ".join(argv)
    assert jax_run[0] == mode, label
    for part, name in zip(range(6), ("mode", "files", "summary", "report",
                                     "counters", "fallback reason")):
        assert jax_run[part] == port_run[part], label + ": " + name
    return port_run


def tail(tmp_path):
    return [
        "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"),
    ]


# -- single-end fuzz ------------------------------------------------------------

SE_ADAPTERS = (
    ["-a", "tru=" + TRUSEQ], ["-g", "front=" + FRONT], ["-b", "anyw=" + ANYWHERE],
    ["-a", LINKED], ["-a", "anch=" + TRUSEQ[:12] + "$"], ["-g", "pre=^" + FRONT],
    ["-a", "wild=ACGTNNNACGTRYK"],
)

#: options of the slice the turbo runner declines: each draw takes one or more
SE_DECLINED = (
    "times", "mask", "no_trim", "length_tag", "strip_suffix", "suffix", "prefix",
    "subsample", "stdin", "stdout", "linked", "op_order",
)


def random_se_config(rng):
    parts = []
    picks = rng.permutation(len(SE_ADAPTERS))[: int(rng.integers(1, 4))]
    declined = set(
        SE_DECLINED[int(i)]
        for i in rng.permutation(len(SE_DECLINED))[: int(rng.integers(1, 4))]
    )
    # a linked adapter goes alone: beside others, the best-match choice of
    # both packages (scalar and batched) compares a LinkedMatch's
    # ``matches``, which it lacks (test_failures_both_packages_share)
    if "linked" in declined:
        picks = [3]
    else:
        picks = [idx for idx in picks if idx != 3] or [0]
    for idx in picks:
        parts += SE_ADAPTERS[int(idx)]
    if "times" in declined:
        parts += ["-n", str(int(rng.integers(2, 4)))]
    if "mask" in declined and "linked" not in declined:
        # (a linked match cannot be masked: test_failures_both_packages_share)
        parts += ["--mask-adapter"]
    if "no_trim" in declined and "mask" not in declined:
        parts += ["--no-trim"]
    if "length_tag" in declined:
        parts += ["--length-tag", "length="]
    if "strip_suffix" in declined:
        parts += ["--strip-suffix", "7"]
    if "suffix" in declined:
        parts += ["-y", "_{name}"]
    if "prefix" in declined:
        parts += ["-x", "pre_"]
    if "subsample" in declined:
        parts += ["--subsample", "0.6", "--subsample-seed", str(int(rng.integers(1, 99)))]
    if rng.random() < 0.4 or "op_order" in declined:
        parts += ["-u", str(int(rng.integers(1, 6)))]
        parts += ["-q", str(int(rng.integers(5, 25)))]
        if "op_order" in declined:
            parts += ["--op-order", "".join(rng.permutation(list("ACGQW")))]
    if rng.random() < 0.3:
        parts += ["--no-indels"]
    if rng.random() < 0.5:
        parts += ["-e", ("0.1", "0.2")[int(rng.integers(2))]]
    if rng.random() < 0.4:
        parts += ["-O", ("3", "5")[int(rng.integers(2))]]
    if rng.random() < 0.3:
        parts += ["--trim-n"]
    if rng.random() < 0.5:
        parts += ["-m", str(int(rng.integers(1, 30)))]
    if rng.random() < 0.2:
        parts += ["--discard-untrimmed"]
    return parts, declined


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_single_end_serial(tmp_path, monkeypatch, seed):
    rng = seeded("engine-se", seed)
    parts, declined = random_se_config(rng)
    alphabet = ("ACGT", "ACGTN", "ACGTNRYKMSWBDHVX")[int(rng.integers(3))]
    records = make_reads(
        rng, 220, alphabet, max_len=(110, 300)[int(rng.random() < 0.2)],
        lowercase=(0.0, 0.2)[int(rng.integers(2))],
        adapters=(TRUSEQ, FRONT, ANYWHERE, FRONT + "ACGT" + ANYWHERE),
    )
    inp = write_reads(str(tmp_path / "in.fastq"), records)
    outs = []
    argv = list(parts)
    stdin = stdout = None
    if "stdin" in declined:
        stdin = inp
        argv += ["-se", "-"]
    else:
        argv += ["-se", inp]
    if "stdout" in declined:
        stdout = str(tmp_path / "stdout.fastq")
        argv += ["-o", "-"]
    else:
        outs.append(str(tmp_path / "out.fastq"))
        argv += ["-o", outs[-1]]
    if rng.random() < 0.3:
        outs.append(str(tmp_path / "info.txt"))
        argv += ["--info-file", outs[-1]]
    if "-m" in parts and rng.random() < 0.5:
        outs.append(str(tmp_path / "short.fastq"))
        argv += ["--too-short-output", outs[-1]]
    run = run_both(argv + tail(tmp_path), outs, str(tmp_path / "report.txt"),
                   monkeypatch, stdin, stdout)
    build, match = run[4]
    assert build == {"engine": 1, "fallback": 0}
    assert match["batched"] > 0 and match["scalar_reads"] == 0


# -- paired-end fuzz --------------------------------------------------------------

PE_DECLINED = ("merge", "swift", "overwrite", "times", "mask", "suffix", "subsample")


def random_pe_config(rng, tmp_path):
    """(argv parts, extra outputs, declined options)."""
    declined = set(
        PE_DECLINED[int(i)]
        for i in rng.permutation(len(PE_DECLINED))[: int(rng.integers(1, 3))]
    )
    aligner = ("adapter", "insert")[int(rng.integers(2))]
    if "overwrite" in declined:
        aligner = "insert"  # the turbo runner overwrites with the adapter aligner
    parts = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2]
    outs = []
    if aligner == "adapter" and rng.random() < 0.3:
        parts += ["-G", "pre2=^" + AD2[:10]]
    parts += ["-e", ("0.1", "0.2")[int(rng.integers(2))]]
    if "merge" in declined:
        parts += ["-R"]
        if rng.random() < 0.6:
            outs.append(str(tmp_path / "merged.fastq"))
            parts += ["--merged-output", outs[-1]]
        if aligner == "adapter" and rng.random() < 0.6:
            parts += ["--correct-mismatches", ("N", "conservative", "liberal")[int(rng.integers(3))]]
    if "swift" in declined:
        parts += ["--bisulfite", "swift"]
    if "overwrite" in declined:
        parts += ["-w", "{},{},{}".format(int(rng.integers(5, 15)), int(rng.integers(20, 35)),
                                          int(rng.integers(5, 15)))]
        if rng.random() < 0.5:
            parts += ["--op-order", "WCGQA"]
    if "times" in declined:
        parts += ["-n", str(int(rng.integers(2, 4)))]
    if "mask" in declined:
        parts += [("--mask-adapter", "--no-trim")[int(rng.integers(2))]]
    if "suffix" in declined:
        parts += ["-y", "_{name}", "--length-tag", "length="]
    if "subsample" in declined:
        parts += ["--subsample", "0.7", "--subsample-seed", str(int(rng.integers(1, 99)))]
    if rng.random() < 0.4:
        parts += ["-q", str(int(rng.integers(5, 30)))]
    if rng.random() < 0.4:
        parts += ["-m", str(int(rng.integers(1, 40)))]
    if rng.random() < 0.3:
        parts += ["--pair-filter", ("any", "both")[int(rng.integers(2))]]
    return parts, outs, declined


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_paired_end_serial(tmp_path, monkeypatch, seed):
    rng = seeded("engine-pe", seed)
    parts, side_outs, declined = random_pe_config(rng, tmp_path)
    pairs = make_pairs(
        rng, 130, (80, 120)[int(rng.integers(2))],
        ("ACGT", "ACGTN")[int(rng.integers(2))], n_rate=0.01,
        poly_a=int(rng.integers(0, 3)),
    )
    # no merged output beside an interleaved one: both packages then format
    # a merged read as a pair and fail (test_failures_both_packages_share)
    interleaved = rng.random() < 0.3 and not side_outs
    inputs = write_pairs(tmp_path, pairs, interleaved=interleaved)
    if interleaved:
        outs = [str(tmp_path / "out.il.fastq")]
        io = ["-l", inputs[0], "-L", outs[0]]
    else:
        outs = [str(tmp_path / "out.1.fastq"), str(tmp_path / "out.2.fastq")]
        io = ["-pe1", inputs[0], "-pe2", inputs[1], "-o", outs[0], "-p", outs[1]]
    run = run_both(parts + io + tail(tmp_path), outs + side_outs,
                   str(tmp_path / "report.txt"), monkeypatch)
    build, match = run[4]
    assert build == {"engine": 1, "fallback": 0}
    assert match["scalar_reads"] == 0


# -- SAM, FASTA + qual and per-record --stats: the fuzz over other inputs --------


def _write_sam(path, records, paired=False):
    """Unaligned SAM records (flag 4; pairs: 77 and 141 under one name)."""
    with open(path, "w") as out:
        out.write("@HD\tVN:1.6\tSO:queryname\n")
        for record in records:
            mates = record if paired else (record,)
            for flag, (name, seq, qual) in zip(("77", "141") if paired else ("4",), mates):
                if paired:
                    name = name[:-2]
                # a one-base read of quality 9 would spell SAM's "no
                # qualities" ("*"); both packages read it so
                qual = qual if qual != "*" else "+"
                out.write("\t".join([name, flag, "*", "0", "0", "*", "*", "0", "0",
                                     seq or "*", qual or "*"]) + "\n")
    return path


def _write_fasta_qual(folder, records):
    fasta, qual = os.path.join(folder, "in.fasta"), os.path.join(folder, "in.qual")
    with open(fasta, "w") as fa, open(qual, "w") as qu:
        for name, seq, quals in records:
            fa.write(">{}\n{}\n".format(name, seq))
            qu.write(">{}\n{}\n".format(name, " ".join(str(ord(q) - 33) for q in quals)))
    return fasta, qual


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_single_end_formats(tmp_path, monkeypatch, seed):
    """The single-end fuzz's options on SAM or FASTA + qual input, now and
    then with ``--stats`` (with tiles: Illumina names), through both
    packages: the pipeline, its batched engine where no statistics are
    collected, per record on the scalar aligner where they are."""
    rng = seeded("engine-se-formats", seed)
    parts, declined = random_se_config(rng)
    parts = [part for part in parts if part not in ("--subsample", "0.6")]
    if "--subsample-seed" in parts:
        at = parts.index("--subsample-seed")
        del parts[at : at + 2]
    records = make_reads(rng, 160, ("ACGT", "ACGTN")[int(rng.integers(2))], max_len=120,
                         adapters=(TRUSEQ, FRONT, ANYWHERE))
    records = [(name, seq, qual) for name, seq, qual in records if seq]
    stats = ("", "pre", "both", "both:tiles")[int(rng.integers(4))]
    if stats.endswith("tiles"):
        records = [("A0:1:FC:1:{}:{}:{}".format(1101 + i % 5, i, i),) + record[1:]
                   for i, record in enumerate(records)]
    if seed % 2:
        io = ["-se", _write_sam(str(tmp_path / "in.sam"), records)]
    else:
        fasta, qual = _write_fasta_qual(str(tmp_path), records)
        io = ["-se", fasta, "-sq", qual]
    out = str(tmp_path / "out.fastq")
    io += ["-o", out]
    if stats:
        io += ["--stats", stats, "--batch-size", "64"]
    run = run_both(parts + io + tail(tmp_path), [out], str(tmp_path / "report.txt"),
                   monkeypatch)
    build, match = run[4]
    assert build == ({"engine": 0, "fallback": 0} if stats else {"engine": 1, "fallback": 0})
    assert match["scalar_reads"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_paired_end_sam(tmp_path, monkeypatch, seed):
    """The paired-end fuzz's options on one SAM of pairs (``-l``)."""
    rng = seeded("engine-pe-sam", seed)
    parts, side_outs, _ = random_pe_config(rng, tmp_path)
    pairs = make_pairs(rng, 100, (80, 120)[int(rng.integers(2))], "ACGT", n_rate=0.01)
    pairs = [pair for pair in pairs if pair[0][1] and pair[1][1]]
    sam = _write_sam(str(tmp_path / "pairs.sam"), pairs, paired=True)
    outs = [str(tmp_path / "out.1.fastq"), str(tmp_path / "out.2.fastq")]
    run = run_both(parts + ["-l", sam, "-o", outs[0], "-p", outs[1]] + tail(tmp_path),
                   outs + side_outs, str(tmp_path / "report.txt"), monkeypatch)
    assert run[4][0] == {"engine": 1, "fallback": 0}


# -- the mode of every decline reason ----------------------------------------------

SMALL = datapath("small.fastq")
PAIRED = (datapath("paired.1.fastq"), datapath("paired.2.fastq"))

#: (argv without outputs, paired?, the mode both packages must choose)
MODE_CASES = [
    (["-a", "ad=TTAGACATATCTCCGTCG"], False, "turbo"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--times", "2"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--mask-adapter"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--no-trim"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--subsample", "0.5", "--subsample-seed", "3"],
     False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "-y", "_{name}"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "-x", "pre_"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--length-tag", "length="], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--strip-suffix", "1"], False, "serial"),
    (["-a", "link=TTAGACATAT...CTCCGTCG"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "-u", "3", "-q", "10", "--op-order", "ACGQW"],
     False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--bisulfite", "rrbs"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--zero-cap"], False, "serial"),
    (["-u", "3", "-y", "_x"], False, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "-o", "-"], False, "serial"),
    (["--aligner", "adapter", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA"], True, "turbo"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA"], True, "turbo"),
    (["--aligner", "adapter", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA", "-R"],
     True, "serial"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "--bisulfite", "swift"], True, "serial"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "-w", "10,30,10"], True, "serial"),
    (["--aligner", "adapter", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "-w", "10,30,10", "-u", "2", "-q", "10", "--op-order", "CGWQA"], True, "serial"),
    (["--aligner", "adapter", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "-w", "10,30,10", "--info-file", "{tmp}/info.txt"], True, "serial"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "-n", "2"], True, "serial"),
    (["-a", "ad=TTAGACATATCTCCGTCG", "--stats", "both", "--times", "2"], False, "serial"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "--correct-mismatches", "liberal"], True, "turbo"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "--correct-mismatches", "N", "--stats", "both"], True, "serial"),
    (["--aligner", "insert", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA",
      "--correct-mismatches", "conservative", "--info-file", "{tmp}/info.txt"],
     True, "serial"),
]


@pytest.mark.parametrize(
    "parts,paired,mode", MODE_CASES, ids=[" ".join(c[0][-3:]) for c in MODE_CASES]
)
def test_both_packages_choose_the_same_mode(tmp_path, monkeypatch, parts, paired, mode):
    parts = [p.replace("{tmp}", str(tmp_path)) for p in parts]
    outs = [p for p in parts if p.startswith(str(tmp_path))]
    stdout = None
    if paired:
        outs += [str(tmp_path / "out.1.fastq"), str(tmp_path / "out.2.fastq")]
        io = ["-pe1", PAIRED[0], "-pe2", PAIRED[1], "-o", outs[-2], "-p", outs[-1]]
    elif "-o" in parts:
        stdout = str(tmp_path / "stdout.fastq")
        io = ["-se", SMALL]
    else:
        outs.append(str(tmp_path / "out.fastq"))
        io = ["-se", SMALL, "-o", outs[-1]]
    run_both(parts + io + tail(tmp_path), outs, str(tmp_path / "report.txt"),
             monkeypatch, stdout=stdout, mode=mode)


LINKED_READS = [
    ("r{}".format(i), "TTAGACATAT" + "ACGT" * i + "CTCCGTCG" + "GATTACA", "I" * (25 + 4 * i))
    for i in range(4)
]


@pytest.mark.parametrize("parts,paired", [
    (["-a", "ad=TTAGACATATCTCCGTCG", "-a", "link=TTAGACATAT...CTCCGTCG"], False),
    (["-a", "link=TTAGACATAT...CTCCGTCG", "--mask-adapter"], False),
    (["--aligner", "adapter", "-a", "ad1=TTAGACATAT", "-A", "ad2=CAGTGGAGTA", "-R",
      "--merged-output", "{tmp}/merged.fastq"], True),
])
def test_failures_both_packages_share(tmp_path, parts, paired):
    """Configurations that fail in ``atropos_tpu``'s scalar pipeline and
    engine alike fail in the port too, with the same return code: a linked
    adapter beside another one (the best match compares a ``LinkedMatch``'s
    ``matches``, which it lacks), a linked match masked (``--mask-adapter``
    sorts the matches by ``astart``, which it lacks), and ``-R
    --merged-output`` with interleaved output (a merged read is formatted
    as a pair)."""
    parts = [p.replace("{tmp}", str(tmp_path)) for p in parts]
    if paired:
        io = ["-l", datapath("interleaved.fastq"), "-L", str(tmp_path / "out.fastq")]
    else:
        inp = write_reads(str(tmp_path / "in.fastq"), LINKED_READS)
        io = ["-se", inp, "-o", str(tmp_path / "out.fastq")]
    argv = parts + io + tail(tmp_path)
    jax_rc, jax_summary = jax_commands.get_command("trim").execute(argv)
    port_rc, port_summary = port_commands.get_command("trim").execute(argv, device="cpu")
    assert jax_rc == port_rc == 1
    assert jax_summary["mode"] == port_summary["mode"] == "serial"
