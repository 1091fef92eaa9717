"""The qc, detect and error commands against the JAX package.

The same argv through ``atropos_tpu`` and through ``atropos_tpu_torch`` on
``cpu`` gives the same exit code, the same route (summary ``mode``), equal
summaries less the timing fields and the port's ``device``, and equal
reports (txt less the header's command line and times; json, yaml and
pickle as data, less the same fields; FASTA byte for byte): for qc on its
native route and on its record route, error with both estimators, detect
with the known, heuristic and khmer detectors, single-end and paired,
with every report format, over a seeded fuzz of their options, and for
detect under two string-hash seeds in subprocesses. ``--progress msg``
logs the same progress lines in both. All inputs are made with numpy
from a seed; every adapter is named; tolerance 0.
"""
import json
import logging
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from atropos_tpu import commands as jax_commands
from atropos_tpu_torch import commands as port_commands

from .test_torch_align import seeded
from .test_torch_turbo_se import _plain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUSEQ_INDEX = (
    "AGATCGGAAGAGCACACGTCTGAACTCCAGTCACACAGTGATCTCGTATGCCGTCTTCTGCTTG"
)
AD2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
BASES = np.frombuffer(b"ACGT", np.uint8)
#: summary fields that differ between two runs of the same argv
IGNORED = ("timing", "program", "version", "mode", "device")
#: report lines that hold the command line, the times or the report's path
HEADER = re.compile(r"Command line|Start time|Wallclock|CPU time")


# -- data ---------------------------------------------------------------------


def _read(rng, read_len, adapter, share):
    """One read: random bases, at the rate ``share`` ``adapter`` (1 %
    substitutions) from a random offset, now and then an N or a poly-A
    tail."""
    seq = BASES[rng.integers(0, 4, read_len)].copy()
    if rng.random() < share:
        at = int(rng.integers(10, read_len - 20))
        frag = np.frombuffer(adapter.encode(), np.uint8)[: read_len - at].copy()
        subs = rng.random(frag.shape[0]) < 0.01
        frag[subs] = BASES[rng.integers(0, 4, int(subs.sum()))]
        seq[at : at + frag.shape[0]] = frag
    roll = rng.random()
    if roll < 0.05:
        seq[int(rng.integers(read_len))] = ord("N")
    elif roll < 0.08:
        seq[-int(rng.integers(10, 30)) :] = ord("A")
    return seq.tobytes().decode()


def _qual(rng, read_len):
    return (rng.integers(2, 42, read_len) + 33).astype(np.uint8).tobytes().decode()


def illumina_name(i, tiles=5):
    return "M0:12:FC0:1:{}:{}:{}".format(1101 + i % tiles, 100 + i, 200 + i)


def write_reads(path, rng, n_reads, read_len=100, adapter=TRUSEQ_INDEX, fmt="fastq",
                mate=None, share=0.5):
    """A FASTQ (or FASTA) file of ``n_reads`` seeded reads with Illumina
    names; ``mate`` (1 or 2) adds the mate's comment."""
    with open(path, "w") as out:
        for i in range(n_reads):
            name = illumina_name(i) + ("" if mate is None else " {}:N:0:1".format(mate))
            seq = _read(rng, read_len, adapter, share)
            if fmt == "fastq":
                out.write("@{}\n{}\n+\n{}\n".format(name, seq, _qual(rng, read_len)))
            else:
                out.write(">{}\n{}\n".format(name, seq))
    return path


def write_pairs(tmp_path, rng, n_pairs, read_len=100, tag="in", share=0.5):
    return [
        write_reads(str(tmp_path / "{}.{}.fastq".format(tag, mate)), rng, n_pairs, read_len,
                    adapter, mate=mate, share=share)
        for mate, adapter in ((1, TRUSEQ_INDEX), (2, AD2))
    ]


def write_interleaved(path, pairs):
    """One file alternating the records of two mate files."""
    records = []
    for mate_path in pairs:
        with open(mate_path) as handle:
            lines = handle.read().splitlines()
        records.append([lines[i : i + 4] for i in range(0, len(lines), 4)])
    with open(path, "w") as out:
        for one, two in zip(*records):
            out.write("\n".join(one + two) + "\n")
    return path


# -- running ----------------------------------------------------------------


def _comparable(value):
    value = _plain(value)
    if isinstance(value, dict):
        return {key: _comparable(item) for key, item in value.items() if key not in IGNORED}
    if isinstance(value, list):
        return [_comparable(item) for item in value]
    return value


def _output(path):
    """What of an output file two runs must share."""
    if path.endswith(".json"):
        with open(path) as handle:
            return _comparable(json.load(handle))
    if path.endswith(".yaml"):
        with open(path) as handle:
            return _comparable(yaml.unsafe_load(handle))
    if path.endswith(".pickle"):
        with open(path, "rb") as handle:
            return _comparable(pickle.load(handle))
    with open(path) as handle:
        return [line for line in handle.read().splitlines() if not HEADER.search(line)]


def run_package(which, command, argv, outputs):
    """One argv through one package; returns (exit code, mode, comparable
    summary or the exception's text, {output: comparable content})."""
    for path in outputs:
        if os.path.exists(path):
            os.remove(path)
    if which == "jax":
        retcode, summary = jax_commands.get_command(command).execute(argv)
    else:
        retcode, summary = port_commands.get_command(command).execute(argv, device="cpu")
        assert summary["device"] == "cpu"
    if "exception" in summary:
        result = str(summary["exception"]["message"])
    else:
        result = _comparable(summary)
    files = {path: _output(path) for path in outputs if os.path.exists(path)}
    return retcode, summary.get("mode"), result, files


def run_both(command, argv, outputs, mode=None, retcode=0):
    """``argv`` through both packages: equal exit codes, routes, summaries
    and outputs. Returns the port's result."""
    jax_run = run_package("jax", command, argv, outputs)
    port_run = run_package("port", command, argv, outputs)
    label = command + " " + " ".join(argv)
    assert jax_run[0] == retcode, (label, jax_run[2])
    if mode is not None:
        assert jax_run[1] == mode, label
    for part, name in enumerate(("exit code", "mode", "summary", "outputs")):
        assert jax_run[part] == port_run[part], label + ": " + name
    assert sorted(port_run[3]) == sorted(p for p in outputs if os.path.exists(p)), label
    return port_run


def out(tmp_path, name):
    return str(tmp_path / name)


# -- qc -------------------------------------------------------------------------


@pytest.fixture
def se_fastq(tmp_path):
    return write_reads(out(tmp_path, "in.fastq"), seeded("cmd-se"), 200)


@pytest.fixture
def pe_fastq(tmp_path):
    return write_pairs(tmp_path, seeded("cmd-pe"), 120)


@pytest.fixture
def dense_fastq(tmp_path):
    """Reads nine in ten of which carry the adapter: the khmer detector's
    threshold is 100 copies of a k-mer at least."""
    return write_pairs(tmp_path, seeded("cmd-dense"), 160, tag="dense", share=0.9)


QC_NATIVE = {
    "se": lambda se, pe, t: ["-se", se],
    "se-max-reads": lambda se, pe, t: ["-se", se, "--max-reads", "123"],
    "se-fasta": lambda se, pe, t: ["-se", write_reads(out(t, "in.fasta"), seeded("fa"), 150,
                                                      fmt="fasta")],
    "se-small-batches": lambda se, pe, t: ["-se", se, "--batch-size", "7"],
    "pe": lambda se, pe, t: ["-pe1", pe[0], "-pe2", pe[1]],
    "pe-max-reads": lambda se, pe, t: ["-pe1", pe[0], "-pe2", pe[1], "--max-reads", "77"],
}


@pytest.mark.parametrize("case", sorted(QC_NATIVE))
@pytest.mark.parametrize("report", ["txt", "json"])
def test_qc_native_route(tmp_path, se_fastq, pe_fastq, case, report):
    rep = out(tmp_path, "qc." + report)
    run_both("qc", QC_NATIVE[case](se_fastq, pe_fastq, tmp_path) + ["-o", rep, "--quiet"],
             [rep], mode="turbo")


QC_RECORD = {
    "interleaved": lambda se, pe, t: ["-l", write_interleaved(out(t, "il.fastq"), pe)],
    "subsample": lambda se, pe, t: ["-se", se, "--subsample", "0.5", "--subsample-seed", "3"],
    "tiles": lambda se, pe, t: ["-se", se, "--stats", "tiles"],
    "pe-tiles": lambda se, pe, t: ["-pe1", pe[0], "-pe2", pe[1], "--stats", "tiles"],
    "colorspace": lambda se, pe, t: ["-c", "-se", os.path.join(ROOT, "tests", "conformance",
                                                                 "data", "solid.fastq")],
}


@pytest.mark.parametrize("case", sorted(QC_RECORD))
def test_qc_record_route(tmp_path, se_fastq, pe_fastq, case):
    rep = out(tmp_path, "qc.txt")
    run_both("qc", QC_RECORD[case](se_fastq, pe_fastq, tmp_path) + ["-o", rep, "--quiet"],
             [rep], mode="serial")


@pytest.mark.parametrize("paired", [False, True])
def test_qc_native_route_equals_the_record_route(tmp_path, se_fastq, pe_fastq, monkeypatch,
                                                 paired):
    from atropos_tpu_torch.commands import qc

    argv = (["-pe1", pe_fastq[0], "-pe2", pe_fastq[1]] if paired else ["-se", se_fastq])
    rep = out(tmp_path, "qc.txt")
    argv += ["-o", rep, "--quiet"]
    native = run_package("port", "qc", argv, [rep])
    monkeypatch.setattr(qc.CommandRunner, "_run_native", lambda self, args: None)
    record = run_package("port", "qc", argv, [rep])
    assert (native[1], record[1]) == ("turbo", "serial")
    assert native[2] == record[2] and native[3] == record[3]


def test_qc_pair_names_that_differ_fail_alike(tmp_path):
    in1, in2 = out(tmp_path, "m.1.fastq"), out(tmp_path, "m.2.fastq")
    with open(in1, "w") as handle:
        handle.write("@a/1\nACGT\n+\nIIII\n@b/1\nACGT\n+\nIIII\n")
    with open(in2, "w") as handle:
        handle.write("@a/2\nACGT\n+\nIIII\n@zzz/2\nACGT\n+\nIIII\n")
    port = run_both("qc", ["-pe1", in1, "-pe2", in2, "-o", out(tmp_path, "r.txt"), "--quiet"],
                    [], retcode=1)
    assert "improperly paired" in port[2]


# -- error ------------------------------------------------------------------------


ERROR_CASES = {
    "se": lambda se, pe: ["-se", se],
    "pe": lambda se, pe: ["-pe1", pe[0], "-pe2", pe[1]],
    "max-bases": lambda se, pe: ["-se", se, "-m", "37"],
    "pe-max-reads": lambda se, pe: ["-pe1", pe[0], "-pe2", pe[1], "--max-reads", "50"],
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
@pytest.mark.parametrize("report", ["txt", "json", "yaml", "pickle"])
def test_error(tmp_path, se_fastq, pe_fastq, case, report):
    rep = out(tmp_path, "err." + report)
    argv = ERROR_CASES[case](se_fastq, pe_fastq) + ["-o", rep, "--quiet"]
    if report != "txt":
        argv += ["--output_formats", report]
    port = run_both("error", argv, [rep], mode="serial")
    assert all(0 < value < 1 for value in port[2]["errorrate"]["estimate"])


def test_error_without_qualities_fails_alike(tmp_path):
    fasta = write_reads(out(tmp_path, "in.fasta"), seeded("err-fa"), 20, fmt="fasta")
    run_both("error", ["-se", fasta, "-o", out(tmp_path, "e.txt"), "--quiet"], [], retcode=1)


def test_error_shadow_without_rscript_fails_alike(tmp_path, se_fastq, monkeypatch):
    """Neither machine has R: the shadow estimator fails in both packages
    with the same error."""
    monkeypatch.setenv("PATH", str(tmp_path))
    argv = ["-se", se_fastq, "-a", "shadow", "-o", out(tmp_path, "e.txt"), "--quiet"]
    port = run_both("error", argv, [], retcode=1)
    assert port[2] == "[Errno 2] No such file or directory: 'Rscript'"


# -- detect -------------------------------------------------------------------------


KNOWN = ["-x", "truseq=" + TRUSEQ_INDEX, "-x", "read2=" + AD2]
DETECT_CASES = {
    "heuristic": ["-d", "heuristic"],
    "heuristic-known-only": ["-d", "heuristic", "--no-default-contaminants"] + KNOWN,
    "heuristic-unknown": ["-i", "unknown"],
    "known": ["-i", "known"],
    "known-k10": ["-d", "known", "-k", "10", "--no-default-contaminants"] + KNOWN,
    "khmer": ["-d", "khmer"],
    "khmer-unknown": ["-d", "khmer", "-i", "unknown", "--max-reads", "200"],
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_single_end(tmp_path, se_fastq, dense_fastq, case):
    rep = out(tmp_path, "det.txt")
    fastq = dense_fastq[0] if "khmer" in case else se_fastq
    port = run_both("detect", ["-se", fastq, "--no-cache-contaminants", "-o", rep, "--quiet"]
                    + DETECT_CASES[case], [rep], mode="serial")
    assert port[2]["detect"]["matches"][0], "no match: the case tests nothing"


@pytest.mark.parametrize("detector", ["heuristic", "known", "khmer"])
def test_detect_paired(tmp_path, pe_fastq, dense_fastq, detector):
    rep = out(tmp_path, "det.txt")
    pairs = dense_fastq if detector == "khmer" else pe_fastq
    port = run_both("detect", ["-pe1", pairs[0], "-pe2", pairs[1], "-d", detector,
                               "--no-cache-contaminants", "-o", rep, "--quiet"], [rep],
                    mode="serial")
    assert all(port[2]["detect"]["matches"]), "no match: the case tests nothing"


@pytest.mark.parametrize("fasta", ["union", "perinput"])
@pytest.mark.parametrize("paired", [False, True])
def test_detect_fasta_reports(tmp_path, se_fastq, pe_fastq, fasta, paired):
    rep = out(tmp_path, "det.fasta")
    inputs = ["-pe1", pe_fastq[0], "-pe2", pe_fastq[1]] if paired else ["-se", se_fastq]
    outputs = [rep] + [out(tmp_path, "det.{}.fasta".format(i)) for i in range(2)]
    port = run_both("detect", inputs + ["--fasta", fasta, "--no-cache-contaminants", "-o", rep,
                                        "--quiet"], outputs, mode="serial")
    assert any(lines for lines in port[3].values())


@pytest.mark.parametrize("report", ["json", "yaml", "pickle"])
def test_detect_serialized_reports(tmp_path, se_fastq, report):
    rep = out(tmp_path, "det." + report)
    run_both("detect", ["-se", se_fastq, "-i", "known", "-O", report, "--no-cache-contaminants",
                        "-o", rep, "--quiet"], [rep], mode="serial")


def _fake_khmer(monkeypatch):
    """A stand-in for the khmer package that counts exactly."""
    import types

    class FakeCountgraph:
        def __init__(self, ksize, tablesize, n_tables):
            self.ksize = ksize
            self.counts = {}

        def set_use_bigcount(self, flag):
            pass

        def consume_and_tag(self, seq):
            for i in range(len(seq) - self.ksize + 1):
                kmer = seq[i : i + self.ksize]
                self.counts[kmer] = self.counts.get(kmer, 0) + 1

        def get_tagset(self):
            return list(self.counts)

        def get(self, kmer):
            return self.counts.get(kmer, 0)

    fake = types.ModuleType("khmer")
    fake.Countgraph = FakeCountgraph
    args = types.ModuleType("khmer.khmer_args")
    args.DEFAULT_N_TABLES = 4
    fake.khmer_args = args
    monkeypatch.setitem(sys.modules, "khmer", fake)
    monkeypatch.setitem(sys.modules, "khmer.khmer_args", args)


def test_detect_khmer_countgraph_branch(tmp_path, monkeypatch):
    """The branch that takes khmer's Countgraph when it imports, with a
    stub module (khmer is installed on neither machine)."""
    _fake_khmer(monkeypatch)
    rng = seeded("khmer-stub")
    path = str(tmp_path / "contaminated.fastq")
    with open(path, "w") as handle:
        for i in range(600):
            seq = BASES[rng.integers(0, 4, 100)].tobytes().decode()
            if i % 2:
                seq = (seq[:40] + TRUSEQ_INDEX)[:100]
            handle.write("@r{}\n{}\n+\n{}\n".format(i, seq, "I" * 100))
    rep = out(tmp_path, "det.txt")
    port = run_both("detect", ["-se", path, "-d", "khmer", "--no-default-contaminants",
                               "--no-cache-contaminants", "-x", "truseq=" + TRUSEQ_INDEX,
                               "-o", rep, "--quiet"], [rep], mode="serial")
    assert port[2]["detect"]["matches"][0]


# -- a fuzz of the three commands' options --------------------------------------


def random_config(rng, tmp_path, se, pe):
    """(command, argv, outputs) drawn from the options of the three
    commands."""
    command = ("qc", "error", "detect")[int(rng.integers(3))]
    paired = rng.random() < 0.4
    inputs = ["-pe1", pe[0], "-pe2", pe[1]] if paired else ["-se", se]
    argv = list(inputs)
    if rng.random() < 0.5:
        argv += ["--max-reads", str(int(rng.integers(20, 260)))]
    if rng.random() < 0.3:
        argv += ["--batch-size", str(int(rng.integers(5, 300)))]
    report = out(tmp_path, "fuzz.txt")
    if command == "qc":
        if rng.random() < 0.3:
            argv += ["--stats", "tiles"]
        if not paired and rng.random() < 0.3:
            argv += ["--subsample", "0.7", "--subsample-seed", str(int(rng.integers(1, 99)))]
        if rng.random() < 0.4:
            report = out(tmp_path, "fuzz.json")
    elif command == "error":
        if rng.random() < 0.5:
            argv += ["-m", str(int(rng.integers(5, 120)))]
    else:
        argv += ["--no-cache-contaminants"]
        argv += ["-d", ("known", "heuristic", "khmer")[int(rng.integers(3))]]
        argv += ["-k", str(int(rng.integers(10, 16)))]
        if rng.random() < 0.5:
            argv += ["--no-default-contaminants"] + KNOWN
        if rng.random() < 0.3:
            argv += ["-e", ("A", "C", "T")[int(rng.integers(3))]]
        if rng.random() < 0.3:
            argv += ["--min-kmer-match-frac", "0.3", "--min-frequency", "0.01"]
        if rng.random() < 0.3:
            argv += ["-m", str(int(rng.integers(1, 4)))]
    return command, argv + ["-o", report, "--quiet"], [report]


@pytest.mark.parametrize("seed", range(8))
def test_fuzz(tmp_path, se_fastq, pe_fastq, seed):
    command, argv, outputs = random_config(seeded("cmd-fuzz", seed), tmp_path, se_fastq,
                                           pe_fastq)
    run_both(command, argv, outputs, mode=None if command == "qc" else "serial")


# -- the string-hash seed ------------------------------------------------------------


#: an adapter that five of the bundled contaminants' names share
MULTI_NAMED = "ACACTCTTTCCCTACACGACGCTCTTCCGATCT"
#: (input, detector) of each run of the hash-seed subprocesses
HASH_RUNS = (("single", "heuristic"), ("single", "known"), ("multi", "known"))

SUBPROCESS = r'''
import sys
import torch
torch.set_num_threads(1)
from {package}.commands import get_command
kwargs = {{"device": "cpu"}} if "{package}" == "atropos_tpu_torch" else {{}}
folder = sys.argv[1]
for name, detector in {runs}:
    retcode, summary = get_command("detect").execute(
        ["-se", "{{}}/{{}}.fastq".format(folder, name), "-d", detector,
         "--no-cache-contaminants", "-o",
         "{{}}/{{}}.{{}}.txt".format(folder, name, detector), "--quiet"], **kwargs)
    assert retcode == 0 and "exception" not in summary, summary.get("exception")
'''


@pytest.fixture(scope="module")
def hash_seed_reports(tmp_path_factory):
    """The detectors' reports from both packages, each in a subprocess
    under PYTHONHASHSEED 1 and under 2: on reads carrying an adapter that
    one contaminant name holds ("single") and one that five share
    ("multi")."""
    tmp_path = tmp_path_factory.mktemp("hash")
    write_reads(out(tmp_path, "single.fastq"), seeded("hash"), 150)
    write_reads(out(tmp_path, "multi.fastq"), seeded("hash-multi"), 150, adapter=MULTI_NAMED)
    reports = {}
    for package in ("atropos_tpu", "atropos_tpu_torch"):
        for seed in ("1", "2"):
            env = dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
            done = subprocess.run(
                [sys.executable, "-c",
                 SUBPROCESS.format(package=package, runs=repr(HASH_RUNS)), str(tmp_path)],
                cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600,
            )
            assert done.returncode == 0, done.stderr
            for name, detector in HASH_RUNS:
                reports[package, seed, name, detector] = _output(
                    out(tmp_path, "{}.{}.txt".format(name, detector)))
    return reports


@pytest.mark.parametrize("detector", ["heuristic", "known"])
def test_detect_under_two_hash_seeds(hash_seed_reports, detector):
    """The detectors iterate sets of read strings: under PYTHONHASHSEED 1
    and 2, in both packages, the reports are the same."""
    reports = [report for (_, _, name, det), report in hash_seed_reports.items()
               if (name, det) == ("single", detector)]
    assert len(reports) == 4 and all(report == reports[0] for report in reports), reports
    assert any(". Longest kmer: " in line for line in reports[0])


def _names_sorted(report):
    """The report with each match's names (``Name(s): a,`` and the lines
    that continue it while a name ends with a comma) in sorted order."""
    out_lines, names = [], []
    for line in report + [""]:
        if names and names[-1].endswith(","):
            names.append(line.strip())
            continue
        if names:
            out_lines.append(sorted(name.rstrip(",") for name in names))
            names = []
        if "Name(s): " in line:
            names = [line.split("Name(s): ", 1)[1]]
        else:
            out_lines.append(line)
    return out_lines


def test_detect_names_follow_the_hash_seed_in_both_packages(hash_seed_reports):
    """A contaminant whose sequence several names share is reported with
    its names in the order of a set of strings, which the string-hash
    seed decides: a fault of the reference that the port shares. Under
    each seed both packages give the same report; across seeds the
    reports agree but for the order of those names."""
    report = {(package, seed): hash_seed_reports[package, seed, "multi", "known"]
              for package in ("atropos_tpu", "atropos_tpu_torch") for seed in ("1", "2")}
    for seed in ("1", "2"):
        assert report["atropos_tpu", seed] == report["atropos_tpu_torch", seed]
    assert _names_sorted(report["atropos_tpu", "1"]) == _names_sorted(report["atropos_tpu", "2"])
    assert any("Name(s): " in line and line.endswith(",") for line in report["atropos_tpu", "1"])


# -- --progress ------------------------------------------------------------------------


PROGRESS = re.compile(r"Read .* records")


@pytest.mark.parametrize("command,extra", [
    ("qc", ["--subsample", "0.9"]),
    ("error", []),
    ("detect", ["-d", "known", "--no-cache-contaminants"]),
])
def test_progress_messages(tmp_path, se_fastq, caplog, command, extra):
    """``--progress msg`` wraps the record pipeline's batch iterator and
    logs the same lines in both packages (their seconds aside)."""
    rep = out(tmp_path, "p.txt")
    lines = {}
    for which in ("jax", "port"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            run_package(which, command, ["-se", se_fastq, "--progress", "msg", "-o", rep]
                        + extra, [rep])
        lines[which] = [
            re.sub(r"in [0-9.]+ seconds", "in _ seconds", record.getMessage())
            for record in caplog.records if PROGRESS.search(record.getMessage())
        ]
    assert lines["jax"] == lines["port"]
    assert lines["port"], "no progress line was logged"
