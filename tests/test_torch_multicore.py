"""The ``--threads`` worker-shard mode of trim and qc against the JAX package.

The queue primitives and the order-preserving writer mirror
``tests/test_multicore.py`` on the port's copies. Then the same argv runs
through ``python -m atropos_tpu`` and ``python -m atropos_tpu_torch
--device cpu``, each in a folder of its own with the same relative paths,
so that the two summaries' options agree: single-end and paired-end trim
with the writer process (unordered, and in input order with
``--preserve-order``), with ``--no-writer-process`` (the workers' ``.N``
shard files), with writer and worker compression into gzip outputs, and
qc, single-end and paired-end, in one batch. In several batches, which
both qc workers take, the merged summary's count tables and record counts
equal the reference's and the port's run without ``--threads``; two qc
workers' summaries of half the batches each merge alike in both packages,
derived statistics added (a fault of the reference). Both runs' summaries (the JSON report, less
times, versions and the port's device) and text reports (less the
header's command line and times) must be equal, their mode "parallel",
and their outputs equal: byte for byte in input order, as sorted records
where the writer takes batches as they come, or over the union of the
shards. The inputs are made with numpy from a seed; every adapter is
named; tolerance 0.
"""
import gzip
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import Queue

import numpy as np
import pytest

from atropos_tpu_torch.commands.multicore import dequeue, enqueue, wait_on
from atropos_tpu_torch.commands.trim.pipeline import OrderPreservingWriterResultHandler
from atropos_tpu_torch.commands.trim.writers import Writers, add_suffix_to_path

from .test_torch_commands import AD2, HEADER, TRUSEQ_INDEX, _comparable
from .test_torch_commands import write_pairs, write_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TimeoutException(Exception):
    pass


# -- the queue primitives -------------------------------------------------------


def test_wait_on():
    class Callbacks:
        def __init__(self):
            self.i = 0
            self.j = 0

        def condition(self):
            self.i += 1
            return self.i >= 5

        def fail_callback(self):
            self.j += 1

    cb = Callbacks()
    wait_on(cb.condition, wait_message="waiting", fail_callback=cb.fail_callback)
    assert cb.i == 5
    assert cb.j == 4


def test_timeout():
    with pytest.raises(TimeoutException):
        wait_on(lambda: False, timeout=2, wait=1, timeout_callback=TimeoutException)


def test_enqueue_dequeue():
    queue = Queue(1)
    enqueue(queue, 1)
    assert dequeue(queue) == 1


def test_enqueue_timeout():
    with pytest.raises(TimeoutException):
        queue = Queue(1)
        queue.put(1)
        enqueue(queue, 2, timeout=1, block_timeout=2, timeout_callback=TimeoutException)


def test_dequeue_timeout():
    with pytest.raises(TimeoutException):
        dequeue(Queue(1), timeout=1, block_timeout=2, timeout_callback=TimeoutException)


def test_order_preserving_writer(tmp_path):
    path = str(tmp_path / "out.txt")
    writers = Writers()
    handler = OrderPreservingWriterResultHandler(writers)
    handler.start(None)
    handler.write_result(2, {path: "result2"})
    handler.write_result(3, {path: "result3"})
    handler.write_result(1, {path: "result1"})
    handler.finish(total_batches=3)
    with open(path, "rt") as inp:
        assert inp.read() == "result1result2result3"


# -- whole runs against the reference -------------------------------------------

SE_ADAPTER = ["-a", "ad1=" + TRUSEQ_INDEX, "-q", "15"]
PE_ADAPTERS = ["-a", "ad1=" + TRUSEQ_INDEX, "-A", "ad2=" + AD2, "-m", "20"]
TAIL = ["--quiet", "--no-cache-adapters", "--no-default-adapters"]

#: (id, argv with relative paths, outputs, how the outputs compare: "ordered"
#: byte for byte, "unordered" as sorted records, "shards" as the sorted
#: records of the union of the ``.N`` shards, None for qc)
CASES = [
    ("se_writer_gz_preserve_order",
     ["trim", "--threads", "3", "--preserve-order", "--batch-size", "25"] + SE_ADAPTER
     + ["-se", "in.fastq", "-o", "out.fastq.gz"], ["out.fastq.gz"], "ordered"),
    ("se_no_writer_process",
     ["trim", "--threads", "3", "--no-writer-process", "--batch-size", "25"] + SE_ADAPTER
     + ["-se", "in.fastq", "-o", "out.fastq"], ["out.fastq"], "shards"),
    ("pe_writer_worker_compression_gz",
     ["trim", "--threads", "3", "--compression", "worker", "--batch-size", "25",
      "--aligner", "insert"] + PE_ADAPTERS
     + ["-pe1", "in.1.fastq", "-pe2", "in.2.fastq", "-o", "out.1.fastq.gz",
        "-p", "out.2.fastq.gz"], ["out.1.fastq.gz", "out.2.fastq.gz"], "unordered"),
    ("pe_no_writer_process",
     ["trim", "--threads", "2", "--no-writer-process", "--batch-size", "40"] + PE_ADAPTERS
     + ["-pe1", "in.1.fastq", "-pe2", "in.2.fastq", "-o", "out.1.fastq",
        "-p", "out.2.fastq"], ["out.1.fastq", "out.2.fastq"], "shards"),
    # qc in one batch: one worker takes it, the other returns an empty
    # summary. Where several workers take batches, both packages add their
    # derived statistics (ROADMAP.md queue 3 item 14), and which worker
    # takes which batch is up to the host; test_qc_worker_summaries_merge_
    # alike holds that merge
    ("qc_se", ["qc", "--threads", "2", "--batch-size", "1000", "-se", "in.fastq"], [], None),
    ("qc_pe", ["qc", "--threads", "2", "--batch-size", "1000", "-pe1", "in.1.fastq",
               "-pe2", "in.2.fastq"], [], None),
]
#: qc in several batches, which both workers take: the merged summary's
#: additive parts against the reference's run and against the port's run of
#: the same argv without ``--threads``
QC_BATCH_CASES = [
    ("qc_se_batches", ["qc", "--threads", "2", "--batch-size", "20", "-se", "in.fastq"]),
    ("qc_pe_batches", ["qc", "--threads", "2", "--batch-size", "20", "-pe1", "in.1.fastq",
                       "-pe2", "in.2.fastq"]),
]


def _full_argv(argv):
    """``argv`` with its reports: text and JSON (the summary)."""
    if argv[0] == "trim":
        return argv + TAIL + ["--report-file", "report", "--report-formats", "txt", "json"]
    return argv + ["--quiet", "-o", "report", "--report-formats", "txt", "json"]


#: the command line of each package's run: the port's on ``cpu``, given as
#: the entry point's argument, so that both runs' argv are the same
ENTRY = {
    "atropos_tpu": "import sys\nfrom atropos_tpu.commands import execute_cli\n"
                   "sys.exit(execute_cli(sys.argv[1:]))\n",
    "atropos_tpu_torch": "import sys\nfrom atropos_tpu_torch.__main__ import main\n"
                         "sys.exit(main(sys.argv[1:], device='cpu'))\n",
}


def _run(package, argv, folder):
    """One CLI run in ``folder`` in a process of its own (its workers are
    spawned processes); one intra-op thread a process."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, "-c", ENTRY[package]] + _full_argv(argv),
        cwd=folder, env=env, capture_output=True, text=True, timeout=600,
    )
    return done.returncode, done.stderr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through both packages, three runs at a time: case id ->
    {package: (folder, exit code, stderr)}."""
    base = tmp_path_factory.mktemp("threads")
    rng = np.random.default_rng(20240229)
    reads = write_reads(str(base / "in.fastq"), rng, 230, read_len=100, adapter=TRUSEQ_INDEX)
    pairs = write_pairs(base, rng, 210, read_len=100)
    jobs = []
    for case_id, argv in [case[:2] for case in CASES] + QC_BATCH_CASES:
        runs = [("atropos_tpu", "atropos_tpu", argv), ("atropos_tpu_torch", "atropos_tpu_torch", argv)]
        if (case_id, argv) in QC_BATCH_CASES:
            runs.append(("one_process", "atropos_tpu_torch", argv[:1] + argv[3:]))
        for name, package, run_argv in runs:
            folder = base / case_id / name
            folder.mkdir(parents=True)
            for src in [reads] + pairs:
                os.symlink(src, str(folder / os.path.basename(src)))
            jobs.append((case_id, name, package, str(folder), run_argv))
    with ThreadPoolExecutor(3) as pool:
        done = list(pool.map(lambda job: _run(job[2], job[4], job[3]), jobs))
    out = {}
    for (case_id, name, _, folder, _), (code, stderr) in zip(jobs, done):
        out.setdefault(case_id, {})[name] = (folder, code, stderr)
    return out


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as handle:
        return handle.read()


def _records(data):
    lines = data.split(b"\n")
    assert lines[-1] == b""
    return [tuple(lines[i : i + 4]) for i in range(0, len(lines) - 1, 4)]


def _shards(folder, out):
    paths = [
        os.path.join(folder, add_suffix_to_path(out, ".{}".format(i))) for i in range(3)
    ]
    assert not os.path.exists(os.path.join(folder, out))
    return [path for path in paths if os.path.exists(path)]


def _outputs(folder, outs, how):
    """What the two runs' outputs must share."""
    got = []
    for out in outs:
        if how == "shards":
            shards = _shards(folder, out)
            assert shards, out
            got.append(sorted(r for path in shards for r in _records(_read(path))))
        elif how == "unordered":
            got.append(sorted(_records(_read(os.path.join(folder, out)))))
        else:
            got.append(_read(os.path.join(folder, out)))
    return got


def _summary(folder):
    with open(os.path.join(folder, "report.json")) as handle:
        summary = json.loads(handle.read().replace(folder + "/", ""))
    assert summary["mode"] == "parallel"
    assert "exception" not in summary
    return summary["threads"], summary["total_record_count"], _comparable(summary)


def _report(folder):
    with open(os.path.join(folder, "report.txt")) as handle:
        text = handle.read().replace(folder + "/", "")
    return [line for line in text.splitlines() if not HEADER.search(line)]


@pytest.mark.parametrize(
    "case_id,argv,outs,how", CASES, ids=[case[0] for case in CASES]
)
def test_threads_match_the_reference(runs, case_id, argv, outs, how):
    (ref_dir, ref_code, ref_err), (port_dir, port_code, port_err) = (
        runs[case_id]["atropos_tpu"], runs[case_id]["atropos_tpu_torch"]
    )
    assert ref_code == 0, ref_err[-3000:]
    assert port_code == 0, port_err[-3000:]
    threads, records, summary = _summary(port_dir)
    assert threads == int(argv[argv.index("--threads") + 1])
    assert records == (230 if "-se" in argv else 210)
    assert (threads, records, summary) == _summary(ref_dir)
    assert _report(port_dir) == _report(ref_dir)
    assert _outputs(port_dir, outs, how) == _outputs(ref_dir, outs, how)


def _counts(value):
    """The additive parts of a qc summary: every count table and record
    count, without each histogram's derived statistics (its "summary"),
    which workers' merges add (ROADMAP.md queue 3 item 14)."""
    if isinstance(value, dict):
        return {key: _counts(item) for key, item in value.items() if key != "summary"}
    return value


@pytest.mark.parametrize("case_id", [case[0] for case in QC_BATCH_CASES])
def test_qc_threads_over_several_batches_add_the_counts(runs, case_id):
    summaries = {}
    for name, (folder, code, stderr) in runs[case_id].items():
        assert code == 0, stderr[-3000:]
        with open(os.path.join(folder, "report.json")) as handle:
            summary = json.loads(handle.read().replace(folder + "/", ""))
        assert summary["mode"] == ("turbo" if name == "one_process" else "parallel")
        summary = _comparable(summary)
        assert summary.pop("threads") == (1 if name == "one_process" else 2)
        assert summary["total_record_count"] == (230 if "se" in case_id else 210)
        summary.pop("options")
        summaries[name] = _counts(summary)
    assert summaries["atropos_tpu_torch"] == summaries["atropos_tpu"]
    assert summaries["atropos_tpu_torch"] == summaries["one_process"]


@pytest.mark.parametrize("command", ["trim", "qc"])
def test_threads_without_a_card_raise_and_write_nothing(tmp_path, command):
    """The parent resolves the device before it starts a worker."""
    import torch

    from atropos_tpu_torch import DeviceUnavailableError
    from atropos_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    rng = np.random.default_rng(7)
    reads = write_reads(str(tmp_path / "in.fastq"), rng, 20)
    out = str(tmp_path / "out.fastq")
    report = str(tmp_path / "report.txt")
    argv = [command, "--threads", "2", "-se", reads, "--quiet"]
    if command == "trim":
        argv += SE_ADAPTER + TAIL + ["-o", out, "--report-file", report]
    else:
        argv += ["-o", report]
    with pytest.raises(DeviceUnavailableError):
        main(argv)
    assert sorted(os.listdir(str(tmp_path))) == ["in.fastq"]


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_qc_worker_summaries_merge_alike(tmp_path, paired):
    """Two qc workers' summaries, each of half the batches, merged by each
    package's summary algebra as the parent merges them: the same tree in
    both, in which the derived statistics (mean, median, modes, deviation)
    of the two halves are added, a fault of the reference that the port
    keeps (ROADMAP.md queue 3 item 14)."""
    from atropos_tpu.commands import qc as jax_qc
    from atropos_tpu.commands.base import Summary as JaxSummary
    from atropos_tpu.io.seqio import open_reader as jax_reader
    from atropos_tpu_torch.commands import qc as port_qc
    from atropos_tpu_torch.commands.base import Summary as PortSummary
    from atropos_tpu_torch.io.seqio import open_reader as port_reader

    rng = np.random.default_rng(31)
    if paired:
        files = dict(zip(("file1", "file2"), write_pairs(tmp_path, rng, 120, read_len=90)))
    else:
        files = dict(file1=write_reads(str(tmp_path / "in.fastq"), rng, 120, read_len=90))
    merged = []
    for qc, summary_class, reader, extra in (
        (jax_qc, JaxSummary, jax_reader, {}),
        (port_qc, PortSummary, port_reader, {"device": "cpu"}),
    ):
        pipeline_class = qc.PairedEndQcPipeline if paired else qc.SingleEndQcPipeline
        with reader(quality_base=33, **files) as records:
            records = list(records)
        parent = summary_class()
        for half in (records[:60], records[60:]):
            pipeline = pipeline_class(qualities=True, quality_base=33, **extra)
            pipeline.process_batch(({"index": 1, "source": 0, "size": len(half)}, half))
            worker = {}
            pipeline.finish(worker)
            parent.merge(worker)
        parent.finish()
        merged.append(_comparable(parent))
    assert merged[0] == merged[1]
    assert merged[1]["pre"]["0"]["read1"]["lengths"]["summary"]["mean"] == 2 * 90
