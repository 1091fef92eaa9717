"""Multi-process ranks: two Gloo processes of the port against two
``jax.distributed`` processes of the JAX package.

Mirrors ``tests/test_distributed.py``: every rank streams the same input,
trims the chunks (single-end turbo) or batches (the record batcher, and
paired-end turbo) it owns, the k-th counting from 0 when k modulo the
world size is its rank, into its own ``.{rank}`` shard, and rank 0 writes the report of the merged
summaries. Two ranks of each package run the same three command lines
(single-end turbo; ``--op-order``, which the turbo runner declines, on
the record batcher; paired-end turbo with the insert aligner), with the
turbo runners' chunks and pair batches made small, so that each rank owns
several. Each shard must equal the reference's byte for byte, and so
must the merged report (less the header's command line and times); the
shards, laid out again in chunk or batch order, must be the single-process
run's output, record for record, each record in one shard only; the
merged report from its trimming section on must be the single-process
report's. The inputs are made with numpy from a seed; every adapter is
named; tolerance 0.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from .test_torch_commands import AD2, HEADER, TRUSEQ_INDEX, write_pairs, write_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the ranks' command lines, with ``{out}`` their folder and ``{in}`` the
#: inputs' folder; every rank runs all three, one after another
CASES = {
    "se_turbo": ["-a", "ad1=" + TRUSEQ_INDEX, "-se", "{in}/in.fastq", "-o", "{out}/se.fastq"],
    "record_batcher": ["-a", "ad1=" + TRUSEQ_INDEX, "--op-order", "ACGQW", "--batch-size",
                       "10", "-se", "{in}/in.fastq", "-o", "{out}/op.fastq"],
    "pe_turbo": ["--aligner", "insert", "-a", "ad1=" + TRUSEQ_INDEX, "-A", "ad2=" + AD2,
                 "-pe1", "{in}/in.1.fastq", "-pe2", "{in}/in.2.fastq",
                 "-o", "{out}/pe.1.fastq", "-p", "{out}/pe.2.fastq"],
}
OUTPUTS = {
    "se_turbo": ["se.fastq"], "record_batcher": ["op.fastq"],
    "pe_turbo": ["pe.1.fastq", "pe.2.fastq"],
}
TAIL = ["--no-cache-adapters", "--no-default-adapters", "--quiet"]
#: the turbo runners' chunk bytes and pair batch in every rank: several
#: chunks and batches on the small inputs
CHUNK_BYTES = 4096
PAIR_BATCH = 16

RANK = r"""
import json, os, sys
which, rank, world, port, inputs, out = sys.argv[1:7]
cases = json.loads(sys.argv[7])
rank, world = int(rank), int(world)
if which == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        "localhost:" + port, num_processes=world, process_id=rank)
    os.environ["ATROPOS_TPU_ENGINE"] = "1"
    from atropos_tpu.commands import get_command
    from atropos_tpu.engine import turbo
    run = lambda argv: get_command("trim").execute(argv)
else:
    import torch
    torch.set_num_threads(1)
    from atropos_tpu_torch.parallel import distributed
    distributed.initialize("localhost:" + port, world, rank)
    from atropos_tpu_torch.commands import get_command
    from atropos_tpu_torch.engine import turbo
    run = lambda argv: get_command("trim").execute(argv, device="cpu")
turbo.TurboTrimRunner.CHUNK_BYTES = turbo.TurboPairedRunner.CHUNK_BYTES = %d
turbo.TurboPairedRunner.MAX_BATCH = %d
result = {}
for name, argv in cases.items():
    argv = [a.replace("{in}", inputs).replace("{out}", out) for a in argv]
    last_run = getattr(turbo, "LAST_RUN", {})
    last_run.clear()
    retcode, summary = run(argv + ["--report-file", os.path.join(out, name + ".txt")])
    assert retcode == 0 and "exception" not in summary, summary.get("exception")
    result[name] = dict(mode=summary["mode"], owned=last_run.get("owned"))
print(json.dumps(result))
""" % (CHUNK_BYTES, PAIR_BATCH)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two ranks of each package, all four processes at once: package ->
    (folder, [each rank's cases' mode and owned chunks or batches])."""
    base = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(20240301)
    write_reads(str(base / "in.fastq"), rng, 300, read_len=100, adapter=TRUSEQ_INDEX)
    write_pairs(base, rng, 120, read_len=100)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    procs = {}
    for which, package in (("jax", "atropos_tpu"), ("port", "atropos_tpu_torch")):
        folder = base / package
        folder.mkdir()
        port = str(_free_port())
        procs[package] = (str(folder), [
            subprocess.Popen(
                [sys.executable, "-c", RANK, which, str(rank), "2", port, str(base),
                 str(folder), json.dumps({n: a + TAIL for n, a in CASES.items()})],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for rank in range(2)
        ])
    out = {}
    try:
        for package, (folder, group) in procs.items():
            results = []
            for proc in group:
                stdout, stderr = proc.communicate(timeout=300)
                assert proc.returncode == 0, stderr[-3000:]
                results.append(json.loads(stdout.strip().splitlines()[-1]))
            out[package] = (folder, results)
    finally:
        # a rank that failed leaves its peer waiting on the group
        for _, group in procs.values():
            for proc in group:
                proc.kill()
                proc.wait()
    out["inputs"] = str(base)
    return out


@pytest.fixture(scope="module")
def single(ranks, tmp_path_factory):
    """The same command lines in this process on ``cpu``, one process."""
    from atropos_tpu_torch.commands import get_command

    folder = str(tmp_path_factory.mktemp("single"))
    for name, argv in CASES.items():
        argv = [a.replace("{in}", ranks["inputs"]).replace("{out}", folder) for a in argv]
        retcode, summary = get_command("trim").execute(
            argv + TAIL + ["--report-file", os.path.join(folder, name + ".txt")],
            device="cpu",
        )
        assert retcode == 0 and summary["mode"] in ("turbo", "serial")
    return folder


def _shard(folder, out, rank):
    stem, ext = os.path.splitext(out)
    return os.path.join(folder, "{}.{}{}".format(stem, rank, ext))


def _read(path):
    with open(path, "rb") as handle:
        return handle.read()


def _records(data):
    lines = data.split(b"\n")
    assert lines[-1] == b""
    return [b"\n".join(lines[i : i + 4]) + b"\n" for i in range(0, len(lines) - 1, 4)]


@pytest.mark.parametrize("name", list(CASES))
def test_rank_shards_equal_the_reference(ranks, name):
    ref_dir, ref_results = ranks["atropos_tpu"]
    port_dir, port_results = ranks["atropos_tpu_torch"]
    for rank in range(2):
        assert port_results[rank][name]["mode"] == ref_results[rank][name]["mode"]
        assert port_results[rank][name]["mode"] == "distributed"
        for out in OUTPUTS[name]:
            assert not os.path.exists(os.path.join(port_dir, out))
            data = _read(_shard(port_dir, out, rank))
            assert data, (name, out, rank)
            assert data == _read(_shard(ref_dir, out, rank)), (name, out, rank)


def _report(path):
    with open(path) as handle:
        return [line for line in handle.read().splitlines() if not HEADER.search(line)]


@pytest.mark.parametrize("name", list(CASES))
def test_merged_report_equals_the_reference(ranks, name):
    """Rank 0 alone writes the report, of the merged summaries."""
    ref_dir, _ = ranks["atropos_tpu"]
    port_dir, _ = ranks["atropos_tpu_torch"]
    report = os.path.join(port_dir, name + ".txt")
    assert _report(report) == _report(os.path.join(ref_dir, name + ".txt"))
    assert sorted(p for p in os.listdir(port_dir) if p.endswith(".txt")) == sorted(
        case + ".txt" for case in CASES
    )


def _in_order(port_dir, results, name, out):
    """The two shards of ``out`` laid out in chunk or batch order again:
    the turbo runners say which chunks or pair batches each rank owned;
    the record batcher's batches of 10 alternate from rank 0 on."""
    units = {}
    for rank in range(2):
        records = _records(_read(_shard(port_dir, out, rank)))
        owned = results[rank][name]["owned"]
        if owned is None:
            owned = [(2 * i + rank, 10) for i in range(-(-len(records) // 10))]
        assert len(owned) > 1, (name, rank, owned)
        at = 0
        for index, count in owned:
            assert index % 2 == rank
            units[index] = records[at : at + count]
            at += count
        assert at == len(records)
    assert sorted(units) == list(range(len(units)))
    return [record for index in sorted(units) for record in units[index]]


@pytest.mark.parametrize("name", list(CASES))
def test_shards_partition_the_single_process_output(ranks, single, name):
    port_dir, results = ranks["atropos_tpu_torch"]
    for out in OUTPUTS[name]:
        shard_names = [
            {record.split(b"\n")[0] for record in _records(_read(_shard(port_dir, out, rank)))}
            for rank in range(2)
        ]
        assert shard_names[0] and shard_names[1]
        assert not shard_names[0] & shard_names[1]
        assert b"".join(_in_order(port_dir, results, name, out)) == _read(
            os.path.join(single, out))


def _trimming_section(path):
    with open(path) as handle:
        text = handle.read()
    return text[text.index("--------\nTrimming"):]


@pytest.mark.parametrize("name", list(CASES))
def test_merged_report_equals_the_single_process_report(ranks, single, name):
    port_dir, _ = ranks["atropos_tpu_torch"]
    assert _trimming_section(os.path.join(port_dir, name + ".txt")) == _trimming_section(
        os.path.join(single, name + ".txt"))


def test_one_process_without_a_group():
    """Without a process group the helpers are those of one rank."""
    from atropos_tpu_torch.parallel import distributed

    assert distributed.process_info() == (0, 1)
    assert distributed.allgather_object({"a": 1}) == [{"a": 1}]
    summary = {"record_counts": {0: 5}, "timing": "t", "device": "cpu", "mode": "turbo"}
    assert distributed.merge_summaries(summary) == {"record_counts": {0: 5}, "mode": "turbo"}
    distributed.barrier()


def test_batch_ownership_matches_the_reference():
    """The record batcher's round robin: the rank of each batch, in both
    packages, for three ranks."""
    from types import SimpleNamespace

    from atropos_tpu.commands.base import BaseCommandRunner as Reference
    from atropos_tpu_torch.commands.base import BaseCommandRunner

    def owned(runner_class, rank):
        runner = SimpleNamespace(batches=0, shard_rank=rank, shard_count=3)
        batches = [runner_class._assemble(runner, [index]) for index in range(7)]
        return [meta["index"] for meta, _ in filter(None, batches)]

    port = [owned(BaseCommandRunner, rank) for rank in range(3)]
    assert port == [owned(Reference, rank) for rank in range(3)]
    assert port == [[1, 4, 7], [2, 5], [3, 6]]
