"""Side files, ``--stats``, ``{name}`` demultiplexing and ``-w`` of the
port against the JAX package.

Command level: the same argv through ``atropos_tpu`` (whose turbo runners
run every case here) and through ``atropos_tpu_torch`` on ``cpu`` gives
byte-identical outputs, info/rest/wildcard files and demultiplexed files,
and equal summaries, the ``--stats`` tables among them. Every adapter is
named: each package numbers unnamed adapters for the life of the process.

Statistics level: the port's per-position byte counts equal the
reference's device counter (``ATROPOS_TPU_DEVICE_STATS=1``) and a host
``bincount``, and its statistics classes reproduce
``tests/data_stats_golden.json`` through ``collect_matrices``.

All inputs are made from a seed with numpy; tolerance 0.
"""
import json
import os

import numpy as np
import pytest
import torch

from atropos_tpu.commands import stats as jax_stats
from atropos_tpu_torch.commands import stats as port_stats
from atropos_tpu_torch.commands.base import Summary
from atropos_tpu_torch.engine import turbo as port_turbo
from atropos_tpu_torch.io.seqio import open_reader

from .conformance_utils import datapath
from .test_torch_align import seeded
from .test_torch_turbo_pe import AD1, AD2, assert_same, io_argv, make_pairs, tail, write_pairs
from .test_torch_turbo_se import ANYWHERE, FRONT, TRUSEQ, make_reads, run_both, write_reads

torch.set_num_threads(1)

WILD = "ACGTNNNACGT"


def _outputs(tmp_path, *names):
    return [str(tmp_path / name) for name in names]


def _se(tmp_path, seed, argv, side, n_reads=300, fmt="fastq", adapters=(TRUSEQ, FRONT, ANYWHERE)):
    """One single-end argv with side files ``side`` (option -> file name)
    through both packages; returns what both wrote."""
    rng = seeded("side-se", seed)
    inp = write_reads(
        str(tmp_path / ("in." + fmt)),
        make_reads(rng, n_reads, "ACGTN", adapters=adapters), fmt,
    )
    out = str(tmp_path / ("out." + fmt))
    outs = [out]
    full = list(argv) + ["-se", inp, "-o", out]
    for option, name in side:
        outs.append(str(tmp_path / name))
        full += [option, outs[-1]]
    results = run_both(full + tail(tmp_path), outs)
    files = assert_same(results, " ".join(full))
    return files, results[1][1]


SIDE = [("--info-file", "info.txt"), ("-r", "rest.txt"), ("--wildcard-file", "wc.txt")]


@pytest.mark.parametrize("argv,fmt", [
    (["-a", "tru=" + TRUSEQ], "fastq"),
    (["-g", "front=" + FRONT, "-b", "anyw=" + ANYWHERE, "-e", "0.2"], "fastq"),
    (["-a", "wild=" + WILD + "TTAGACATAT", "-g", "front=" + FRONT, "-O", "3"], "fastq"),
    (["-a", "tru=" + TRUSEQ, "-q", "15", "-u", "4", "-u", "-3", "-m", "20"], "fastq"),
    (["-b", "anyw=" + ANYWHERE, "--no-indels", "-g", "pre=^" + FRONT], "fasta"),
], ids=["back", "front_anywhere", "wildcards", "quality_cuts", "fasta"])
def test_single_end_side_files(tmp_path, argv, fmt):
    files, _ = _se(tmp_path, "files" + fmt + str(len(argv)), argv, SIDE, fmt=fmt)
    assert files[str(tmp_path / "info.txt")]
    assert files[str(tmp_path / "rest.txt")]


def test_wildcard_file_rows_carry_the_read_bases(tmp_path):
    """Reads carrying the wildcard adapter with random bases in its N run:
    the wildcard file lists them."""
    rng = seeded("wildcards")
    records = []
    for i in range(200):
        seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 60))
        if i % 2:
            n_run = "".join("ACGT"[b] for b in rng.integers(0, 4, 3))
            seq = seq[:30] + "ACGT" + n_run + "ACGT" + seq[30:]
        records.append(("w{}".format(i), seq[:60], "I" * 60))
    inp = write_reads(str(tmp_path / "in.fastq"), records)
    outs = _outputs(tmp_path, "out.fastq", "wc.txt", "info.txt")
    argv = ["-a", "wild=" + WILD, "-se", inp, "-o", outs[0],
            "--wildcard-file", outs[1], "--info-file", outs[2]]
    files = assert_same(run_both(argv + tail(tmp_path), outs))
    lines = files[outs[1]].decode().splitlines()
    assert len(lines) >= 90 and all(len(line.split()[0]) == 3 for line in lines)


@pytest.mark.parametrize("extra", [
    [],
    ["-m", "25", "--too-short-output", "{tmp}/short.fastq"],
    ["--untrimmed-output", "{tmp}/untrimmed.fastq", "-q", "10"],
], ids=["plain", "too_short", "untrimmed"])
def test_demultiplexing(tmp_path, extra):
    rng = seeded("demux", len(extra))
    inp = write_reads(
        str(tmp_path / "in.fastq"),
        make_reads(rng, 300, adapters=(TRUSEQ, FRONT, ANYWHERE)),
    )
    template = str(tmp_path / "out.{name}.fastq")
    extra = [x.replace("{tmp}", str(tmp_path)) for x in extra]
    names = ("tru", "front", "anyw", "unknown")
    outs = [template.format(name=name) for name in names]
    outs += [x for x in extra if x.startswith(str(tmp_path))]
    argv = [
        "-a", "tru=" + TRUSEQ, "-g", "front=" + FRONT, "-b", "anyw=" + ANYWHERE,
        "-se", inp, "-o", template, "--info-file", str(tmp_path / "info.txt"),
    ] + extra
    outs.append(str(tmp_path / "info.txt"))
    files = assert_same(run_both(argv + tail(tmp_path), outs))
    written = [files.get(template.format(name=name), b"") for name in names]
    assert all(written[:3]), "every adapter has reads"
    records = sum(data.count(b"\n") // 4 for data in written)
    assert 0 < records <= 300


@pytest.mark.parametrize("which", ["pre", "post", "both"])
def test_single_end_stats(tmp_path, which):
    argv = ["--stats", which, "-a", "tru=" + TRUSEQ, "-g", "front=" + FRONT,
            "-q", "12", "-m", "30", "--too-short-output", str(tmp_path / "short.fastq")]
    _, summary = _se(tmp_path, "stats" + which, argv, [])
    for part in ("pre", "post"):
        assert (part in summary) == (which in (part, "both"))
    assert port_stats.DEVICE_STATS_COUNTS["cpu"] > 0


@pytest.mark.parametrize("aligner", ["adapter", "insert"])
@pytest.mark.parametrize("which", ["pre", "post", "both"])
def test_paired_stats(tmp_path, aligner, which):
    rng = seeded("stats-pe", aligner, which)
    pairs = make_pairs(rng, 150, 100, "ACGTN", n_rate=0.01)
    inputs = write_pairs(tmp_path, pairs, interleaved=which == "post")
    io, outs = io_argv(inputs, tmp_path)
    argv = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2,
            "--stats", which, "-m", "20", "-q", "10"] + io
    results = run_both(argv + tail(tmp_path), outs)
    assert_same(results, " ".join(argv))
    assert ("post" in results[1][1]) == (which != "pre")


@pytest.mark.parametrize("aligner", ["adapter", "insert"])
def test_paired_side_files(tmp_path, aligner):
    rng = seeded("side-pe", aligner)
    pairs = make_pairs(rng, 150, 120, "ACGTN", n_rate=0.01)
    inputs = write_pairs(tmp_path, pairs)
    io, outs = io_argv(inputs, tmp_path)
    side = _outputs(tmp_path, "info.txt", "rest.txt", "wc.txt")
    argv = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2,
            "--info-file", side[0], "-r", side[1], "--wildcard-file", side[2],
            "--stats", "both"] + io
    files = assert_same(run_both(argv + tail(tmp_path), outs + side), " ".join(argv))
    assert files[side[0]] and files[side[1]]


def overwrite_pairs(rng, n_pairs, read_len=100, share=0.2, window=10):
    """Pairs of ``make_pairs`` in which ``share`` of the pairs have one
    mate with a low-quality 5' window (quality 2) and the other a high one
    (quality 35)."""
    pairs = make_pairs(rng, n_pairs, read_len, "ACGTN", n_rate=0.005)
    out = []
    for mates in pairs:
        mates = [list(m) for m in mates]
        if rng.random() < share and min(len(m[1]) for m in mates) >= window:
            low = int(rng.integers(2))
            for mate, q in ((low, "#"), (1 - low, "D")):
                qual = mates[mate][2]
                mates[mate][2] = q * window + qual[window:]
        out.append(tuple(tuple(m) for m in mates))
    return out


@pytest.mark.parametrize("argv", [
    ["-w", "10,30,10", "-a", "ad1=" + AD1, "-A", "ad2=" + AD2],
    ["-w", "10,30,10"],
    ["-w", "8,25,12", "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "-q", "15", "-m", "20",
     "--pair-filter", "both"],
    ["-w", "10,30,10", "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "--op-order", "WCGQA",
     "-q", "10", "-u", "3"],
    ["-w", "10,30,10", "-A", "ad2=" + AD2, "--op-order", "WCGQA"],
], ids=["adapters", "no_adapters", "quality_filters", "first_in_chain", "first_no_a"])
@pytest.mark.parametrize("layout", ["two_files", "interleaved"])
def test_overwrite(tmp_path, argv, layout):
    rng = seeded("overwrite", " ".join(argv), layout)
    pairs = overwrite_pairs(rng, 200, window=12 if "8,25,12" in argv else 10)
    inputs = write_pairs(tmp_path, pairs, interleaved=layout == "interleaved")
    io, outs = io_argv(inputs, tmp_path, interleaved_out=layout == "interleaved")
    full = ["--aligner", "adapter"] + argv + io
    assert_same(run_both(full + tail(tmp_path), outs), " ".join(full))


def test_overwrite_replaces_mates(tmp_path):
    """The planted low-quality mates are replaced by their partner's
    reverse complement: the two packages agree, and they differ from a
    run without ``-w``."""
    rng = seeded("overwrite-count")
    pairs = overwrite_pairs(rng, 200, share=0.5)
    inputs = write_pairs(tmp_path, pairs)
    io, outs = io_argv(inputs, tmp_path)
    with_w = assert_same(run_both(["-w", "10,30,10", "-a", "ad1=" + AD1] + io + tail(tmp_path), outs))
    without = assert_same(run_both(["-a", "ad1=" + AD1] + io + tail(tmp_path), outs))
    assert with_w[outs[0]] != without[outs[0]] and with_w[outs[1]] != without[outs[1]]


def _random_matrix(rng, batch, width, alphabet=b"ACGTNacgtn+#!"):
    lengths = rng.integers(0, width + 1, batch).astype(np.int32)
    letters = np.frombuffer(alphabet, np.uint8)
    matrix = letters[rng.integers(0, len(letters), (batch, width))]
    matrix[np.arange(width)[None, :] >= lengths[:, None]] = rng.integers(0, 256)
    return matrix, lengths


@pytest.mark.parametrize("batch,width", [(600, 37), (1, 5), (300, 160)])
def test_position_counts_equal_the_reference_and_a_bincount(monkeypatch, batch, width):
    rng = seeded("position-counts", batch, width)
    matrix, lengths = _random_matrix(rng, batch, width)
    valid = np.arange(width)[None, :] < lengths[:, None]
    pos = np.broadcast_to(np.arange(width)[None, :], matrix.shape)
    bincount = np.bincount(
        (pos[valid] * 256 + matrix[valid]), minlength=width * 256
    ).reshape(width, 256)

    monkeypatch.setenv("ATROPOS_TPU_DEVICE_STATS", "1")
    reference = jax_stats.PositionByteCounts()
    before = jax_stats.DEVICE_STATS_COUNTS["batches"]
    reference.add_batch(matrix, lengths)
    assert jax_stats.DEVICE_STATS_COUNTS["batches"] == before + (batch >= 256)

    before = port_stats.DEVICE_STATS_COUNTS["cpu"]
    port = port_stats.position_byte_counts(matrix, lengths, "cpu")
    assert port_stats.DEVICE_STATS_COUNTS["cpu"] == before + 1
    assert port.dtype == np.int64 and port.shape == (width, 256)
    assert np.array_equal(port, bincount)
    assert np.array_equal(port, reference.counts[:width])
    table = port_stats.PositionByteCounts(device="cpu")
    table.add_batch(matrix, lengths)
    table.add_batch(matrix[: batch // 2 + 1], lengths[: batch // 2 + 1])
    reference.add_batch(matrix[: batch // 2 + 1], lengths[: batch // 2 + 1])
    assert np.array_equal(table.counts, reference.counts)


def _matrices(records):
    lengths = np.array([len(r.sequence) for r in records], np.int32)
    width = int(lengths.max())
    seqs = np.zeros((len(records), width), np.uint8)
    quals = np.zeros((len(records), width), np.uint8)
    for row, record in enumerate(records):
        seqs[row, : lengths[row]] = np.frombuffer(record.sequence.encode(), np.uint8)
        quals[row, : lengths[row]] = np.frombuffer(record.qualities.encode(), np.uint8)
    return seqs, quals, lengths


@pytest.mark.parametrize("split", [None, 3])
@pytest.mark.parametrize("name,fastq", [("illumina5", "illumina5.fastq"), ("small", "small.fastq")])
def test_stats_golden_through_collect_matrices(name, fastq, split):
    """``tests/data_stats_golden.json`` (the cases without per-tile
    statistics, which the turbo runners decline), in one batch or in
    batches of ``split`` records."""
    with open(os.path.join(os.path.dirname(__file__), "data_stats_golden.json")) as fh:
        golden = json.load(fh)[name]
    records = list(open_reader(file1=datapath(fastq), file_format="fastq", quality_base=33))
    stats = port_stats.SingleEndReadStatistics(qualities=True, device="cpu")
    step = split or len(records)
    for first in range(0, len(records), step):
        stats.collect_matrices(*_matrices(records[first : first + step]))
    summary = Summary()
    summary["stats"] = stats.summarize()
    summary.finish()
    assert json.loads(json.dumps(summary["stats"], default=str)) == golden


def test_tile_tables_merge_and_render_as_the_reference():
    """Per-tile tables (which the turbo runners decline to collect) merge
    and summarize as the reference's."""
    tables = []
    for stats_mod, kwargs in ((jax_stats, {}), (port_stats, {"device": "cpu"})):
        merged = stats_mod.TilePositionCounts(is_qualities=True, quality_base=33)
        for part in range(2):
            other = stats_mod.TilePositionCounts(is_qualities=True, quality_base=33)
            for tile in ("1101", "1102", "2101")[part:]:
                table = stats_mod.PositionByteCounts(True, 33, **kwargs)
                table.counts = np.random.default_rng([part, int(tile)]).integers(
                    0, 5, (7 + part, 256)).astype(np.int64)
                other.tiles[tile] = table
            merged.merge(other)
        summary = Summary()
        summary["tiles"] = merged.summarize()
        summary.finish()
        tables.append(json.loads(json.dumps(summary["tiles"], default=str)))
    assert tables[0] == tables[1] and len(tables[1]["columns2"]) == 3


def test_last_run_counts_the_stats_batches(tmp_path, monkeypatch):
    """Several batches: every batch's statistics are collected."""
    monkeypatch.setattr(port_turbo.TurboTrimRunner, "MAX_BATCH", 64)
    monkeypatch.setattr(port_turbo.TurboTrimRunner, "DEPTH", 2)
    before = port_stats.DEVICE_STATS_COUNTS["cpu"]
    _, summary = _se(tmp_path, "batches", ["--stats", "pre", "-a", "tru=" + TRUSEQ], [],
                     n_reads=300)
    assert port_turbo.LAST_RUN["batches"] == 5
    # one count of bases and one of qualities for each batch
    assert port_stats.DEVICE_STATS_COUNTS["cpu"] - before == 2 * 5
    assert summary["pre"]["0"]["read1"]["counts"] == 300
