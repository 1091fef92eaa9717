"""The paired-end turbo slice of the port against the JAX package.

Bundle level: one pair of parsed chunks through the paired runner of both
packages gives identical int16 bundles over the batch's columns: the fused
insert step (candidate slots for windows <= 255, the counts plane beyond,
2-bit, 4-bit and raw uploads, more than 14 symbols) and the two lanes of
the adapter aligner. The port is fed the JAX runner's own decode tables,
aligner tables and insert tables.

Command level: the same argv through ``atropos_tpu`` and through
``atropos_tpu_torch`` on ``cpu`` gives byte-identical outputs and equal
summaries: both aligners, two files and interleaved, gz, pair filters,
quality trimming, the slot overflow of near-poly-A pairs, and small
batches with several in flight (the seeded fuzz of the paired options is
in ``test_torch_turbo_pe_fuzz.py``).

All inputs are made from a seed with numpy; tolerance 0.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from atropos_tpu import commands as jax_commands
from atropos_tpu import runtime as jax_runtime
from atropos_tpu.align import pallas_kernel
from atropos_tpu.commands.trim import RecordHandler as JaxRecordHandler
from atropos_tpu.commands.trim.builder import TrimStackBuilder as JaxBuilder
from atropos_tpu.engine import turbo as jax_turbo
from atropos_tpu_torch import DeviceUnavailableError
from atropos_tpu_torch import commands as port_commands
from atropos_tpu_torch import runtime as port_runtime
from atropos_tpu_torch.align import insert_kernel
from atropos_tpu_torch.align.cuda_kernel import aligner_from_numpy
from atropos_tpu_torch.commands.trim import RecordHandler as PortRecordHandler
from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder as PortBuilder
from atropos_tpu_torch.engine import turbo as port_turbo

from .test_torch_align import seeded
from .test_torch_turbo_se import run_both

torch.set_num_threads(1)

AD1 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
AD2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
COMPLEMENT = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


# -- data -------------------------------------------------------------------


def make_pairs(rng, n_pairs, read_len=100, alphabet="ACGT", n_rate=0.0,
               lowercase=0.0, poly_a=0, sub_rate=0.01):
    """Read pairs from both ends of inserts of random length: mate 1 reads
    the insert, then AD1; mate 2 its reverse complement, then AD2; both
    then random bases. Substitutions come from ``alphabet``; ``poly_a``
    near-poly-A pairs (mate 1 all A but one C, mate 2 all T) come first.
    Returns [((name, seq, qual), (name, seq, qual))]."""
    pairs = []
    letters = np.frombuffer(alphabet.encode(), np.uint8)
    for i in range(n_pairs):
        if i < poly_a:
            seq1 = bytearray(b"A" * read_len)
            seq1[int(rng.integers(5, read_len - 5))] = ord("C")
            seq1, seq2 = bytes(seq1), b"T" * read_len
        else:
            ins_len = int(rng.integers(10, 2 * read_len))
            insert = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, ins_len)].tobytes()
            tail = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, read_len)].tobytes()
            seq1 = (insert + AD1.encode() + tail)[:read_len]
            seq2 = (insert.translate(COMPLEMENT)[::-1] + AD2.encode() + tail)[:read_len]
        mates = []
        for seq in (seq1, seq2):
            seq = np.frombuffer(seq, np.uint8).copy()
            if i % 13 == 5:
                seq = seq[: int(rng.integers(0, read_len))]
            subs = rng.random(seq.size) < sub_rate
            seq[subs] = letters[rng.integers(0, len(letters), int(subs.sum()))]
            seq[rng.random(seq.size) < n_rate] = ord("N")
            if rng.random() < lowercase:
                seq = seq | 0x20
            mates.append(seq.tobytes().decode())
        quals = [
            "".join(chr(33 + int(q)) for q in rng.integers(2, 41, len(seq)))
            for seq in mates
        ]
        pairs.append((
            ("p{}/1".format(i), mates[0], quals[0]),
            ("p{}/2".format(i), mates[1], quals[1]),
        ))
    return pairs


def write_fastq(path, records):
    text = "".join("@{}\n{}\n+\n{}\n".format(*rec) for rec in records)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as out:
        out.write(text.encode("ascii"))
    return path


def write_pairs(tmp_path, pairs, gz=False, interleaved=False):
    ext = ".fastq.gz" if gz else ".fastq"
    if interleaved:
        path = str(tmp_path / ("il" + ext))
        return [write_fastq(path, [rec for pair in pairs for rec in pair])]
    return [
        write_fastq(str(tmp_path / ("in.{}{}".format(mate + 1, ext))), [p[mate] for p in pairs])
        for mate in (0, 1)
    ]


def io_argv(inputs, tmp_path, interleaved_out=False):
    """Input and output options; returns (argv, output paths)."""
    argv = ["-pe1", inputs[0], "-pe2", inputs[1]] if len(inputs) == 2 else ["-l", inputs[0]]
    if interleaved_out:
        outs = [str(tmp_path / "out.il.fastq")]
        argv += ["-L", outs[0]]
    else:
        outs = [str(tmp_path / "out.1.fastq"), str(tmp_path / "out.2.fastq")]
        argv += ["-o", outs[0], "-p", outs[1]]
    return argv, outs


def tail(tmp_path):
    return [
        "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"),
    ]


def assert_same(results, label=""):
    (jax_files, jax_summary), (port_files, port_summary) = results
    assert sorted(jax_files) == sorted(port_files), label
    for path in jax_files:
        assert jax_files[path] == port_files[path], label + " -> " + path
    assert jax_summary == port_summary, label
    return jax_files


# -- bundle level -----------------------------------------------------------


def _build_runners(argv, tmp_path):
    """The paired runners both packages build for one command line."""
    argv = list(argv) + [
        "-o", str(tmp_path / "unused.1.fastq"), "-p", str(tmp_path / "unused.2.fastq"),
        "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
    ]
    runners = []
    for commands, stack, handler, turbo, extra in (
        (jax_commands, JaxBuilder, JaxRecordHandler, jax_turbo, {}),
        (port_commands, PortBuilder, PortRecordHandler, port_turbo, {"device": "cpu"}),
    ):
        command = commands.get_command("trim")
        runner = command.runner_class(command.parse_args(argv))
        modifiers, filters, formatters, writers = stack(runner).build()
        built = turbo.TurboPairedRunner.build(
            runner, handler(modifiers, filters, formatters), writers, **extra
        )
        assert built is not None
        runner.reader.close()
        runners.append(built)
    return runners


def _share_lane_tables(jax_lane, port_lane):
    """Feed the port's lane the JAX lane's own decode tables and aligner
    tables, so that both sides compute from the same numbers."""
    port_lane.load_tables(
        port_turbo.lane_tables_from_numpy(
            jax_lane._view_luts, jax_lane._aligner_view, jax_lane._insert_view
        )
    )
    for i, aligner in enumerate(jax_lane._aligners):
        if isinstance(aligner, pallas_kernel.PallasAligner):
            ref, thr = aligner._ref_np, aligner._thresholds_np
        else:
            ref, thr = np.asarray(aligner._ref_arr), np.asarray(aligner._thresholds)
        port_lane._aligners[i] = aligner_from_numpy(
            ref, thr, aligner._query_lut_np,
            m=aligner.m, k=aligner.k, flags=aligner.flags,
            min_overlap=aligner.min_overlap, indel_cost=aligner.indel_cost,
            compare_ascii=aligner._compare_ascii, device="cpu",
        )


def _share_tables(jax_runner, port_runner):
    for lane in ("lane1", "lane2"):
        _share_lane_tables(getattr(jax_runner, lane), getattr(port_runner, lane))
    jax_pair, port_pair = jax_runner.insert_pair, port_runner.insert_pair
    if jax_pair is not None:
        err = jax_pair.matcher.max_error_rate
        port_pair.load_tables(
            port_turbo.insert_tables_from_numpy(
                np.array([int(np.floor(s * err)) for s in range(256)], np.int32),
                jax_turbo._complement_lut(), jax_pair._ref_lut,
                jax_pair._ad1_t, jax_pair._ad2_t,
            )
        )


BUNDLE_CASES = {
    # name: (aligner, alphabet, lowercase, read length, extra argv, upload
    #        bits, counts kernel)
    "insert-2bit": ("insert", "ACGT", 0.0, 100, [], 2, "diag_counts_u8"),
    "insert-4bit-q": ("insert", "ACGTN", 0.2, 100, ["-q", "15"], 4, "diag_counts_u8"),
    "insert-raw-many-symbols": ("insert", "ACGTNRYKMSWBDHV", 0.2, 100,
                                ["--match-read-wildcards"], 0, "diag_counts_i32"),
    "insert-window-above-255": ("insert", "ACGTN", 0.0, 300, ["-e", "0.2"], 4,
                                "diag_counts_i32"),
    "insert-indel-cost-3": ("insert", "ACGT", 0.0, 100, ["--indel-cost", "3"], 2,
                            "diag_counts_u8"),
    "adapter-4bit": ("adapter", "ACGTN", 0.1, 100, ["--indel-cost", "2", "-e", "0.2"],
                     4, None),
}


def _submit_both(name, tmp_path):
    aligner, alphabet, lowercase, read_len, extra, bits, _ = BUNDLE_CASES[name]
    rng = seeded("pe-bundle", name)
    pairs = make_pairs(rng, 120, read_len, alphabet, n_rate=0.02 * ("N" in alphabet),
                       lowercase=lowercase, poly_a=4)
    inputs = write_pairs(tmp_path, pairs)
    argv = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "-pe1", inputs[0],
            "-pe2", inputs[1]] + extra
    jax_runner, port_runner = _build_runners(argv, tmp_path)
    _share_tables(jax_runner, port_runner)
    chunks = []
    for path in inputs:
        with open(path, "rb") as handle:
            data = handle.read()
        chunks.append((jax_runtime.parse_chunk(data), port_runtime.parse_chunk(data)))
    pack = port_turbo._pack_info(chunks[0][1])
    assert (0 if pack is None else pack[0]) == bits
    sub = slice(2, 118)
    if aligner == "insert":
        jax_tok = jax_runner.insert_pair.submit(chunks[0][0], sub, chunks[1][0], sub)
        port_tok = port_runner.insert_pair.submit(chunks[0][1], sub, chunks[1][1], sub)
    else:
        jax_tok = [lane.submit(chunks[i][0], sub) for i, lane in
                   enumerate((jax_runner.lane1, jax_runner.lane2))]
        port_tok = [lane.submit(chunks[i][1], sub) for i, lane in
                    enumerate((port_runner.lane1, port_runner.lane2))]
    return jax_runner, jax_tok, port_runner, port_tok


@pytest.mark.parametrize("name", sorted(BUNDLE_CASES))
def test_pair_bundle_identical(name, tmp_path):
    counts_kernel = BUNDLE_CASES[name][-1]
    insert_kernel.reset_launch_counts()
    jax_runner, jax_tok, port_runner, port_tok = _submit_both(name, tmp_path)
    if counts_kernel is None:
        pairs = list(zip(jax_tok, port_tok))
    else:
        pairs = [(jax_tok, port_tok)]
        selected = insert_kernel.kernel_for(
            min(port_tok.tok1.width, port_tok.tok2.width),
            port_runner.insert_pair._n_symbols(port_tok.tok1.chunk, port_tok.tok2.chunk),
        )
        assert selected.name == counts_kernel
    for jax_item, port_item in pairs:
        batch = (jax_item.tok1 if counts_kernel else jax_item).batch
        expected = np.asarray(jax_item.bundle)
        got = port_item.bundle.numpy()
        assert expected.dtype == got.dtype == np.int16
        assert expected.shape[0] == got.shape[0]
        assert np.array_equal(expected[:, :batch], got[:, :batch])
    if counts_kernel is None:
        for lane_j, lane_p, tok_j, tok_p in zip(
            (jax_runner.lane1, jax_runner.lane2), (port_runner.lane1, port_runner.lane2),
            jax_tok, port_tok,
        ):
            for exp, have in zip(lane_j.resolve_windows(tok_j), lane_p.resolve_windows(tok_p)):
                assert np.array_equal(exp, have)
    else:
        for exp, have in zip(
            jax_runner.insert_pair.resolve(jax_tok), port_runner.insert_pair.resolve(port_tok)
        ):
            assert np.array_equal(exp, have)
        # on CPU tensors the selected wrapper runs its plain version and
        # counts no launch
        assert insert_kernel.launch_counts() == {"diag_counts_u8": 0, "diag_counts_i32": 0}


def test_pair_bundle_identical_to_pallas_kernels(tmp_path, monkeypatch):
    """The same comparison with the JAX pair step on its Pallas kernels (in
    interpret mode), as it runs on an accelerator: the packed diagonal
    kernel and the DP kernel of both lanes."""
    monkeypatch.setenv("ATROPOS_TPU_PALLAS", "1")
    monkeypatch.setattr(pallas_kernel.PallasAligner, "INTERPRET", True)
    monkeypatch.setattr(pallas_kernel.PallasPackedInsertMatcher, "INTERPRET", True)
    jax_runner, jax_tok, port_runner, port_tok = _submit_both("insert-2bit", tmp_path)
    batch = jax_tok.tok1.batch
    assert np.array_equal(
        np.asarray(jax_tok.bundle)[:, :batch], port_tok.bundle.numpy()[:, :batch]
    )


# -- command level ------------------------------------------------------------


@pytest.mark.parametrize("aligner", ["adapter", "insert"])
@pytest.mark.parametrize("layout", ["two-files", "interleaved", "gz-interleaved-out"])
def test_paired_runs(tmp_path, aligner, layout):
    rng = seeded("pe-run", aligner, layout)
    pairs = make_pairs(rng, 200, 100, "ACGTN", n_rate=0.01)
    inputs = write_pairs(tmp_path, pairs, gz=layout.startswith("gz"),
                         interleaved=layout == "interleaved")
    io, outs = io_argv(inputs, tmp_path, interleaved_out=layout != "two-files")
    argv = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "-q", "20", "-m", "20"] + io
    files = assert_same(run_both(argv + tail(tmp_path), outs), " ".join(argv))
    assert all(files[path] for path in outs)
    assert port_turbo.LAST_RUN["pairs"] == 200
    assert port_turbo.LAST_RUN["aligner"] == aligner


@pytest.mark.parametrize("pair_filter", ["any", "both"])
@pytest.mark.parametrize("aligner", ["adapter", "insert"])
def test_pair_filters(tmp_path, pair_filter, aligner):
    rng = seeded("pe-filter", pair_filter, aligner)
    inputs = write_pairs(tmp_path, make_pairs(rng, 150, 90, "ACGTN", n_rate=0.03))
    io, outs = io_argv(inputs, tmp_path)
    short = [str(tmp_path / "short.{}.fastq".format(i)) for i in (1, 2)]
    argv = [
        "--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "--pair-filter", pair_filter,
        "-m", "40", "--max-n", "1", "--too-short-output", short[0],
        "--too-short-paired-output", short[1],
    ] + io
    assert_same(run_both(argv + tail(tmp_path), outs + short), " ".join(argv))


def test_slot_overflow_pairs(tmp_path):
    """Near-poly-A pairs have more admissible insert diagonals than the
    bundle has slots: their candidates are re-derived from counts
    recomputed on the host (the reference's own semantics), and the
    output stays identical."""
    rng = seeded("pe-overflow")
    inputs = write_pairs(tmp_path, make_pairs(rng, 200, 100, poly_a=70))
    io, outs = io_argv(inputs, tmp_path)
    argv = ["-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "--aligner", "insert", "-q", "20"] + io
    before = port_turbo.SLOT_OVERFLOWS["pairs"]
    assert_same(run_both(argv + tail(tmp_path), outs))
    assert port_turbo.SLOT_OVERFLOWS["pairs"] > before
    assert port_turbo.LAST_RUN["slot_overflow_pairs"] == (
        port_turbo.SLOT_OVERFLOWS["pairs"] - before
    )


@pytest.mark.parametrize("aligner,interleaved", [
    ("insert", False), ("insert", True), ("adapter", False),
])
def test_small_batches_and_depths(tmp_path, monkeypatch, aligner, interleaved):
    """Several pair batches in flight, and slots reused, give the same
    bytes; an odd interleaved chunk tail pairs across chunks."""
    rng = seeded("pe-batches", aligner, interleaved)
    inputs = write_pairs(tmp_path, make_pairs(rng, 300, 80, "ACGTN"), interleaved=interleaved)
    io, outs = io_argv(inputs, tmp_path)
    argv = ["--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2, "-m", "10"] + io
    monkeypatch.setattr(port_turbo.TurboPairedRunner, "MAX_BATCH", 64)
    monkeypatch.setattr(port_turbo.TurboPairedRunner, "DEPTH", 2)
    monkeypatch.setattr(port_turbo.TurboPairedRunner, "CHUNK_BYTES", 10001)
    assert_same(run_both(argv + tail(tmp_path), outs))
    assert port_turbo.LAST_RUN["batches"] > 300 // 64
    assert port_turbo.LAST_RUN["device_batches"] == (
        port_turbo.LAST_RUN["batches"] * (1 if aligner == "insert" else 2)
    )


def test_paired_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from atropos_tpu_torch.__main__ import main

    inputs = write_pairs(tmp_path, make_pairs(seeded("pe-card"), 10))
    io, outs = io_argv(inputs, tmp_path)
    for aligner in ("adapter", "insert"):
        with pytest.raises(DeviceUnavailableError):
            main(["trim", "--aligner", aligner, "-a", "ad1=" + AD1, "-A", "ad2=" + AD2] + io
                 + tail(tmp_path))
        assert not any(os.path.exists(path) for path in outs)
