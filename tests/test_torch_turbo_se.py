"""The single-end turbo slice of the port against the JAX package.

Bundle level: one parsed chunk through ``_MateLane.submit`` of both
packages gives the identical int16 bundle (the columns of the batch; the
two packages pad the batch to different widths), for 2-bit, 4-bit and raw
(> 16 symbols) uploads and for packed 3-row and flat 7-row results. The
port's lane is fed the JAX lane's own decode tables and its aligners the
JAX aligners' own compiled tables.

Command level: the same argv through ``atropos_tpu`` and through
``atropos_tpu_torch`` on ``cpu`` gives byte-identical output files and
equal summaries, over a seeded fuzz of the options of the slice.

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
from atropos_tpu_torch import commands as port_commands
from atropos_tpu_torch import runtime as port_runtime
from atropos_tpu_torch.align.cuda_kernel import aligner_from_numpy
from atropos_tpu_torch.commands.trim import RecordHandler as PortRecordHandler
from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder as PortBuilder
from atropos_tpu_torch.engine import turbo as port_turbo

from .test_torch_align import _bases, seeded

# the tensors here are small: one thread per test process is fastest and
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
FRONT = "ACGTACGTAA"
ANYWHERE = "TTAGACATAT"


# -- data -------------------------------------------------------------------


def make_reads(rng, n_reads, alphabet="ACGT", max_len=110, lowercase=0.0,
               adapters=(TRUSEQ,)):
    """(name, seq, qual) records: random reads, half of them carrying one
    of ``adapters`` (now and then mutated) at a random offset."""
    records = []
    for i in range(n_reads):
        length = int(rng.integers(0, max_len + 1)) if i % 17 else i % 2
        seq = _bases(rng, length, alphabet)
        if length > 30 and rng.random() < 0.5:
            adapter = list(adapters[int(rng.integers(len(adapters)))])
            roll = rng.random()
            if roll < 0.3:
                adapter[int(rng.integers(len(adapter)))] = _bases(rng, 1)
            elif roll < 0.4:
                del adapter[int(rng.integers(len(adapter)))]
            elif roll < 0.5:
                adapter.insert(int(rng.integers(len(adapter))), _bases(rng, 1))
            adapter = "".join(adapter)
            where = rng.random()
            if where < 0.6:
                pos = int(rng.integers(5, length - 10))
                seq = (seq[:pos] + adapter + seq)[:length]
            elif where < 0.8:
                seq = (adapter + seq)[:length]
            else:
                seq = seq[: length - len(adapter)] + adapter
        if rng.random() < lowercase:
            seq = seq.lower()
        lo, hi = ((0, 8), (2, 40), (35, 41))[int(rng.integers(3))]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(lo, hi + 1, len(seq)))
        records.append(("r{}".format(i), seq, qual))
    return records


def write_reads(path, records, fmt="fastq"):
    if fmt == "fastq":
        text = "".join(
            "@{}\n{}\n+\n{}\n".format(name, seq, qual)
            for name, seq, qual in records
        )
    else:
        text = "".join(">{}\n{}\n".format(name, seq) for name, seq, _ in records)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as out:
        out.write(text.encode("ascii"))
    return path


# -- bundle level -----------------------------------------------------------


def _build_lanes(argv, tmp_path):
    """The single-end lanes both packages build for one command line."""
    argv = list(argv) + [
        "-o", str(tmp_path / "unused.fastq"), "--quiet",
        "--adapter-cache-file", str(tmp_path / ".adapters"),
    ]
    lanes = []
    for commands, stack, handler, turbo, extra in (
        (jax_commands, JaxBuilder, JaxRecordHandler, jax_turbo, {}),
        (port_commands, PortBuilder, PortRecordHandler, port_turbo,
         {"device": "cpu"}),
    ):
        command = commands.get_command("trim")
        runner = command.runner_class(command.parse_args(argv))
        modifiers, filters, formatters, writers = stack(runner).build()
        record_handler = handler(modifiers, filters, formatters)
        built = turbo.TurboTrimRunner.build(
            runner, record_handler, writers, **extra
        )
        assert built is not None
        runner.reader.close()
        lanes.append(built.lane)
    return lanes


def _share_tables(jax_lane, port_lane):
    """Feed the port's lane the JAX lane's own arrays, so that both sides
    compute from the same tables."""
    port_lane.load_tables(
        port_turbo.lane_tables_from_numpy(
            jax_lane._view_luts, jax_lane._aligner_view
        )
    )
    assert len(jax_lane._aligners) == len(port_lane._aligners)
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


BUNDLE_CASES = {
    # name: (alphabet, lowercase share, max read length, argv, bits, rows)
    "2bit-packed3": ("ACGT", 0.0, 110, ["-a", TRUSEQ], 2, 3),
    "4bit-packed3": ("ACGTN", 0.2, 110, ["-a", TRUSEQ, "-g", FRONT], 4, 3),
    "raw-packed3": ("ACGTNRYKMSWBDHVX", 0.3, 110,
                    ["-a", TRUSEQ, "--match-read-wildcards"], 0, 3),
    "2bit-flat7": ("ACGT", 0.0, 300, ["-a", TRUSEQ, "-b", ANYWHERE], 2, 7),
    "4bit-flat7": ("ACGTN", 0.1, 290, ["-a", "ACGTNNNACGTRYK"], 4, 7),
    "raw-flat7": ("ACGTNRYKMSWBDHVX", 0.3, 280, ["-b", ANYWHERE, "-e", "0.2"], 0, 7),
    "4bit-wildcards": ("ACGTN", 0.0, 110,
                       ["-a", "ACGTNNNACGTRYK", "-a", TRUSEQ,
                        "--match-read-wildcards", "-O", "5"], 4, 3),
    "2bit-quality": ("ACGT", 0.0, 110,
                     ["-a", TRUSEQ, "-q", "15,20", "-u", "3", "--no-indels"], 2, 3),
    "4bit-anchored": ("ACGTN", 0.0, 110,
                      ["-g", "^" + FRONT, "-a", TRUSEQ + "$", "--nextseq-trim", "20"],
                      4, 3),
}


def _submit_both(name, tmp_path):
    alphabet, lowercase, max_len, argv, bits, rows = BUNDLE_CASES[name]
    rng = seeded("bundle", name)
    records = make_reads(
        rng, 150, alphabet, max_len, lowercase, adapters=(TRUSEQ, FRONT, ANYWHERE)
    )
    path = write_reads(str(tmp_path / "in.fastq"), records)
    with open(path, "rb") as handle:
        data = handle.read()
    jax_lane, port_lane = _build_lanes(argv + ["-se", path], tmp_path)
    _share_tables(jax_lane, port_lane)
    jax_chunk = jax_runtime.parse_chunk(data)
    port_chunk = port_runtime.parse_chunk(data)
    sub = slice(3, 147)
    pack = port_turbo._pack_info(port_chunk)
    assert (0 if pack is None else pack[0]) == bits
    jax_tok = jax_lane.submit(jax_chunk, sub)
    port_tok = port_lane.submit(port_chunk, sub)
    assert port_lane.res_rows(port_tok.width) == rows
    assert jax_lane.res_rows(jax_tok.width) == rows
    return jax_lane, jax_tok, port_lane, port_tok


@pytest.mark.parametrize("name", sorted(BUNDLE_CASES))
def test_bundle_identical(name, tmp_path):
    jax_lane, jax_tok, port_lane, port_tok = _submit_both(name, tmp_path)
    batch = jax_tok.batch
    assert port_tok.batch == batch and port_tok.width == jax_tok.width
    expected = np.asarray(jax_tok.bundle)
    got = port_tok.bundle.numpy()
    assert expected.dtype == got.dtype == np.int16
    assert expected.shape[0] == got.shape[0]
    assert got.shape[1] == port_tok.pad_b and port_tok.pad_b % 32 == 0
    assert np.array_equal(expected[:, :batch], got[:, :batch])
    assert np.array_equal(jax_tok.seqs[:batch], port_tok.seqs[:batch])
    for exp, have in zip(
        jax_lane.resolve_windows(jax_tok), port_lane.resolve_windows(port_tok)
    ):
        assert np.array_equal(exp, have)


def test_bundle_identical_to_pallas_kernel(tmp_path, monkeypatch):
    """The same comparison with the JAX lane on its Pallas kernel (in
    interpret mode), as it runs on an accelerator."""
    monkeypatch.setenv("ATROPOS_TPU_PALLAS", "1")
    monkeypatch.setattr(pallas_kernel.PallasAligner, "INTERPRET", True)
    jax_lane, jax_tok, port_lane, port_tok = _submit_both("4bit-packed3", tmp_path)
    assert all(
        isinstance(a, pallas_kernel.PallasAligner) for a in jax_lane._aligners
    )
    batch = jax_tok.batch
    assert np.array_equal(
        np.asarray(jax_tok.bundle)[:, :batch], port_tok.bundle.numpy()[:, :batch]
    )


def test_lane_without_device_aligners_has_no_bundle(tmp_path):
    rng = seeded("nobundle")
    path = write_reads(str(tmp_path / "in.fastq"), make_reads(rng, 60))
    with open(path, "rb") as handle:
        data = handle.read()
    jax_lane, port_lane = _build_lanes(
        ["-g", "^" + FRONT, "--no-indels", "-q", "10", "-se", path], tmp_path
    )
    sub = slice(0, 60)
    jax_tok = jax_lane.submit(jax_runtime.parse_chunk(data), sub)
    port_tok = port_lane.submit(port_runtime.parse_chunk(data), sub)
    assert jax_tok.bundle is None and port_tok.bundle is None
    assert port_lane.device_batches == 0
    for exp, have in zip(
        jax_lane.resolve_windows(jax_tok), port_lane.resolve_windows(port_tok)
    ):
        assert np.array_equal(exp, have)


# -- command level ------------------------------------------------------------

IGNORED_SUMMARY_KEYS = ("timing", "program", "version", "mode", "device")


def _plain(value):
    """Summary trees as plain comparable data."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    return value


def _comparable(summary):
    assert "exception" not in summary, summary.get("exception")
    return _plain(
        {k: v for k, v in summary.items() if k not in IGNORED_SUMMARY_KEYS}
    )


def run_both(argv, out_paths):
    """Run one argv through both packages, one after the other into the
    same paths; returns ({path: bytes}, summary) per package. Adapters in
    ``argv`` carry names: unnamed ones are numbered by a counter that each
    package keeps for the life of the process."""
    results = []
    for which in ("jax", "port"):
        for path in out_paths:
            if os.path.exists(path):
                os.remove(path)
        if which == "jax":
            retcode, summary = jax_commands.get_command("trim").execute(argv)
            assert summary["mode"] == "turbo", "the case must lie in the slice"
        else:
            retcode, summary = port_commands.get_command("trim").execute(
                argv, device="cpu"
            )
            assert summary["mode"] == "turbo" and summary["device"] == "cpu"
        assert retcode == 0
        files = {}
        for path in out_paths:
            if os.path.exists(path):
                with open(path, "rb") as handle:
                    files[path] = handle.read()
        results.append((files, _comparable(summary)))
    return results


def random_config(rng):
    """One draw of the options of the slice."""
    parts = []
    pool = [
        ["-a", "tru=" + TRUSEQ], ["-g", "front=" + FRONT],
        ["-b", "anyw=" + ANYWHERE], ["-a", "anch=" + TRUSEQ[:12] + "$"],
        ["-g", "pre=^" + FRONT], ["-a", "wild=ACGTNNNACGTRYK"],
    ]
    n_adapters = int(rng.integers(0, 4))
    for idx in rng.permutation(len(pool))[:n_adapters]:
        parts += pool[int(idx)]
    if n_adapters:
        if rng.random() < 0.3:
            parts += ["--no-indels"]
        if rng.random() < 0.5:
            parts += ["-e", ("0.05", "0.1", "0.2")[int(rng.integers(3))]]
        if rng.random() < 0.5:
            parts += ["-O", ("1", "3", "5", "8")[int(rng.integers(4))]]
        if rng.random() < 0.3:
            parts += ["--match-read-wildcards"]
        if rng.random() < 0.2:
            parts += ["--no-match-adapter-wildcards"]
    if rng.random() < 0.3:
        parts += ["-u", str(int(rng.integers(1, 8)))]
        if rng.random() < 0.5:
            parts += ["-u", str(-int(rng.integers(1, 8)))]
    quality = rng.random() < 0.4
    if quality:
        cut = str(int(rng.integers(5, 30)))
        parts += ["-q", cut if rng.random() < 0.5 else cut + ",15"]
    nextseq = rng.random() < 0.2
    if nextseq:
        parts += ["--nextseq-trim", str(int(rng.integers(10, 30)))]
    if rng.random() < 0.3:
        parts += ["--trim-n"]
    if rng.random() < 0.5 or len(parts) == 0:
        parts += ["-m", str(int(rng.integers(1, 40)))]
    if rng.random() < 0.3:
        parts += ["-M", str(int(rng.integers(60, 100)))]
    if rng.random() < 0.3:
        parts += ["--max-n", ("0", "2", "0.1")[int(rng.integers(3))]]
    routing = rng.random()
    if n_adapters and routing < 0.15:
        parts += ["--discard-trimmed"]
    elif n_adapters and routing < 0.3:
        parts += ["--discard-untrimmed"]
    return parts, quality or nextseq


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_single_end(tmp_path, seed):
    rng = seeded("fuzz-se", seed)
    parts, needs_quals = random_config(rng)
    in_fmt = "fastq" if needs_quals or rng.random() < 0.7 else "fasta"
    in_name = "in." + in_fmt + (".gz" if rng.random() < 0.3 else "")
    alphabet = ("ACGT", "ACGTN", "ACGTNRYKMSWBDHVX")[int(rng.integers(3))]
    records = make_reads(
        rng, 260, alphabet, max_len=(110, 300)[int(rng.random() < 0.2)],
        lowercase=(0.0, 0.2)[int(rng.integers(2))],
        adapters=(TRUSEQ, FRONT, ANYWHERE),
    )
    inp = write_reads(str(tmp_path / in_name), records, in_fmt)
    out_fmt = "fasta" if in_fmt == "fasta" or rng.random() < 0.2 else "fastq"
    out = str(tmp_path / ("out." + out_fmt))
    outs = [out]
    argv = parts + ["-se", inp, "-o", out]
    if "-m" in parts and rng.random() < 0.5:
        outs.append(str(tmp_path / ("short." + out_fmt)))
        argv += ["--too-short-output", outs[-1]]
    if "-M" in parts and rng.random() < 0.5:
        outs.append(str(tmp_path / ("long." + out_fmt)))
        argv += ["--too-long-output", outs[-1]]
    if any(p in parts for p in ("-a", "-g", "-b")) and not any(
        p.startswith("--discard") for p in parts
    ) and rng.random() < 0.3:
        outs.append(str(tmp_path / ("untrimmed." + out_fmt)))
        argv += ["--untrimmed-output", outs[-1]]
    argv += [
        "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"),
    ]
    (jax_files, jax_summary), (port_files, port_summary) = run_both(argv, outs)
    label = "seed {}: {}".format(seed, " ".join(argv))
    assert sorted(jax_files) == sorted(port_files), label
    for path in jax_files:
        assert jax_files[path] == port_files[path], label + " -> " + path
    assert jax_summary == port_summary, label


@pytest.mark.parametrize("max_batch,depth", [(64, 3), (50, 1), (1000, 2)])
def test_small_batches_and_depths(tmp_path, monkeypatch, max_batch, depth):
    """Several batches in flight (and slots reused) give the same bytes."""
    rng = seeded("batches", max_batch, depth)
    inp = write_reads(
        str(tmp_path / "in.fastq"), make_reads(rng, 400, "ACGTN", lowercase=0.1)
    )
    out = str(tmp_path / "out.fastq")
    argv = [
        "-a", "tru=" + TRUSEQ, "-g", "front=" + FRONT, "-q", "10", "-m", "12",
        "-se", inp, "-o", out,
        "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"),
    ]
    monkeypatch.setattr(port_turbo.TurboTrimRunner, "MAX_BATCH", max_batch)
    monkeypatch.setattr(port_turbo.TurboTrimRunner, "DEPTH", depth)
    (jax_files, jax_summary), (port_files, port_summary) = run_both(argv, [out])
    assert jax_files[out] == port_files[out]
    assert jax_summary == port_summary
    assert port_turbo.LAST_RUN["batches"] == -(-400 // max_batch)
    assert port_turbo.LAST_RUN["device_batches"] == port_turbo.LAST_RUN["batches"]
    assert port_turbo.LAST_RUN["reads"] == 400


def test_max_reads_and_empty_input(tmp_path):
    rng = seeded("quota")
    inp = write_reads(str(tmp_path / "in.fastq"), make_reads(rng, 120))
    empty = write_reads(str(tmp_path / "empty.fastq"), [])
    out = str(tmp_path / "out.fastq")
    tail = [
        "-o", out, "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"),
    ]
    for argv in (
        ["-a", "tru=" + TRUSEQ, "--max-reads", "50", "-se", inp],
        ["-a", "tru=" + TRUSEQ, "-se", empty],
    ):
        (jax_files, jax_summary), (port_files, port_summary) = run_both(
            argv + tail, [out]
        )
        assert jax_files == port_files
        assert jax_summary == port_summary


def test_adapter_whose_column_exceeds_shared_memory(tmp_path, monkeypatch):
    """A 1,200-base adapter against reads of about 3,000 bases at 30 %
    errors: its cell needs the 64-bit word and its column does not fit a
    block's shared memory even for one warp, a shape the card once
    refused. On ``cpu`` the port gives the bytes and the statistics of
    ``atropos_tpu``'s scalar pipeline, its executable spec: for adapters
    of this length ``atropos_tpu``'s own turbo runner differs from that
    pipeline (ROADMAP.md, queue 3), so it is not the yardstick here."""
    from atropos_tpu_torch.align.cuda_kernel import THREADS_PER_BLOCK, CudaAligner

    rng = seeded("long-adapter")
    adapter = _bases(rng, 1200)
    records = []
    for i in range(12):
        length = int(rng.integers(2900, 3000))
        seq = list(_bases(rng, length))
        if i % 2:
            start = int(rng.integers(100, length - 600))
            frag = list(adapter[: length - start])
            for _ in range(int(rng.integers(0, 40))):
                frag[int(rng.integers(len(frag)))] = _bases(rng, 1)
            seq[start:] = frag
        records.append(("long{}".format(i), "".join(seq), "I" * len(seq)))
    inp = write_reads(str(tmp_path / "long.fastq"), records)
    out = str(tmp_path / "out.fastq")
    argv = [
        "-a", "long=" + adapter, "-e", "0.3", "--no-indels", "-se", inp, "-o", out,
        "--quiet", "--adapter-cache-file", str(tmp_path / ".adapters"),
        "--report-file", str(tmp_path / "report.txt"),
    ]
    aligner = CudaAligner(adapter, 0.3, 14, indel_cost=100000, device="cpu")
    kernel = aligner.kernel_for(3008)
    assert kernel.name == "dp_locate_wide"
    assert kernel.block_layout(1200) == (THREADS_PER_BLOCK, True)

    results = []
    for which in ("jax", "port"):
        if os.path.exists(out):
            os.remove(out)
        if which == "jax":
            monkeypatch.setenv("ATROPOS_TPU_ENGINE", "0")
            retcode, summary = jax_commands.get_command("trim").execute(argv)
            monkeypatch.delenv("ATROPOS_TPU_ENGINE")
            assert summary["mode"] == "serial"
        else:
            retcode, summary = port_commands.get_command("trim").execute(
                argv, device="cpu"
            )
            assert summary["mode"] == "turbo"
        assert retcode == 0
        with open(out, "rb") as handle:
            results.append((handle.read(), _comparable(summary)["trim"]))
    assert results[0][0] == results[1][0]
    assert results[0][1] == results[1][1]
    assert results[1][1]["modifiers"]["AdapterCutter"]["records_with_adapters"][0] > 0
