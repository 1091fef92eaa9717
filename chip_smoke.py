#!/usr/bin/env python3
"""Start the port on the GPU: build, check and time its kernels, and drive
its main path end to end.

Run from the root of a checkout, with one NVIDIA Hopper card:

    python3 chip_smoke.py [--seed N] [--reads N]

It imports ``atropos_tpu_torch`` only (never ``jax``, never ``atropos_tpu``)
and prints one JSON object a line:

1. ``device``   the card's name and power limit as ``nvidia-smi`` gives them
2. ``build``    seconds for ``nvcc`` (the DP kernels) and ``g++`` (the host
                runtime), built in parallel from the sources in the checkout
3. ``grid``     ``dp_locate_word32`` and ``dp_locate_wide`` against the plain
                PyTorch DP on the card over a covering set of configurations:
                exact equality of all result rows (tolerance 0, integers)
4. ``main_path``  a seeded FASTQ of 2,000,000 reads of 150 bases through
                ``python -m atropos_tpu_torch trim -a TRUSEQ -se IN -o OUT`` on
                ``cuda``; this path launches ``dp_locate_word32``
5. ``long_path``  a seeded FASTA of 8-kilobase reads against an 880-base
                vector at 30 % errors through the same entry point; the cell
                of this shape needs more than 32 bits, so this path launches
                ``dp_locate_wide``
6. ``goldens``  five upstream single-end cases on the card against
                ``tests/conformance/expected``
7. ``kernels``  for each kernel: launches on its path (counts set to 0 just
                before the path and read just after), error against the plain
                version, time at the path's shape, the plain version's time
                and the card's bound for the same work
8. the last line: ``{"ok": true, "device": {...}}``

Any phase that fails raises: the script then exits non-zero without the
last line. Without a usable card it exits non-zero at once.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False\n")
    sys.exit(1)

from atropos_tpu_torch import runtime  # noqa: E402
from atropos_tpu_torch.__main__ import main as port_main  # noqa: E402
from atropos_tpu_torch.align import _build, cuda_kernel  # noqa: E402
from atropos_tpu_torch.align.batched import _locate_kernel  # noqa: E402
from atropos_tpu_torch.align.cuda_kernel import (  # noqa: E402
    CudaAligner,
    dp_locate_wide,
    dp_locate_word32,
)
from atropos_tpu_torch.engine import turbo  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
DEVICE = torch.device("cuda", 0)
HBM_BYTES_PER_SECOND = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64

BACK, FRONT, ANYWHERE, PREFIX, SUFFIX = 14, 11, 15, 8, 2
BASES = np.frombuffer(b"ACGT", np.uint8)


def check(ok, message):
    """Fail the run (also under ``python -O``) unless ``ok``."""
    if not ok:
        raise AssertionError(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi(query):
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    )
    return done.stdout.strip().splitlines()[0]


# -- build --------------------------------------------------------------------


def phase_build():
    """Build every kernel source and the host runtime, all started
    together, from the sources in the checkout."""
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    results = {}
    errors = []

    def timed(name, fn):
        began = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - began)
        except Exception as exc:  # raised below, on the main thread
            errors.append((name, exc))

    jobs = [
        threading.Thread(
            target=timed,
            args=("nvcc dp_align.cu", lambda: _build.build("dp_align", verbose=True)),
        ),
        threading.Thread(target=timed, args=("g++ fastq.cpp", runtime.lib)),
    ]
    began = time.perf_counter()
    for job in jobs:
        job.start()
    for job in jobs:
        job.join()
    if errors:
        raise RuntimeError("build failed: {}".format(errors))
    ptxas = [
        line.strip()
        for line in results["nvcc dp_align.cu"][0][1].splitlines()
        if "registers" in line or "Compiling entry" in line
    ]
    emit({
        "build": {
            "seconds": time.perf_counter() - began,
            "nvcc_seconds": results["nvcc dp_align.cu"][1],
            "gxx_seconds": results["g++ fastq.cpp"][1],
            "flags": " ".join(_build.NVCC_FLAGS),
            "ptxas": ptxas,
        }
    })


# -- seeded read batches ------------------------------------------------------


def plant(rng, reads, lengths, adapter, place, share=0.6, sub_rate=0.03,
          indel_share=0.3, n_rate=0.01, min_frag=3):
    """Overwrite part of ``share`` of the reads ([B, L] uint8 ASCII, in
    place) with a copy of ``adapter``: a fragment of ragged length carrying
    substitutions, one insertion or deletion in ``indel_share`` of them,
    and 'N's. Returns (planted, start, clean): which reads carry a
    fragment, where it starts and whether it is an unmutated copy."""
    B, L = reads.shape
    m = len(adapter)
    ad = np.frombuffer(adapter.encode("ascii"), np.uint8)
    planted = (rng.random(B) < share) & (lengths >= min_frag)
    frag_len = np.minimum(rng.integers(min_frag, m + 1, B), np.maximum(lengths, 1))
    cols = np.arange(m + 1)[None, :]
    kind = rng.choice(3, size=B, p=[1 - indel_share, indel_share / 2, indel_share / 2])
    pos = rng.integers(0, m, B)[:, None]
    src = cols + ((kind == 1)[:, None] & (cols >= pos)) - (
        (kind == 2)[:, None] & (cols > pos)
    )
    frag = ad[np.clip(src, 0, m - 1)]
    inserted = (kind == 2)[:, None] & (cols == pos + 1)
    subs = rng.random((B, m + 1)) < sub_rate
    noise = BASES[rng.integers(0, 4, (B, m + 1))]
    frag = np.where(inserted | subs, noise, frag)
    ns = rng.random((B, m + 1)) < n_rate
    frag = np.where(ns, ord("N"), frag).astype(np.uint8)
    if place == "back":
        frag_src_off = np.zeros(B, np.int64)
        start = lengths - frag_len
    elif place == "front":
        frag_src_off = m - frag_len  # the adapter's tail at the read's head
        start = np.zeros(B, np.int64)
    else:
        frag_src_off = np.zeros(B, np.int64)
        start = (rng.random(B) * np.maximum(lengths - frag_len + 1, 1)).astype(np.int64)
    rel = np.arange(L)[None, :] - start[:, None]
    mask = (
        planted[:, None]
        & (rel >= 0)
        & (rel < frag_len[:, None])
        & (np.arange(L)[None, :] < lengths[:, None])
    )
    rows = np.nonzero(mask)[0]
    reads[mask] = frag[rows, (rel + frag_src_off[:, None])[mask].clip(0, m)]
    changed = (inserted | subs | ns) | (kind != 0)[:, None]
    clean = planted & ~(changed & (cols < m)).any(axis=1)
    return planted, start, clean


def random_batch(rng, B, L, adapter, place):
    lengths = rng.integers(0, L + 1, B).astype(np.int64)
    lengths[:6] = (0, 1, L, L, 2, min(L, len(adapter)))
    reads = BASES[rng.integers(0, 4, (B, L))]
    plant(rng, reads, lengths, adapter, place)
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return reads, lengths.astype(np.int32)


def device_inputs(aligner, reads, lengths):
    """[L, B] translated column-major reads and [1, B] lengths on the card,
    as the turbo step hands them to the kernel."""
    dev = torch.from_numpy(reads).to(DEVICE)
    if not aligner._compare_ascii:
        dev = aligner.query_lut[dev.long()]
    return dev.T.contiguous(), torch.from_numpy(lengths).to(DEVICE)[None, :].contiguous()


# -- kernels against their plain version ---------------------------------------


def grid_configs():
    """A covering set: every value of every factor appears at least twice
    (asserted below), not the full product."""
    flag_sets = [("a", BACK, "back"), ("g", FRONT, "front"), ("b", ANYWHERE, "any"),
                 ("prefix", PREFIX, "front"), ("suffix", SUFFIX, "back")]
    configs = []
    for i in range(36):
        name, flags, place = flag_sets[i % 5]
        configs.append(dict(
            idx=i, flag_name=name, flags=flags, place=place,
            iupac=bool((i // 5 + i) % 2),
            indel_cost=(1, 100000)[(i // 2) % 2],
            e=(0.1, 0.2)[(i // 3 + i // 7) % 2],
            m=(8, 33, 120)[i % 3],
            L=(32, 160, 320)[(i // 3 + i) % 3],
            B=32768,
        ))
    for factor, values in (
        ("flag_name", ["a", "g", "b", "prefix", "suffix"]), ("iupac", [False, True]),
        ("indel_cost", [1, 100000]), ("e", [0.1, 0.2]), ("m", [8, 33, 120]),
        ("L", [32, 160, 320]),
    ):
        for value in values:
            count = sum(1 for c in configs if c[factor] == value)
            check(count >= 2, (factor, value, count))
    # shapes whose cell does not fit 32 bits: dp_locate_wide's own domain
    configs.append(dict(idx=36, flag_name="a", flags=BACK, place="any", iupac=False,
                        indel_cost=100000, e=0.3, m=880, L=7328, B=1024))
    configs.append(dict(idx=37, flag_name="b", flags=ANYWHERE, place="any", iupac=True,
                        indel_cost=100000, e=0.3, m=880, L=7328, B=512))
    return configs


def make_adapter(rng, m, iupac):
    if m == 33 and not iupac:
        return TRUSEQ
    adapter = BASES[rng.integers(0, 4, m)].copy()
    if iupac:
        wild = np.frombuffer(b"NRYKMSWBDHV", np.uint8)
        where = rng.random(m) < 0.15
        adapter[where] = wild[rng.integers(0, len(wild), int(where.sum()))]
    return adapter.tobytes().decode("ascii")


def phase_grid(seed):
    began = time.perf_counter()
    compared = {"dp_locate_word32": 0, "dp_locate_wide": 0}
    max_err = {"dp_locate_word32": 0, "dp_locate_wide": 0}
    found_total = 0
    for cfg in grid_configs():
        rng = np.random.default_rng([seed, 1, cfg["idx"]])
        adapter = make_adapter(rng, cfg["m"], cfg["iupac"])
        aligner = CudaAligner(
            adapter, cfg["e"], cfg["flags"], wildcard_ref=cfg["iupac"],
            min_overlap=3, indel_cost=cfg["indel_cost"], device=DEVICE,
        )
        reads, lengths = random_batch(rng, cfg["B"], cfg["L"], adapter, cfg["place"])
        reads_T, lens = device_inputs(aligner, reads, lengths)
        params = aligner._dp_params()
        expected = _locate_kernel(
            reads_T, lens, aligner.ref_bytes, aligner.thresholds, **params
        )
        fits32 = dp_locate_word32.fits(cfg["m"], aligner.k, cfg["L"])
        kernels = []
        if fits32:
            kernels.append(dp_locate_word32)
            if cfg["idx"] % 3 == 0:
                kernels.append(dp_locate_wide)  # right where both apply
        else:
            kernels.append(dp_locate_wide)
        for kernel in kernels:
            got = kernel(reads_T, lens, aligner.ref_bytes, aligner.thresholds, **params)
            torch.cuda.synchronize()
            err = int((got.long() - expected.long()).abs().max())
            max_err[kernel.name] = max(max_err[kernel.name], err)
            if not torch.equal(got, expected):
                bad = int((got != expected).any(dim=0).sum())
                raise AssertionError(
                    "{} disagrees with its plain version on {} reads: {}".format(
                        kernel.name, bad, cfg
                    )
                )
            compared[kernel.name] += 1
        found_total += int(expected[0].sum())
    check(
        compared["dp_locate_word32"] >= 30 and compared["dp_locate_wide"] >= 12,
        'compared["dp_locate_word32"] >= 30 and compared["dp_locate_wide"] >= 12',
    )
    check(found_total > 0, 'found_total > 0')
    emit({
        "grid": {
            "configurations": len(grid_configs()),
            "compared": compared,
            "reads_with_a_match": found_total,
            "tolerance": 0,
            "seconds": time.perf_counter() - began,
        }
    })
    return max_err


def time_kernel(kernel, aligner, reads_T, lens, launches=20):
    """Median time of one launch (CUDA events after a warm-up), the plain
    version's time, and the bound for the cells these reads need."""
    params = aligner._dp_params()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    for _ in range(3):
        kernel(*args, **params)
    torch.cuda.synchronize()
    times = []
    for _ in range(launches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel(*args, **params)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    torch.cuda.synchronize()
    began = time.perf_counter()
    expected, cells = _locate_kernel(*args, count_cells=True, **params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - began) * 1e3
    if not torch.equal(out, expected):
        raise AssertionError(kernel.name + " disagrees at its path's shape")
    L, B = reads_T.shape
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    ops_ms = (
        int(cells) * cuda_kernel.OPS_PER_CELL
        / (props.multi_processor_count * INT32_LANES_PER_SM * clock_hz) * 1e3
    )
    bytes_ms = (L * B + 4 * B + 32 * B) / HBM_BYTES_PER_SECOND * 1e3
    return dict(
        ms=float(np.median(times)),
        plain_ms=plain_ms,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None,
        shape=dict(m=aligner.m, k=aligner.k, L=L, B=B),
        cell_updates=int(cells),
        full_matrix_cells=L * B * (aligner.m + 1),
        sm_count=props.multi_processor_count,
        sm_clock_mhz=clock_hz / 1e6,
    )


# -- the main path -------------------------------------------------------------


def write_truseq_fastq(path, rng, n_reads, read_len=150, chunk=250000):
    """Reads of ``read_len`` bases, half of them carrying the TruSeq
    adapter at a random offset with 1 % substitutions and occasional
    indels, a few lowercase, a few with 'N'. Returns per read: whether an
    unmutated adapter copy was planted, and its offset."""
    name_digits = 8
    record = 1 + name_digits + 1 + read_len + 3 + read_len + 1
    clean_all, start_all = [], []
    with open(path, "wb") as out:
        for first in range(0, n_reads, chunk):
            count = min(chunk, n_reads - first)
            reads = BASES[rng.integers(0, 4, (count, read_len))]
            lengths = np.full(count, read_len, np.int64)
            # the adapter runs off the read's end where it starts late
            long_reads = BASES[rng.integers(0, 4, (count, read_len + len(TRUSEQ)))]
            long_reads[:, :read_len] = reads
            planted, start, clean = plant(
                rng, long_reads, lengths + len(TRUSEQ), TRUSEQ, "any", share=0.5,
                sub_rate=0.01, indel_share=0.04, n_rate=0.0,
                min_frag=len(TRUSEQ),
            )
            reads = long_reads[:, :read_len].copy()
            planted &= start < read_len
            with_n = rng.random(count) < 0.01
            n_pos = rng.integers(0, read_len, count)
            reads[with_n, n_pos[with_n]] = ord("N")
            in_adapter = with_n & planted & (n_pos >= start) & (n_pos < start + len(TRUSEQ))
            clean = clean & planted & ~in_adapter
            lower = rng.random(count) < 0.01
            reads[lower] |= 0x20
            quals = (33 + rng.integers(2, 41, (count, read_len))).astype(np.uint8)
            block = np.empty((count, record), np.uint8)
            block[:, 0] = ord("@")
            ids = np.arange(first, first + count)
            for digit in range(name_digits):
                block[:, name_digits - digit] = 48 + (ids // 10 ** digit) % 10
            pos = 1 + name_digits
            block[:, pos] = 10
            block[:, pos + 1 : pos + 1 + read_len] = reads
            pos += 1 + read_len
            block[:, pos : pos + 3] = np.frombuffer(b"\n+\n", np.uint8)
            block[:, pos + 3 : pos + 3 + read_len] = quals
            block[:, -1] = 10
            out.write(block.tobytes())
            clean_all.append(clean)
            start_all.append(start)
    return np.concatenate(clean_all), np.concatenate(start_all)


def output_lengths(path, fasta=False):
    with open(path, "rb") as handle:
        data = handle.read()
    if fasta:
        chunk = runtime.parse_fasta_chunk(data, final=True)
    else:
        chunk = runtime.parse_chunk(data)
        check(chunk.consumed == len(data), 'chunk.consumed == len(data)')
    return chunk.seq_len.copy()


def run_trim(argv, device):
    """One command line through the port's entry point, with the kernels'
    launch counts set to 0 just before and read just after."""
    cuda_kernel.reset_launch_counts()
    began = time.perf_counter()
    retcode = port_main(argv, device=device)
    seconds = time.perf_counter() - began
    counts = cuda_kernel.launch_counts()
    if retcode != 0:
        raise RuntimeError("trim exited with {}: {}".format(retcode, argv))
    return seconds, counts, dict(turbo.LAST_RUN)


def phase_main_path(work, seed, n_reads, runs):
    rng = np.random.default_rng([seed, 2])
    fastq = os.path.join(work, "reads.fastq")
    began = time.perf_counter()
    clean, start = write_truseq_fastq(fastq, rng, n_reads)
    made = time.perf_counter() - began
    out = os.path.join(work, "trimmed.fastq")
    tail = ["--quiet", "--no-cache-adapters", "--report-file", os.path.join(work, "report.txt")]
    argv = ["trim", "-a", TRUSEQ, "-se", fastq, "-o", out] + tail
    seconds, counts, run = run_trim(argv, "cuda")
    # further runs of the same command, for the spread of the host's clock
    repeats = [run_trim(argv, "cuda")[0] for _ in range(runs - 1)]

    launches = counts["dp_locate_word32"]
    check(run["device"].startswith("cuda"), run)
    check(run["reads"] == n_reads, 'run["reads"] == n_reads')
    check(launches > 0 and launches == run["batches"] * run["device_aligners"], (counts, run))
    check(counts["dp_locate_wide"] == 0, 'counts["dp_locate_wide"] == 0')
    lengths = output_lengths(out)
    check(lengths.shape[0] == n_reads, "reads in != reads out")
    # an unmutated copy with at least 20 of its bases inside the read is cut
    # exactly where it was planted
    sure = clean & (start <= 150 - 20)
    check(int(sure.sum()) > n_reads // 4, 'int(sure.sum()) > n_reads // 4')
    wrong = int((lengths[sure] != start[sure]).sum())
    check(wrong == 0, "{} reads with a clean adapter were not cut at its offset".format(wrong))
    trimmed = int((lengths < 150).sum())

    # the first 65,536 reads again on the CPU: a byte-identical prefix
    cpu_out = os.path.join(work, "trimmed_cpu.fastq")
    cpu_argv = ["trim", "-a", TRUSEQ, "-se", fastq, "-o", cpu_out, "--max-reads", "65536"] + tail
    cpu_seconds, cpu_counts, cpu_run = run_trim(cpu_argv, "cpu")
    check(
        cpu_run["device"] == "cpu" and sum(cpu_counts.values()) == 0,
        'cpu_run["device"] == "cpu" and sum(cpu_counts.values()) == 0',
    )
    with open(cpu_out, "rb") as handle:
        cpu_bytes = handle.read()
    with open(out, "rb") as handle:
        gpu_prefix = handle.read(len(cpu_bytes))
    check(len(cpu_bytes) > 0 and cpu_bytes == gpu_prefix, "CPU and GPU outputs differ")

    emit({
        "main_path": {
            "argv": "trim -a TRUSEQ -se reads.fastq -o trimmed.fastq",
            "reads": n_reads,
            "read_length": 150,
            "input_bytes": os.path.getsize(fastq),
            "make_input_seconds": made,
            "seconds": seconds,
            "repeat_seconds": repeats,
            "reads_per_second": n_reads / seconds,
            "batches": run["batches"],
            "launches": counts,
            "reads_trimmed": trimmed,
            "clean_adapters_checked": int(sure.sum()),
            "split_seconds": {
                "parse (reader thread)": run["parse_seconds"],
                "main thread waiting for a parsed chunk": run["chunk_wait_seconds"],
                "main thread preparing batches (cuts, gather, pack)": run["prepare_seconds"],
                "main thread enqueueing uploads and device steps": run["dispatch_seconds"],
                "device wait": run["device_wait_seconds"],
                "main thread resolving windows, statistics, routing": run["resolve_seconds"],
                "format (writer thread)": run["format_seconds"],
                "write (writer thread)": run["write_seconds"],
            },
            "cpu_check": {"reads": 65536, "seconds": cpu_seconds, "identical_prefix_bytes": len(cpu_bytes)},
        }
    })
    os.remove(out)
    os.remove(cpu_out)
    return launches, fastq


def time_device_step(fastq, work, launches=20):
    """Time of the lane's whole device step for one batch of the main path
    (unpack, table decode into [L, B], the DP kernel, result packing and
    int16 narrowing) beside the DP kernel alone: what the torch ops around
    the kernel cost on the card."""
    from atropos_tpu_torch.commands import get_command
    from atropos_tpu_torch.commands.trim import RecordHandler
    from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder

    command = get_command("trim")
    options = command.parse_args([
        "-a", TRUSEQ, "-se", fastq, "-o", os.path.join(work, "unused.fastq"),
        "--quiet", "--no-cache-adapters",
    ])
    runner = command.runner_class(options)
    modifiers, filters, formatters, writers = TrimStackBuilder(runner).build()
    lane = turbo.TurboTrimRunner.build(
        runner, RecordHandler(modifiers, filters, formatters), writers,
        device="cuda",
    ).lane
    runner.reader.close()
    with open(fastq, "rb") as handle:
        chunk = runtime.parse_chunk(handle.read(32768 * 314))
    tok, args, bits = lane.prepare(chunk, slice(0, 32768))
    main_dev, win_dev, tables_dev = [arg.to(DEVICE) for arg in args]
    for _ in range(3):
        lane._step(tok.width, bits, main_dev, win_dev, tables_dev)
    torch.cuda.synchronize()
    cuda_kernel.reset_launch_counts()
    times = []
    for _ in range(launches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        bundle = lane._step(tok.width, bits, main_dev, win_dev, tables_dev)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    check(
        cuda_kernel.launch_counts()["dp_locate_word32"] == launches,
        'cuda_kernel.launch_counts()["dp_locate_word32"] == launches',
    )
    return dict(
        step_ms=float(np.median(times)),
        bits_per_base=bits,
        upload_bytes=int(sum(arg.numel() * arg.element_size() for arg in args)),
        bundle_bytes=int(bundle.numel() * bundle.element_size()),
        bundle_rows=int(bundle.shape[0]),
        width=tok.width,
        batch=tok.batch,
    )


def truseq_batch(fastq):
    """The first batch of the main path's input as the kernel sees it:
    TruSeq m = 33, k = 3, width 160, B = 32768."""
    with open(fastq, "rb") as handle:
        data = handle.read(32768 * 314)
    chunk = runtime.parse_chunk(data)
    check(chunk.n == 32768, 'chunk.n == 32768')
    reads = chunk.padded_sequences(160)
    reads = np.where((reads >= 97) & (reads <= 122), reads - 32, reads).astype(np.uint8)
    return reads, chunk.seq_len.astype(np.int32)


def phase_long_path(work, seed):
    """8-kilobase reads against an 880-base vector at 30 % errors without
    indels: matches 10 bits, origin 14 bits, cost 9 bits, so the cell needs
    33 bits and the lane's aligner picks ``dp_locate_wide``."""
    rng = np.random.default_rng([seed, 3])
    m, n_reads = 880, 1024
    vector = BASES[rng.integers(0, 4, m)].tobytes().decode("ascii")
    lengths = rng.integers(6000, 7300, n_reads)
    # the FASTA stream hands over the last record as a batch of its own:
    # both batches are as wide as the longest read
    lengths[0] = lengths[-1] = 7312
    fasta = os.path.join(work, "long.fasta")
    starts = np.full(n_reads, -1, np.int64)
    with open(fasta, "w") as out:
        for i in range(n_reads):
            seq = BASES[rng.integers(0, 4, int(lengths[i]))]
            if i % 2:
                starts[i] = int(rng.integers(100, lengths[i] - m))
                seq[starts[i] : starts[i] + m] = np.frombuffer(vector.encode(), np.uint8)
            out.write(">long{}\n{}\n".format(i, seq.tobytes().decode("ascii")))
    trimmed = os.path.join(work, "long_trimmed.fasta")
    argv = ["trim", "-a", vector, "-e", "0.3", "--no-indels", "-se", fasta, "-o", trimmed,
            "--quiet", "--no-cache-adapters", "--report-file", os.path.join(work, "report2.txt")]
    seconds, counts, run = run_trim(argv, "cuda")
    launches = counts["dp_locate_wide"]
    check(launches > 0 and launches == run["batches"] * run["device_aligners"], (counts, run))
    check(counts["dp_locate_word32"] == 0, 'counts["dp_locate_word32"] == 0')
    out_len = output_lengths(trimmed, fasta=True)
    check(out_len.shape[0] == n_reads, "reads in != reads out")
    has = starts >= 0
    check(np.array_equal(out_len[has], starts[has]), "a planted vector was not cut at its offset")
    check(np.all(out_len[~has] <= lengths[~has]), 'np.all(out_len[~has] <= lengths[~has])')
    emit({
        "long_path": {
            "argv": "trim -a VECTOR880 -e 0.3 --no-indels -se long.fasta -o long_trimmed.fasta",
            "reads": n_reads, "read_length": "6000-7312", "adapter_length": m,
            "seconds": seconds, "batches": run["batches"], "launches": counts,
            "vectors_checked": int(has.sum()),
        }
    })

    # the same batch as the lane hands it to the kernel, for the timing
    with open(fasta, "rb") as handle:
        chunk = runtime.parse_fasta_chunk(handle.read(), final=True)
    width = -(-int(chunk.seq_len.max()) // 32) * 32
    aligner = CudaAligner(vector, 0.3, BACK, min_overlap=3, indel_cost=100000, device=DEVICE)
    check(
        aligner.kernel_for(width) is dp_locate_wide,
        'aligner.kernel_for(width) is dp_locate_wide',
    )
    check(
        not dp_locate_word32.fits(m, aligner.k, width),
        'not dp_locate_word32.fits(m, aligner.k, width)',
    )
    reads_T, lens = device_inputs(
        aligner, chunk.padded_sequences(width), chunk.seq_len.astype(np.int32)
    )
    return launches, time_kernel(dp_locate_wide, aligner, reads_T, lens, launches=20)


# -- goldens ---------------------------------------------------------------------

GOLDENS = [
    ("-b TTAGACATATCTCCGTCG", "small.fastq", "small.fastq"),
    ("-a VCCGAMCYUCKHRKDCUBBCNUWNSGHCGU", "illumina.fastq", "illumina.fastq.gz"),
    ("-a TTAGACATAT -g GAGATTGCCA --no-indels", "no_indels.fasta", "no_indels.fasta"),
    ("-a AATTTCAGGAATT -a GTTCTCTAGTTCT", "twoadapters.fasta", "twoadapters.fasta"),
    ("-m 24 -O 10 -a AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA", "polya.fasta", "polya.fasta"),
]


def phase_goldens(work):
    conformance = os.path.join(ROOT, "tests", "conformance")
    launches = 0
    for params, expected, inpath in GOLDENS:
        out = os.path.join(work, "golden_" + expected)
        argv = ["trim"] + params.split() + [
            "-se", os.path.join(conformance, "data", inpath), "-o", out, "--quiet",
            "--no-cache-adapters", "--report-file", os.path.join(work, "report3.txt"),
        ]
        _, counts, _ = run_trim(argv, "cuda")
        launches += sum(counts.values())
        with open(out, "rb") as got, open(
            os.path.join(conformance, "expected", expected), "rb"
        ) as want:
            if got.read() != want.read():
                raise AssertionError("golden case differs on the card: " + params)
    check(launches >= len(GOLDENS), 'launches >= len(GOLDENS)')
    emit({"goldens": {"cases": len(GOLDENS), "identical": len(GOLDENS), "launches": launches}})


# -- main --------------------------------------------------------------------------


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=20240229)
    parser.add_argument("--reads", type=int, default=2000000,
                        help="reads of the main path's input")
    parser.add_argument("--main-path-runs", type=int, default=1,
                        help="times the main path's command is run (the "
                             "first run is the one checked and reported)")
    args = parser.parse_args()
    began = time.perf_counter()

    card = smi("name,power.limit")
    emit({"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm_clock_max": smi("clocks.max.sm")})
    phase_build()
    max_err = phase_grid(args.seed)

    work = tempfile.mkdtemp(prefix="atropos_chip_smoke_")
    try:
        word32_launches, fastq = phase_main_path(
            work, args.seed, args.reads, args.main_path_runs
        )
        reads, lengths = truseq_batch(fastq)
        truseq = CudaAligner(TRUSEQ, 0.1, BACK, min_overlap=3, device=DEVICE)
        check(
            truseq.kernel_for(160) is dp_locate_word32,
            'truseq.kernel_for(160) is dp_locate_word32',
        )
        reads_T, lens = device_inputs(truseq, reads, lengths)
        word32_time = time_kernel(dp_locate_word32, truseq, reads_T, lens)
        # beside it, for PERF.md: the 64-bit kernel at the same shape
        wide_at_truseq = time_kernel(dp_locate_wide, truseq, reads_T, lens)
        emit({"dp_locate_wide_at_main_path_shape": wide_at_truseq})
        step = time_device_step(fastq, work)
        step["dp_kernel_ms"] = word32_time["ms"]
        emit({"device_step_at_main_path_shape": step})
        wide_launches, wide_time = phase_long_path(work, args.seed)
        phase_goldens(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for kernel, launches, timing in (
        (dp_locate_word32, word32_launches, word32_time),
        (dp_locate_wide, wide_launches, wide_time),
    ):
        if launches <= 0:
            raise AssertionError(kernel.name + " was not launched on its path")
        entry = {
            "name": kernel.name,
            "route": "cuda",
            "source": "atropos_tpu_torch/csrc/dp_align.cu",
            "replaces": kernel.replaces.split(" ")[0],
            "launches": launches,
            "max_abs_err": max_err[kernel.name],
        }
        entry.update(timing)
        kernels.append(entry)
    print(card, flush=True)
    emit({"seconds": time.perf_counter() - began})
    emit({"kernels": kernels})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })


if __name__ == "__main__":
    main()
