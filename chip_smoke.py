#!/usr/bin/env python3
"""Start the port on the GPU: build, check and time its kernels, and drive
its single-end and paired-end paths end to end, through the turbo runners
and through the per-record pipeline with its batched engine, in two ranks
on the card and in ``--threads`` workers, and its qc, detect and error
commands.

Run from the root of a checkout, with one NVIDIA Hopper card:

    python3 chip_smoke.py [--seed N] [--reads N]

It imports ``atropos_tpu_torch`` and the measurement tools beside it,
``cuda_tools`` (never ``jax``, never ``atropos_tpu``), and prints one JSON
object a line:

1. ``device``   the card's name and power limit as ``nvidia-smi`` gives them
2. ``build``    seconds for ``nvcc`` (the DP kernels, the diagonal-count
                kernels, the dtype probe's kernels) and ``g++`` (the host
                runtime), all built in parallel from the sources in the
                checkout; the instructions a row of each register
                instantiation of ``dp_locate_word32`` takes, and a row of
                each dtype probe kernel's column loops, counted in the SASS
                just built (``cuda_tools/sass_rows.py``)
   ``inputs``   the large seeded inputs of the paths below, written by
                spawned processes while the kernels build: the wall time,
                each writer's seconds and each input's bytes
3. ``grid``     ``dp_locate_word32`` and ``dp_locate_wide`` against the plain
                PyTorch DP on the card over a covering set of configurations
                (indel costs 1, 2, 3 and 100000; adapters on both sides of
                every row cap of ``dp_locate_word32``'s register column, 15,
                16, 31, 32, 47, 48, 63 and 64 bases; 880-base adapters on
                512 reads of 7,328 bases, which ``dp_locate_wide`` serves one
                warp a read, with indel costs 1, 2, 3 and 100000 in both
                compare modes; adapters of 1,200 and 2,000 bases whose column
                lives in global memory; the batched engine's shapes, 64 and
                1,024 reads of 64 and 160 bases): exact equality of all result rows
                (tolerance 0, integers), which instantiation served each, and
                the warp instantiation's fix-up rounds a column
4. ``diag_grid``  ``diag_counts_u8`` and ``diag_counts_i32`` against their
                plain version over windows of 31 to 512 (both sides of
                each 32-position word edge) and of 1,500 and 3,000 (cut
                into slabs), three alphabets (every byte value among
                them), lengths up to 2W (where the plain version wraps)
                and batches of 32,768, 32,767, 4,096 and 4,095 pairs
5. ``main_path``  a seeded FASTQ of 2,000,000 reads of 150 bases through
                ``python -m atropos_tpu_torch trim -a TRUSEQ -se IN -o OUT`` on
                ``cuda``; this path launches ``dp_locate_word32``
5a. ``ranks_se_path``  the main path's command line in two ranks on the one
                card (spawned processes joined by ``torch.distributed`` over
                Gloo on localhost, each passing ``cuda:0`` to the entry
                point): each rank trims the 64 MiB chunks it owns into its
                ``.{rank}`` shard with ``dp_locate_word32``; the shards'
                records disjoint, laid out in chunk order the main path's
                output byte for byte, rank 0's report of the merged
                summaries the main path's from its trimming section on; each
                rank's seconds, reads/s and launches
6. ``long_path``  a seeded FASTA of 8-kilobase reads against an 880-base
                vector at 30 % errors through the same entry point; the cell
                of this shape needs more than 32 bits, so this path launches
                ``dp_locate_wide`` (one warp a read); the instantiation, its
                lane-row slots and fix-up rounds
7. ``pe_insert_path``  1,000,000 seeded read pairs of 2x150 (TruSeq
                adapters after normal inserts of mean 220, and a near-poly-A
                block) through ``trim --aligner insert -a AD1 -A AD2 -pe1 -pe2
                -o -p``; the window is <= 255, so this path launches
                ``diag_counts_u8`` and, for the fallback adapter matches of
                both mates, ``dp_locate_word32``
8. ``pe_insert_wide_path``  200,000 pairs of 2x300 (inserts of mean 400):
                the window is > 255, so this path launches ``diag_counts_i32``
9. ``pe_adapter_path``  the 2x150 pairs with ``--aligner adapter``
10. ``pe_side_path``  the 2x150 pairs with ``--aligner insert --stats both
                --info-file -r``: the statistics' position counts run on the
                card; ``diag_counts_u8`` launches
10a. ``ranks_pe_path``  ``pe_insert_path``'s command line on its first
                ``RANK_PAIRS`` pairs (cut from 1,000,000), once in this
                process and once in two ranks, which own alternate pair
                batches and launch ``diag_counts_u8``: both mates' shards and
                the merged report against the one-process run's
11. ``pe_overwrite_path``  1,000,000 new pairs of 2x150, a tenth of them
                with one mate's 5' window at quality 2 and the other's at 35,
                through ``--aligner adapter -w 10,30,10``
12. ``se_side_path``  1,000,000 reads of 150 bases, a quarter each carrying a
                TruSeq, a Nextera and a small-RNA UMI adapter, through ``-o
                out.{name}.fastq --info-file -r --wildcard-file --stats both``
                with the three adapters named
13. ``dtype_probe``  ``dtype_probe_i32`` and ``dtype_probe_i16x2`` against
                their plain version (the whole final state, both shapes of the
                probe tool, query byte moving and fixed, 3 seeds, the planes of
                ``dtype_probe.PLANES``, and N of 1,002 and 16,386 reads, no
                multiple of any block width), their times and SASS
                instructions a row, and the probe tool's run on the card
14. ``goldens``  thirteen upstream single-end cases (the info files and the
                demultiplexed outputs among them; the last six run through the
                per-record pipeline), every paired-end case of the ported
                slice (``mask_adapter`` through the pipeline, with both
                aligners) and the 20 colorspace cases (``-c``: the pipeline
                on the scalar aligner, as in the reference; no launch) on the
                card against ``tests/conformance``
15. ``se_engine_path``  250,000 reads of 150 bases (``se_side_path``'s
                generator) through ``trim -a truseq=... -a nextera=... -a
                umi=... -n 2 --mask-adapter -y _{name}``: the turbo runner
                declines it, so the per-record pipeline runs it, its batched
                engine launching ``dp_locate_word32``; every clean TruSeq
                copy of at least 20 bases is masked from its offset on
16. ``pe_engine_path``  125,000 pairs of 2x150 through ``trim --aligner
                adapter --bisulfite swift``: the pipeline, ``dp_locate_word32``
17. ``pe_engine_insert_check``  2,048 pairs (150 near-poly-A) through
                ``--aligner insert -n 3 --mask-adapter`` (``diag_counts_u8``;
                pairs without an insert match fall back to each mate's scalar
                ``match_to``) and ``--aligner adapter --merge-overlapping
                --merged-output`` (each pair aligned by the scalar
                ``Aligner``): the time of those per-pair host steps. Each
                engine path prints its wall time and rate, its launches, the
                changes of the engine's ``BUILD_COUNTS`` and ``MATCH_COUNTS``
                and its mode
18. ``pe_correct_path``  ``pe_insert_path``'s pairs with
                ``--correct-mismatches liberal``: the turbo runner corrects
                the overlaps on the host (``diag_counts_u8``,
                ``dp_locate_word32``); the corrected pairs and bases
19. ``se_sam_engine_path``  250,000 unaligned SAM records (flag 4) of
                ``se_side_path``'s reads through ``-a truseq=... -a nextera=...
                -a umi=... -se IN.sam``: the SAM reader and the pipeline,
                ``dp_locate_word32``
20. ``pe_sam_engine_path``  125,000 pairs in one queryname-sorted SAM (flags
                77 and 141) through ``--aligner adapter -l IN.sam -o -p``
21. ``se_fastaqual_engine_path``  125,000 reads as FASTA + ``.qual`` through
                ``-a truseq=... -q 20 -se IN.fasta -sq IN.qual``
22. ``se_stats_serial_check``  8,192 reads with Illumina names through
                ``--stats both:tiles -a truseq=... --times 2``: no engine, every
                read on the scalar aligner (the reference's route), the
                position counts on the card; cut in size for the scalar step
23. ``qc_path``  ``qc -se`` on the main path's reads (kept until here): the
                native route, the statistics' position counts on the card;
                the main path's CPU prefix with ``--max-reads 65536`` again
24. ``pe_qc_path``  ``qc -pe1 -pe2`` on ``pe_insert_path``'s pairs
25. ``detect_path``, ``detect_known_path``, ``detect_khmer_path``  ``detect``
                with the bundled contaminants on the main path's first
                ``DETECT_READS`` reads (the heuristic, the default; cut from
                10,000), ``DETECT_KNOWN_READS`` (``-i known``; cut from
                10,000) and ``DETECT_KHMER_READS`` (``-d khmer``): the k-mer
                sorts and counts, or the contaminant intersections, on the
                card; every input's matches
26. ``pe_detect_check``  ``detect -i known`` on ``PE_DETECT_PAIRS`` pairs of
                ``pe_insert_path``
27. ``error_path``  ``error -se`` and ``error -pe1 -pe2`` at the default
                ``--max-reads`` of 10,000 (host work, as in the reference)
27a. ``threads_path``  ``trim --threads 3`` (the writer process,
                ``--no-writer-process``, ``--preserve-order``) and ``qc
                --threads 2`` in ``QC_THREADS_BATCHES`` batches) on
                ``THREADS_READS`` reads of the main path, the four at once
                through ``python -m atropos_tpu_torch``: spawned workers on
                the per-record pipeline without an engine. Host only for
                trim (no kernel, no device op); qc's workers count
                positions on the card. The three trim runs' records,
                summaries and reports agree; the CPU phase holds them, and
                qc's merged count tables, against the same command lines
                without the worker options on ``--device cpu``
28. ``kmer_ops``  the k-mer count op on the card against ``np.unique`` at
                ``KMER_HOLD_CODES`` codes and k of ``KMER_HOLD_KS``, the
                intersection op at M x R = 256 and at the known path's shape
                against ``np.isin`` and ``intersection_size``, tolerance 0;
                each op's time on the card beside numpy's on the host. Each
                of 23-27 prints its seconds, its rate, and its position
                counts and k-mer ops on the card; none launches a kernel
29. ``cpu_phase``  every ``--device cpu`` check, after the last timed card
                phase (below): its wall time, each check's threads and
                each child's seconds. The grids (3 and 4) and the goldens
                (14), which time nothing, run beside it, after the timed
                phases
30. ``kernels``  for each kernel: launches on its path (counts set to 0 just
                before the path and read just after), error against the plain
                version, time at the path's shape (``ms``: the median of
                single launches, each between two events, the wrapper's host
                work included; ``queued_ms``: launches queued behind a device
                sleep, the kernel alone), the plain version's time,
                the card's bound for the same work, the time of one PyTorch
                call that computes the same function where there is one (the
                diagonal counts: a grouped ``conv1d`` over one-hot codes), and
                for the DP kernels the instantiation that served the shape,
                the cell updates and the warp-level row slots (for one warp
                a read: the lane-row slots, the columns and the fix-up
                rounds of an instrumented launch); for the diagonal counts
                the position compares, the 32-position words of their bit
                planes and the live diagonals, the bytes, and the bound at
                one operation a compare beside the bound at
                ``insert_kernel.WORD_OPS`` a word and
                ``insert_kernel.DIAGONAL_OPS`` a diagonal; for
                ``dp_locate_word32`` and ``diag_counts_u8`` also their
                launches on the engine paths (``engine_launches``) and each
                rank's on the rank paths (``rank_launches``), for
                ``diag_counts_u8`` also on ``pe_correct_path``
                (``correct_path_launches``)
31. the last line: ``{"ok": true, "device": {...}}``

Every path whose output the card makes (but the rank paths, which are held
to the one-process card runs of the same command lines) also runs on
``--device cpu`` for a prefix of its input (``CPU_CHECK_RECORDS``: ``(DEPTH + 2) x MAX_BATCH`` =
163,840 reads of the main path and pairs of ``pe_insert_path``, whose
prefixes reach the batches that reuse pinned slots; two batches, 65,536
reads or pairs, of the other turbo paths and of qc; 32,768 records of each
engine path; all 2,048 pairs of the insert check, all 8,192 reads of the
``--stats`` check, and every record of the detect and error paths):
the CPU's outputs must be byte-identical prefixes of the card's (the side
files and every demultiplexed file among them); for the side and engine
paths the card also runs the prefix alone, and its statistics, summary and
report must equal the CPU's. The card phases only leave these runs behind
(the prefix of the input, the card output's prefix, the argv); one phase
after the last timed card phase runs them in spawned child processes, one
a host core but the one that runs the untimed card checks beside them
(the grids, the goldens), less one for the second thread of the longest
check, longest check first, each check with its threads and each child
checking that it launched no kernel, so that no timed card run shares the
host with them; the main process takes the checks left once its untimed
checks are done.

Any phase that fails raises: the script then exits non-zero without the
last line. Without a usable card it exits non-zero at once.
"""
import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
from functools import lru_cache, partial

import numpy as np
import torch

from atropos_tpu_torch import runtime
from atropos_tpu_torch.__main__ import main as port_main
from atropos_tpu_torch.align import _build, cuda_kernel, insert_kernel
from atropos_tpu_torch.align.batched import (
    _locate_kernel,
    insert_candidate_slots,
)
from atropos_tpu_torch.align.cuda_kernel import (
    CudaAligner,
    dp_locate_wide,
    dp_locate_word32,
)
from atropos_tpu_torch.align.insert_kernel import (
    diag_counts_i32,
    diag_counts_u8,
)
from atropos_tpu_torch import engine
from atropos_tpu_torch.commands import get_command
from atropos_tpu_torch.commands import stats
from atropos_tpu_torch.commands import detect as detect_command
from atropos_tpu_torch.commands.detect import kmers
from atropos_tpu_torch.commands.trim import pipeline
from atropos_tpu_torch.engine import turbo
from atropos_tpu_torch.tools import dtype_probe
from cuda_tools import sass_rows, timing

ROOT = os.path.dirname(os.path.abspath(__file__))
TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
# TruSeq read-2 adapter: what mate 2 reads into after a short insert
TRUSEQ2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
PAIRS = 1000000  # 2x150 pairs of the insert and adapter paired-end paths
WIDE_PAIRS = 200000  # 2x300 pairs of the wide insert path
# 150-base reads of the single-end side path: halved from 2,000,000 to keep the
# script inside its time limit (host-bound side files)
SIDE_READS = 1000000
# records of the main single-end path and pairs of the insert path run again
# on the CPU: a batch holds at most MAX_BATCH records, so this prefix holds
# the card's first DEPTH + 2 batches whole, and batches DEPTH + 1 and
# DEPTH + 2 reuse pinned upload and fetch slots that earlier batches released
SLOT_REUSE_READS = (turbo.TurboTrimRunner.DEPTH + 2) * turbo.TurboTrimRunner.MAX_BATCH
SLOT_REUSE_PAIRS = (turbo.TurboPairedRunner.DEPTH + 2) * turbo.TurboPairedRunner.MAX_BATCH
# pairs of the other paired-end turbo paths run again on the CPU: two batches
# whole, cut from DEPTH + 2 batches to keep the script inside its time limit
# (the two prefixes above reach the reused slots)
CPU_PAIRS = 2 * turbo.TurboPairedRunner.MAX_BATCH
MAIN_CPU_READS = 65536  # reads of the qc path's prefix run again on the CPU
# 150-base reads of the single-end engine path and 2x150 pairs of the
# paired-end one: cut from 1,000,000 and 500,000 (twice halved) to keep the
# script inside its time limit on a slow host; both paths are host-bound
# per-record Python
ENGINE_READS = 250000
ENGINE_PAIRS = 125000
# records of each engine path run again on the CPU (cut from 65,536): the
# pipeline's batches hold 1,000 records, so the prefix spans 32 and more
ENGINE_CPU_RECORDS = 32768
# pairs of the engine's insert and merge check (150 of them near-poly-A), all
# run again on the CPU: the per-pair host steps of these configurations are
# scalar Python, as in the reference
INSERT_CHECK_PAIRS, INSERT_CHECK_POLY_A = 2048, 150
# the SAM and FASTA + qual paths, halved with the engine paths they are made of
SAM_READS = 250000  # unaligned SAM records of the single-end SAM path
SAM_PAIRS = 125000  # pairs of the paired-end SAM path, in one SAM
FASTAQUAL_READS = 125000  # reads of the FASTA + qual path
# reads of the --stats check of a declined configuration, all run again on
# the CPU: the pipeline collects its statistics per record and matches its
# adapters on the scalar aligner (no engine), as the reference does
STATS_CHECK_READS = 8192
# reads of the detect paths, from the main path's input, and pairs of the
# paired check, from pe_insert_path's; every one runs again on the CPU. The
# heuristic's rounds and the known detector's scoring are per-k-mer and
# per-read Python, as in the reference: detect_path is cut from the default
# --max-reads of 10,000 to 1,000 reads, detect_known_path to 4,000
DETECT_READS = 1000
DETECT_KNOWN_READS = 4000
DETECT_KHMER_READS = 10000
PE_DETECT_PAIRS = 2000
ERROR_RECORDS = 10000  # error's default --max-reads, single-end and paired
# pairs of the 2x150 input that ranks_pe_path trims in two ranks, cut from
# 1,000,000 to keep the added time small
RANK_PAIRS = 500000
# reads of the main path's prefix that threads_path runs with --threads (cut
# from the 100,000 that would do: a --threads run's wall is mostly its
# workers' start and the writer's polls, as in the reference), all run again
# on the CPU without the worker options
THREADS_READS = 20000
# batches of threads_path's qc run, so that both of its workers take some
QC_THREADS_BATCHES = 10
# codes of the hold of the k-mer count op, at k = 12, 13 and 21: both sides
# of the op's threshold, and two large corpora
KMER_HOLD_CODES = (1 << 14, (1 << 14) + 1, 1 << 20, 1 << 24)
KMER_HOLD_KS = (12, 13, 21)
DEVICE = torch.device("cuda", 0)
HBM_BYTES_PER_SECOND = 3.35e12  # H100 SXM data sheet
# integer operations an SM can issue a clock: 4 schedulers, one warp
# instruction of 32 lanes each. The SM's 64 INT32 lanes alone bound no mixed
# integer body: Hopper also issues integer adds and moves on its FMA pipes,
# and the dtype probe's 32-bit kernel ran faster than 64 lanes allow.
INT_OPS_PER_SM_CLOCK = 128

BACK, FRONT, ANYWHERE, PREFIX, SUFFIX = 14, 11, 15, 8, 2
# adapter lengths on both sides of each row cap of dp_locate_word32's
# register column (m + 1 rows of 16, 32, 48, 64) and at 64, the first
# served from shared memory
ROW_CAP_MS = (15, 16, 31, 32, 47, 48, 63, 64)
BASES = np.frombuffer(b"ACGT", np.uint8)
#: instructions of one row of each register instantiation of
#: dp_locate_word32 without the register moves, by row cap: counted in
#: phase_build from the SASS of the library it built
REGISTER_OPS_PER_ROW = {}
#: instructions a row of dp_locate_wide's strips, by rows a lane, from the
#: same SASS (cuda_tools/sass_rows.py::strip_row_instructions): reported
#: beside the strips' bound, which counts cuda_kernel.STRIP_OPS_PER_CELL
STRIP_SASS_PER_ROW = {}
#: the dtype probe's column loops by kernel, from the SASS phase_build
#: counted (cuda_tools/sass_rows.py::probe_row_instructions)
PROBE_SASS_ROWS = {}
#: probe shapes whose N is no multiple of any block width, beside SHAPES
PROBE_ODD_SHAPES = ((104, 1002), (160, 16386))


def check(ok, message):
    """Fail the run (also under ``python -O``) unless ``ok``."""
    if not ok:
        raise AssertionError(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


@lru_cache(maxsize=None)
def sm_clock_mhz():
    """The card's largest SM clock."""
    return float(timing.smi("clocks.max.sm").split()[0])


def device_times(fn, launches, queued=True):
    """:func:`cuda_tools.timing.device_times` at the card's SM clock:
    ``ms`` the median of single launches (the reading of every kernel time
    of the port), ``queued_ms`` the work alone."""
    return timing.device_times(fn, launches, sm_clock_mhz(), queued)


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
            args=("nvcc " + name + ".cu", partial(_build.build, name, verbose=True)),
        )
        for name in ("dp_align", "diag_counts", "dtype_probe")
    ] + [threading.Thread(target=timed, args=("g++ fastq.cpp", runtime.lib))]
    began = time.perf_counter()
    for job in jobs:
        job.start()
    for job in jobs:
        job.join()
    if errors:
        raise RuntimeError("build failed: {}".format(errors))
    nvcc = ("nvcc dp_align.cu", "nvcc diag_counts.cu", "nvcc dtype_probe.cu")
    ptxas = [
        line.strip()
        for name in nvcc
        for line in results[name][0][1].splitlines()
        if "registers" in line or "Compiling entry" in line or "stack frame" in line
    ]
    # dp_locate_word32's register instantiations and dp_locate_wide's
    # strips keep the column in registers, and the diagonal-count kernels
    # their query words, only if ptxas gave them no stack frame and no
    # spills; the probe kernels keep their state in registers likewise
    register_frames, diag_frames, probe_frames = {}, {}, {}
    entry = None
    for line in ptxas:
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif "stack frame" in line and any(
            key in (entry or "") for key in ("reg_kernel", "warp_kernel")
        ):
            register_frames[entry] = line
        elif "stack frame" in line and "diag_counts" in (entry or ""):
            diag_frames[entry] = line
        elif "stack frame" in line and "dtype_probe" in (entry or ""):
            probe_frames[entry] = line
    # (the strips twice: the timed launch and the instrumented one)
    check(len(register_frames) == len(cuda_kernel.ROW_CAPS) + 2, register_frames)
    # (the 32-bit counts twice: one slab, and slabs for the largest windows)
    check(len(diag_frames) == 3, diag_frames)
    check(len(probe_frames) == len(dtype_probe.KERNELS), probe_frames)
    for entry, line in {**register_frames, **diag_frames, **probe_frames}.items():
        check(line.startswith("0 bytes stack frame, 0 bytes spill stores"), (entry, line))
    # the register instantiations' operations a row, from the SASS just
    # built: a row's instructions without the moves of the unrolled column
    listing = sass_rows.disassemble("dp_align")
    rows = {cap: sass_rows.row_instructions(listing, cap) for cap in cuda_kernel.ROW_CAPS}
    REGISTER_OPS_PER_ROW.update({cap: row["ops_per_row"] for cap, row in rows.items()})
    strips = sass_rows.strip_row_instructions(listing, cuda_kernel.STRIP_ROWS)
    STRIP_SASS_PER_ROW[cuda_kernel.STRIP_ROWS] = strips["instructions_per_row"]
    PROBE_SASS_ROWS.update(sass_rows.probe_row_instructions(sass_rows.disassemble("dtype_probe")))
    emit({
        "build": {
            "seconds": time.perf_counter() - began,
            "nvcc_seconds": {name: results[name][1] for name in nvcc},
            "gxx_seconds": results["g++ fastq.cpp"][1],
            "flags": " ".join(_build.NVCC_FLAGS),
            "ptxas": ptxas,
            "register_rows": {
                cap: {key: row[key] for key in (
                    "group_rows", "instructions_per_row", "moves_per_row", "ops_per_row")}
                for cap, row in rows.items()
            },
            "strip_rows": {key: strips[key] for key in (
                "strip_rows", "column_loop_instructions", "walk_instructions",
                "instructions_per_row", "shuffles")},
            "probe_rows": {name: {key: rows[key] for key in ("lanes", "rows", "dyn", "nodyn")}
                           for name, rows in PROBE_SASS_ROWS.items()},
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
    (asserted below), not the full product. Indel costs 2 and 3 come with
    error rates 0.2 and 0.3, so that k reaches the cost."""
    flag_sets = [("a", BACK, "back"), ("g", FRONT, "front"), ("b", ANYWHERE, "any"),
                 ("prefix", PREFIX, "front"), ("suffix", SUFFIX, "back")]
    configs = []
    for i in range(40):
        name, flags, place = flag_sets[i % 5]
        indel_cost = (1, 2, 100000, 3)[(i // 2) % 4]
        rates = (0.2, 0.3) if indel_cost in (2, 3) else (0.1, 0.2)
        configs.append(dict(
            idx=i, flag_name=name, flags=flags, place=place,
            iupac=bool((i // 5 + i) % 2),
            indel_cost=indel_cost,
            e=rates[(i // 3 + i // 7) % 2],
            m=(8, 33, 120)[i % 3],
            L=(32, 160, 320)[(i // 3 + i) % 3],
            B=32768,
        ))
    for factor, values in (
        ("flag_name", ["a", "g", "b", "prefix", "suffix"]), ("iupac", [False, True]),
        ("indel_cost", [1, 2, 3, 100000]), ("e", [0.1, 0.2, 0.3]), ("m", [8, 33, 120]),
        ("L", [32, 160, 320]),
    ):
        for value in values:
            count = sum(1 for c in configs if c[factor] == value)
            check(count >= 2, (factor, value, count))
    for cost in (2, 3):
        reached = sum(
            1 for c in configs if c["indel_cost"] == cost and int(c["e"] * c["m"]) >= cost
        )
        check(reached >= 2, ("indel cost reached by k", cost, reached))
    # shapes whose cell does not fit 32 bits: dp_locate_wide's own domain
    configs.append(dict(idx=40, flag_name="a", flags=BACK, place="any", iupac=False,
                        indel_cost=100000, e=0.3, m=880, L=7328, B=1024))
    configs.append(dict(idx=41, flag_name="b", flags=ANYWHERE, place="any", iupac=True,
                        indel_cost=100000, e=0.3, m=880, L=7328, B=512))
    # adapters whose column does not fit shared memory even for one warp,
    # so the kernel keeps it in global memory: 1,200 bases in the 64-bit
    # word (m 11 + origin 13 + cost 9 bits) and 2,000 in the 32-bit word
    configs.append(dict(idx=42, flag_name="a", flags=BACK, place="any", iupac=False,
                        indel_cost=100000, e=0.3, m=1200, L=3072, B=1024, big=True))
    configs.append(dict(idx=43, flag_name="b", flags=ANYWHERE, place="any", iupac=True,
                        indel_cost=100000, e=0.1, m=2000, L=2048, B=1024, big=True))
    # adapters on both sides of every row cap of dp_locate_word32's register
    # column (16, 32, 48 and 64 rows: m + 1 of them) and one past it, each m
    # twice, once in each compare mode; again a covering set
    row_caps = []
    for i in range(2 * len(ROW_CAP_MS)):
        name, flags, place = flag_sets[i % 5]
        indel_cost = (1, 2, 100000, 3)[(i // 2) % 4]
        rates = (0.2, 0.3) if indel_cost in (2, 3) else (0.1, 0.2)
        row_caps.append(dict(
            idx=44 + i, flag_name=name, flags=flags, place=place,
            iupac=bool((i // len(ROW_CAP_MS) + i) % 2),
            indel_cost=indel_cost,
            e=rates[(i // 3 + i // 7) % 2],
            m=ROW_CAP_MS[i % len(ROW_CAP_MS)],
            L=(32, 160, 320)[(i // 3 + i) % 3],
            B=32768,
        ))
    for factor, values in (
        ("flag_name", ["a", "g", "b", "prefix", "suffix"]), ("iupac", [False, True]),
        ("indel_cost", [1, 2, 3, 100000]), ("e", [0.1, 0.2, 0.3]), ("m", ROW_CAP_MS),
        ("L", [32, 160, 320]),
    ):
        for value in values:
            count = sum(1 for c in row_caps if c[factor] == value)
            check(count >= 2, ("row caps", factor, value, count))
    for m in ROW_CAP_MS:
        modes = {c["iupac"] for c in row_caps if c["m"] == m}
        check(modes == {False, True}, ("both compare modes", m, modes))
    # dp_locate_wide's strips where the insertion can win (k = 264), so
    # that the fix-up across lanes runs where only the 64-bit kernel serves
    strips = [
        dict(idx=44 + len(row_caps) + i, flag_name=name, flags=flags, place=place,
             iupac=iupac, indel_cost=cost, e=0.3, m=880, L=7328, B=512)
        for i, (cost, iupac, (name, flags, place)) in enumerate(
            (cost, iupac, flag_sets[(2 * c + iupac) % 5])
            for c, cost in enumerate((1, 2, 3))
            for iupac in (False, True)
        )
    ]
    # the batched engine's shapes: batches of 64 to 1,024 reads (padded to
    # powers of two from 64) and lengths of 64 and 160 (multiples of 32)
    first = 44 + len(row_caps) + len(strips)
    engine_shapes = [
        dict(idx=first + i, flag_name=name, flags=flags, place=place, iupac=bool(i % 2),
             indel_cost=1, e=0.1, m=33, L=L, B=B)
        for i, ((B, L), (name, flags, place)) in enumerate(zip(
            ((64, 160), (64, 64), (1024, 160), (1024, 64)),
            (flag_sets[0], flag_sets[2], flag_sets[0], flag_sets[1]),
        ))
    ]
    return configs + row_caps + strips + engine_shapes


def make_adapter(rng, m, iupac):
    if m == 33 and not iupac:
        return TRUSEQ
    adapter = BASES[rng.integers(0, 4, m)].copy()
    if iupac:
        wild = np.frombuffer(b"NRYKMSWBDHV", np.uint8)
        where = rng.random(m) < 0.15
        adapter[where] = wild[rng.integers(0, len(wild), int(where.sum()))]
    return adapter.tobytes().decode("ascii")


def instantiation_key(how):
    return "{} {}".format(how.kind, how.row_cap) if how.row_cap else how.kind


def strip_counts(aligner, reads_T, lens):
    """One instrumented launch of ``dp_locate_wide``'s warp instantiation:
    its columns, fix-up rounds and fix-up row steps, summed over the warps,
    the mean rounds a column, and the lane-row slots (32 lanes times the
    rows a lane walks: R a column, and one a fix-up row step)."""
    how = dp_locate_wide.instantiation(aligner.m, aligner.k, reads_T.shape[0])
    check(how.kind == "warps", how)
    stats = torch.zeros(3, dtype=torch.int64, device=DEVICE)
    dp_locate_wide.launch(reads_T, lens, aligner.ref_bytes, aligner.thresholds, how,
                          stats=stats, **aligner._dp_params())
    columns, rounds, fix_rows = (int(x) for x in stats.cpu())
    return dict(columns=columns, fix_up_rounds=rounds, fix_up_row_steps=fix_rows,
                mean_rounds_per_column=rounds / max(columns, 1),
                lane_row_slots=32 * (how.row_cap * columns + fix_rows))


def grid_inputs(seed, cfg):
    """One grid configuration's aligner on the card and its reads as the
    kernels take them: (aligner, reads_T, lens)."""
    rng = np.random.default_rng([seed, 1, cfg["idx"]])
    adapter = make_adapter(rng, cfg["m"], cfg["iupac"])
    aligner = CudaAligner(
        adapter, cfg["e"], cfg["flags"], wildcard_ref=cfg["iupac"],
        min_overlap=3, indel_cost=cfg["indel_cost"], device=DEVICE,
    )
    reads, lengths = random_batch(rng, cfg["B"], cfg["L"], adapter, cfg["place"])
    return (aligner,) + device_inputs(aligner, reads, lengths)


def phase_global_column(seed):
    """The grid's two adapters whose column does not fit shared memory even
    for one warp (1,200 bases in the 64-bit word, 2,000 in the 32-bit one),
    timed where the kernel keeps the column in global memory, for PERF.md;
    the grid compares them again with the plain version."""
    timed = {}
    for cfg in grid_configs():
        if cfg.get("big"):
            aligner, reads_T, lens = grid_inputs(seed, cfg)
            kernel = dp_locate_word32 if dp_locate_word32.fits(
                cfg["m"], aligner.k, cfg["L"]) else dp_locate_wide
            check(kernel.instantiation(cfg["m"], aligner.k, cfg["L"]).kind == "global", cfg)
            timed[kernel.name] = time_kernel(kernel, aligner, reads_T, lens, launches=5)
    check(sorted(timed) == ["dp_locate_wide", "dp_locate_word32"], timed)
    return timed


def phase_grid(seed):
    """Every grid configuration's kernels against the plain version on the
    card (no timing: this phase runs beside the CPU phase)."""
    began = time.perf_counter()
    compared = {"dp_locate_word32": 0, "dp_locate_wide": 0}
    max_err = {"dp_locate_word32": 0, "dp_locate_wide": 0}
    global_column = {}
    served = {}  # dp_locate_word32's instantiations: configurations each served
    served_wide = {}  # dp_locate_wide's
    rounds = {}  # the strips' fix-up rounds, by configuration
    found_total = 0
    config_seconds = []  # (seconds, configuration) of each configuration
    for cfg in grid_configs():
        config_began = time.perf_counter()
        aligner, reads_T, lens = grid_inputs(seed, cfg)
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
        if fits32:
            key = instantiation_key(
                dp_locate_word32.instantiation(cfg["m"], aligner.k, cfg["L"]))
            served[key] = served.get(key, 0) + 1
        if dp_locate_wide in kernels:
            wide_how = dp_locate_wide.instantiation(cfg["m"], aligner.k, cfg["L"])
            key = instantiation_key(wide_how)
            served_wide[key] = served_wide.get(key, 0) + 1
            if wide_how.kind == "warps":
                rounds[cfg["idx"]] = dict(
                    m=cfg["m"], indel_cost=cfg["indel_cost"], iupac=cfg["iupac"],
                    **strip_counts(aligner, reads_T, lens))
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
            if cfg.get("big"):
                # the shape the wrapper once refused: its column now lives
                # in global memory (timed by phase_global_column)
                how = kernel.instantiation(cfg["m"], aligner.k, cfg["L"])
                check(how.kind == "global", (kernel.name, "global column", cfg, how))
                global_column[kernel.name] = cfg["idx"]
        found_total += int(expected[0].sum())
        config_seconds.append((time.perf_counter() - config_began, cfg))
    check(
        compared["dp_locate_word32"] >= 32 and compared["dp_locate_wide"] >= 15,
        'compared["dp_locate_word32"] >= 32 and compared["dp_locate_wide"] >= 15',
    )
    check(sorted(global_column) == ["dp_locate_wide", "dp_locate_word32"], global_column)
    for key in ["registers {}".format(cap) for cap in cuda_kernel.ROW_CAPS] + ["shared"]:
        check(served.get(key, 0) >= 2, ("dp_locate_word32 instantiation", key, served))
    for key in ["warps {}".format(cuda_kernel.STRIP_ROWS), "global"]:
        check(served_wide.get(key, 0) >= 1, ("dp_locate_wide instantiation", key, served_wide))
    check(rounds and all(r["fix_up_rounds"] >= r["columns"] > 0 for r in rounds.values()),
          rounds)
    check(found_total > 0, 'found_total > 0')
    emit({
        "grid": {
            "configurations": len(grid_configs()),
            "compared": compared,
            "dp_locate_word32_instantiations": served,
            "dp_locate_wide_instantiations": served_wide,
            "strip_rounds": rounds,
            "reads_with_a_match": found_total,
            "tolerance": 0,
            "seconds": time.perf_counter() - began,
            # where the phase's time goes: its eight slowest configurations
            "slowest": [dict(seconds=seconds, idx=cfg["idx"], m=cfg["m"], L=cfg["L"],
                             B=cfg["B"], indel_cost=cfg["indel_cost"])
                        for seconds, cfg in sorted(config_seconds, key=lambda sc: -sc[0])[:8]],
            "global_column_configurations": global_column,
        }
    })
    return max_err


def time_kernel(kernel, aligner, reads_T, lens, launches=20):
    """Times of one launch (``device_times``: ``ms`` one launch between
    two events, the wrapper's host work before it included; ``queued_ms``
    the kernel alone), the plain version's time, the instantiation that
    served the shape, and the bound for the cells these reads need: at the
    operations a cell of that instantiation takes (a register
    instantiation's from its SASS, :data:`REGISTER_OPS_PER_ROW`; the
    strips' two-plane rule, ``STRIP_OPS_PER_CELL``; else ``dp_body``'s 24),
    and beside it at 24, the yardstick of the strips' predecessor.
    Also the work the instantiation's layout does: the warp-level row slots
    of one read a thread (the lanes a warp occupies when it runs each column
    down to its reads' deepest band), or for one warp a read the lane-row
    slots and fix-up rounds of an instrumented launch (:func:`strip_counts`)
    beside the SASS instructions a strip row takes."""
    params = aligner._dp_params()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    times, out = device_times(lambda: kernel(*args, **params), launches)
    began = time.perf_counter()
    expected, cells, row_slots = _locate_kernel(*args, count_cells=True, **params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - began) * 1e3
    if not torch.equal(out, expected):
        raise AssertionError(kernel.name + " disagrees at its path's shape")
    L, B = reads_T.shape
    props = torch.cuda.get_device_properties(0)
    clock_hz = sm_clock_mhz() * 1e6
    how = kernel.instantiation(aligner.m, aligner.k, L)
    if how.kind == "registers":
        ops_per_cell = REGISTER_OPS_PER_ROW[how.row_cap]
    elif how.kind == "warps":
        ops_per_cell = cuda_kernel.STRIP_OPS_PER_CELL
    else:
        ops_per_cell = cuda_kernel.OPS_PER_CELL
    if how.kind == "warps":
        work = dict(strip_counts(aligner, reads_T, lens),
                    strip_sass_per_row=STRIP_SASS_PER_ROW[how.row_cap])
    else:
        work = dict(warp_row_slots=int(row_slots))
    ops_rate = props.multi_processor_count * INT_OPS_PER_SM_CLOCK * clock_hz
    ops_ms = int(cells) * ops_per_cell / ops_rate * 1e3
    bytes_ms = (L * B + 4 * B + 32 * B) / HBM_BYTES_PER_SECOND * 1e3
    return dict(
        ms=times["ms"],
        queued_ms=times["queued_ms"],
        host_ms=times["host_ms"],
        plain_ms=plain_ms,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        # no single PyTorch call computes a banded DP with traceback fields
        library_ms=None,
        instantiation=how._asdict(),
        ops_per_cell=ops_per_cell,
        bound_ms_at_24_ops=max(int(cells) * cuda_kernel.OPS_PER_CELL / ops_rate * 1e3, bytes_ms),
        shape=dict(m=aligner.m, k=aligner.k, L=L, B=B),
        cell_updates=int(cells),
        **work,
        full_matrix_cells=L * B * (aligner.m + 1),
        sm_count=props.multi_processor_count,
        sm_clock_mhz=clock_hz / 1e6,
    )


# -- the diagonal-count kernels against their plain version ---------------------

ACGTN = b"ACGTN"
MANY_SYMBOLS = b"ACGTNRYKMSWBDHVacgtn"  # more than the packed TPU kernel's 14
ALL_BYTES = bytes(range(256))  # the 8-bit wrapper takes any byte, as the 32-bit one

#: (kernel, window, alphabet, lengths, pairs): the windows each kernel
#: serves on the paired paths and around their edges; the 32-bit kernel
#: also with more than 14 symbols, the alphabets that the 8-bit kernel's
#: TPU counterpart refuses. For the kernels' bit planes of 32 positions a
#: word: windows on both sides of each word edge, every byte value,
#: lengths past W ("wrap": m_b in (W, 2W], where the plain version wraps),
#: and batches that are no multiple of the 32-pair tile; windows of 1,500
#: and 3,000, which the 32-bit kernel cuts into slabs. Lengths "within"
#: are m_b in [0, W].
DIAG_GRID = (
    [(diag_counts_u8, W, ACGTN, "within", 32768) for W in (33, 64, 100, 150, 255)]
    + [(diag_counts_u8, 160, b"ACGTNacgtnRYKM", "within", 32768)]
    + [(diag_counts_i32, W, alphabet, "within", 32768)
       for W in (64, 255, 256, 300, 301)
       for alphabet in (ACGTN, MANY_SYMBOLS)]
    + [(diag_counts_u8, W, ACGTN, "within", 32768) for W in (31, 32, 63, 65, 96, 97)]
    + [(diag_counts_i32, W, ACGTN, "within", 32768) for W in (288, 289, 320, 512)]
    + [(diag_counts_u8, 160, ALL_BYTES, "within", 32767),
       (diag_counts_u8, 255, ALL_BYTES, "within", 32768),
       (diag_counts_i32, 289, ALL_BYTES, "within", 32768),
       (diag_counts_i32, 320, ALL_BYTES, "within", 32767),
       (diag_counts_u8, 150, ALL_BYTES, "wrap", 32768),
       (diag_counts_u8, 97, ACGTN, "wrap", 32767),
       (diag_counts_i32, 300, ALL_BYTES, "wrap", 32768),
       (diag_counts_i32, 64, MANY_SYMBOLS, "wrap", 32767),
       (diag_counts_i32, 1500, ALL_BYTES, "within", 4096),
       (diag_counts_i32, 3000, ACGTN, "wrap", 4095)]
)


def diag_batch(rng, W, B, alphabet, lengths="within"):
    """[W, B] uint8 ref and query planes and [B] int32 lengths, random in
    [0, W] (0 and W included) or, for ``"wrap"``, in (W, 2W] (2W, W + 1
    and a 0 included); in a quarter of the pairs the query is the ref read
    from a random diagonal on, with 5 % of its bytes replaced."""
    syms = np.frombuffer(alphabet, np.uint8)
    ref = syms[rng.integers(0, len(syms), (B, W))]
    query = syms[rng.integers(0, len(syms), (B, W))]
    if lengths == "wrap":
        m = rng.integers(W + 1, 2 * W + 1, B)
        m[:3] = (2 * W, W + 1, 0)
    else:
        m = rng.integers(0, W + 1, B)
        m[:3] = (0, W, 1)
    shift = rng.integers(0, W, B)[:, None]
    shifted = np.take_along_axis(ref, (np.arange(W)[None, :] + shift) % W, axis=1)
    shifted = np.where(rng.random((B, W)) < 0.05, query, shifted)
    query = np.where((rng.random(B) < 0.25)[:, None], shifted, query)
    return (
        torch.from_numpy(ref.T.copy()).to(DEVICE),
        torch.from_numpy(query.T.copy()).to(DEVICE),
        torch.from_numpy(m.astype(np.int32)).to(DEVICE),
    )


def phase_diag_grid(seed):
    began = time.perf_counter()
    compared = {diag_counts_u8.name: 0, diag_counts_i32.name: 0}
    max_err = dict.fromkeys(compared, 0)
    for idx, (kernel, W, alphabet, lengths, B) in enumerate(DIAG_GRID):
        rng = np.random.default_rng([seed, 5, idx])
        ref_T, query_T, m_col = diag_batch(rng, W, B, alphabet, lengths)
        got = kernel(ref_T, query_T, m_col)
        torch.cuda.synchronize()
        expected = kernel.plain(ref_T, query_T, m_col)
        err = int((got.long() - expected.long()).abs().max())
        max_err[kernel.name] = max(max_err[kernel.name], err)
        if not torch.equal(got, expected):
            raise AssertionError(
                "{} disagrees with its plain version at W = {}, B = {}, {} "
                "symbols, lengths {}".format(kernel.name, W, B, len(alphabet), lengths)
            )
        check(int(expected.long().sum()) > 0, (kernel.name, W))
        compared[kernel.name] += 1
    emit({
        "diag_grid": {
            "configurations": len(DIAG_GRID), "compared": compared,
            "B": sorted({B for *_, B in DIAG_GRID}),
            "wrap": sum(cfg[3] == "wrap" for cfg in DIAG_GRID),
            "all_byte_values": sum(cfg[2] == ALL_BYTES for cfg in DIAG_GRID),
            "tolerance": 0, "seconds": time.perf_counter() - began,
        }
    })
    return max_err


def diag_counts_by_conv1d(ref_T, query_T, m_col):
    """The diagonal counts by one PyTorch call, the yardstick of the
    diagonal-count kernels (the port never calls it): a grouped ``conv1d``,
    one group a pair, of the ref window's one-hot codes (zero vectors from
    position m_b on, and W - 1 zero columns after) with the query window's.
    Cross-correlation sums, for each offset s, the products of equal
    positions t and s + t, so channel b at s counts the t < m_b - s where
    the bytes agree. Returns the call and the number of symbols; float32 (TF32 in
    cuDNN's default) is exact here: the codes are 0 and 1, the sums at most
    W."""
    W, B = query_T.shape
    symbols = torch.unique(torch.cat([ref_T.flatten(), query_T.flatten()]))
    live = torch.arange(W, device=ref_T.device)[:, None] < m_col.reshape(1, -1).long()

    def one_hot(plane):  # [W, B] -> [B, S, W], zero past each pair's length
        codes = (plane[None, :, :] == symbols[:, None, None]) & live[None, :, :]
        return codes.permute(2, 0, 1).float().contiguous()

    ref_codes = torch.nn.functional.pad(one_hot(ref_T), (0, W - 1))
    x = ref_codes.reshape(1, B * len(symbols), 2 * W - 1)
    weight = one_hot(query_T)
    return lambda: torch.nn.functional.conv1d(x, weight, groups=B), len(symbols)


def diag_work(W, m_col):
    """The work the lengths ``m_col`` ask of a diagonal-count kernel at
    window ``W``: the position compares (sum over pairs and diagonals s of
    min(W, m - s), where positive), the 32-position words of the bit planes
    (the same sum of ceil(min(W, m - s) / 32)) and the live diagonals (the
    terms that are positive)."""
    m = np.minimum(m_col.cpu().numpy().astype(np.int64), 2 * W)
    spans = np.clip(np.minimum(W, m[None, :] - np.arange(W)[:, None]), 0, None)
    return int(spans.sum()), int(((spans + 31) // 32).sum()), int((spans > 0).sum())


def time_diag(kernel, ref_T, query_T, m_col, launches=20):
    """Time of one launch of a diagonal-count kernel (``device_times``), its plain
    version's time, the time of one PyTorch call that computes the same
    counts (:func:`diag_counts_by_conv1d`, which must agree), and the bound
    for this batch: the 32-position words of the bit planes and the live
    diagonals that the lengths need (:func:`diag_work`) at
    ``insert_kernel.WORD_OPS`` and ``insert_kernel.DIAGONAL_OPS`` integer
    operations each, against both planes and the lengths read once and the
    counts written once. Beside it the bound at one operation a position
    compare (``bound_ms_at_1_op_per_compare``), the kernels' bound before
    their bit planes."""
    times, out = device_times(lambda: kernel(ref_T, query_T, m_col), launches)
    began = time.perf_counter()
    expected = kernel.plain(ref_T, query_T, m_col)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - began) * 1e3
    if not torch.equal(out, expected):
        raise AssertionError(kernel.name + " disagrees at its path's shape")
    library_call, n_symbols = diag_counts_by_conv1d(ref_T, query_T, m_col)
    # a few launches: the call takes hundreds of milliseconds, and its host
    # waits for the card, so no queued reading
    library, library_out = device_times(library_call, 5, queued=False)
    library_counts = library_out[0].T.round().long()
    check(torch.equal(library_counts, out.long()),
          kernel.name + ": the conv1d counts differ from the kernel's")
    W, B = query_T.shape
    compares, words, diagonals = diag_work(W, m_col)
    props = torch.cuda.get_device_properties(0)
    clock_hz = sm_clock_mhz() * 1e6
    ops_rate = props.multi_processor_count * INT_OPS_PER_SM_CLOCK * clock_hz
    operations = words * insert_kernel.WORD_OPS + diagonals * insert_kernel.DIAGONAL_OPS
    ops_ms = operations / ops_rate * 1e3
    n_bytes = 2 * W * B + 4 * B + W * B * out.element_size()
    bytes_ms = n_bytes / HBM_BYTES_PER_SECOND * 1e3
    return dict(
        ms=times["ms"],
        queued_ms=times["queued_ms"],
        host_ms=times["host_ms"],
        plain_ms=plain_ms,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=library["ms"],
        library_call="conv1d, groups=B, one-hot codes of {} symbols".format(n_symbols),
        bound_ms_at_1_op_per_compare=max(compares / ops_rate * 1e3, bytes_ms),
        word_ops=insert_kernel.WORD_OPS,
        diagonal_ops=insert_kernel.DIAGONAL_OPS,
        shape=dict(W=W, B=B),
        compares=compares,
        words=words,
        diagonals=diagonals,
        bytes=n_bytes,
    )


# -- the main path -------------------------------------------------------------


def fastq_block(ids, reads, quals, suffix=b""):
    """FASTQ records of equal length as bytes: names of 8 digits from
    ``ids`` followed by ``suffix``, ``reads`` and ``quals`` [n, L] uint8."""
    count, read_len = reads.shape
    name_len = 1 + 8 + len(suffix)
    block = np.empty((count, name_len + 1 + read_len + 3 + read_len + 1), np.uint8)
    block[:, 0] = ord("@")
    for digit in range(8):
        block[:, 8 - digit] = 48 + (ids // 10 ** digit) % 10
    block[:, 9:name_len] = np.frombuffer(suffix, np.uint8)
    pos = name_len
    block[:, pos] = 10
    block[:, pos + 1 : pos + 1 + read_len] = reads
    pos += 1 + read_len
    block[:, pos : pos + 3] = np.frombuffer(b"\n+\n", np.uint8)
    block[:, pos + 3 : pos + 3 + read_len] = quals
    block[:, -1] = 10
    return block.tobytes()


def write_truseq_fastq(path, rng, n_reads, read_len=150, chunk=250000):
    """Reads of ``read_len`` bases, half of them carrying the TruSeq
    adapter at a random offset with 1 % substitutions and occasional
    indels, a few lowercase, a few with 'N'. Returns per read: whether an
    unmutated adapter copy was planted, and its offset."""
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
            out.write(fastq_block(np.arange(first, first + count), reads, quals))
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
    """One command line through the port's entry point, with every
    kernel's launch count set to 0 just before and read just after."""
    check_device_phase(device)
    cuda_kernel.reset_launch_counts()
    insert_kernel.reset_launch_counts()
    began = time.perf_counter()
    retcode = port_main(argv, device=device)
    seconds = time.perf_counter() - began
    counts = dict(cuda_kernel.launch_counts(), **insert_kernel.launch_counts())
    if retcode != 0:
        raise RuntimeError("trim exited with {}: {}".format(retcode, argv))
    return seconds, counts, dict(turbo.LAST_RUN)


def phase_main_path(work, made, n_reads, runs):
    (fastq,), (clean, start), made = made
    out = os.path.join(work, "trimmed.fastq")
    tail = ["--quiet", "--no-cache-adapters", "--report-file", os.path.join(work, "report.txt")]
    argv = ["trim", "-a", TRUSEQ, "-se", fastq, "-o", out] + tail
    seconds, counts, run = run_trim(argv, "cuda")
    # the first run's report, which ranks_se_path holds its merged report to
    # (a later run numbers the unnamed adapter on)
    shutil.copyfile(tail[-1], os.path.join(work, "main_report.txt"))
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

    # the first DEPTH + 2 batches again on the CPU (in the CPU phase): a
    # byte-identical prefix; the card's output is cut to it after
    # ranks_se_path
    records = CPU_CHECK_RECORDS["main_path"]
    prefix = write_prefix(fastq, records, os.path.join(work, "main_prefix.fastq"))
    cpu_out = os.path.join(work, "trimmed_cpu.fastq")
    defer_cpu("main_path", [dict(
        argv=["trim", "-a", TRUSEQ, "-se", prefix, "-o", cpu_out,
              "--max-reads", str(records)] + tail,
        outs=[(cpu_out, out, None)], expect={"device": "cpu", "reads": records},
    )])

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
        }
    })
    return launches, fastq, out


def time_device_step(fastq, work, launches=20):
    """Time of the lane's whole device step for one batch of the main path
    (unpack, table decode into [L, B], the DP kernel, result packing and
    int16 narrowing) beside the DP kernel alone: what the torch ops around
    the kernel cost on the card. ``step_ms`` is one step between two
    events (the host's work of its launches included, the reading of every
    kernel time of the port), ``step_queued_ms`` the step's device work
    alone (``device_times``)."""
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
    cuda_kernel.reset_launch_counts()
    times, bundle = device_times(
        lambda: lane._step(tok.width, bits, main_dev, win_dev, tables_dev), launches
    )
    # device_times: 3 warm-ups, then the single and the queued launches
    check(
        cuda_kernel.launch_counts()["dp_locate_word32"] == 3 + 2 * launches,
        cuda_kernel.launch_counts(),
    )
    return dict(
        step_ms=times["ms"],
        step_queued_ms=times["queued_ms"],
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


LONG_M, LONG_READS = 880, 1024


def write_long_fasta(path, seed):
    """The long path's input: 1,024 reads of 6,000-7,312 bases, every other
    one carrying an exact copy of an 880-base vector. Returns the vector,
    the read lengths and where each copy starts (-1: none)."""
    rng = np.random.default_rng([seed, 3])
    m, n_reads = LONG_M, LONG_READS
    vector = BASES[rng.integers(0, 4, m)].tobytes().decode("ascii")
    lengths = rng.integers(6000, 7300, n_reads)
    # the FASTA stream hands over the last record as a batch of its own:
    # both batches are as wide as the longest read
    lengths[0] = lengths[-1] = 7312
    starts = np.full(n_reads, -1, np.int64)
    with open(path, "w") as out:
        for i in range(n_reads):
            seq = BASES[rng.integers(0, 4, int(lengths[i]))]
            if i % 2:
                starts[i] = int(rng.integers(100, lengths[i] - m))
                seq[starts[i] : starts[i] + m] = np.frombuffer(vector.encode(), np.uint8)
            out.write(">long{}\n{}\n".format(i, seq.tobytes().decode("ascii")))
    return vector, lengths, starts


def long_batch(fasta, vector):
    """The long path's reads as one batch the way the lane hands them to the
    kernel, and the aligner: (aligner, reads_T, lens)."""
    with open(fasta, "rb") as handle:
        chunk = runtime.parse_fasta_chunk(handle.read(), final=True)
    width = -(-int(chunk.seq_len.max()) // 32) * 32
    aligner = CudaAligner(vector, 0.3, BACK, min_overlap=3, indel_cost=100000, device=DEVICE)
    check(
        aligner.kernel_for(width) is dp_locate_wide,
        'aligner.kernel_for(width) is dp_locate_wide',
    )
    check(
        not dp_locate_word32.fits(LONG_M, aligner.k, width),
        'not dp_locate_word32.fits(LONG_M, aligner.k, width)',
    )
    reads_T, lens = device_inputs(
        aligner, chunk.padded_sequences(width), chunk.seq_len.astype(np.int32)
    )
    return aligner, reads_T, lens


def phase_long_path(work, seed):
    """8-kilobase reads against an 880-base vector at 30 % errors without
    indels: matches 10 bits, origin 14 bits, cost 9 bits, so the cell needs
    33 bits and the lane's aligner picks ``dp_locate_wide``, which serves
    this batch one warp a read."""
    fasta = os.path.join(work, "long.fasta")
    vector, lengths, starts = write_long_fasta(fasta, seed)
    n_reads = LONG_READS
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

    # the same batch as the lane hands it to the kernel, for the timing
    aligner, reads_T, lens = long_batch(fasta, vector)
    timing = time_kernel(dp_locate_wide, aligner, reads_T, lens, launches=20)
    check(timing["instantiation"]["kind"] == "warps", timing["instantiation"])
    emit({
        "long_path": {
            "argv": "trim -a VECTOR880 -e 0.3 --no-indels -se long.fasta -o long_trimmed.fasta",
            "reads": n_reads, "read_length": "6000-7312", "adapter_length": LONG_M,
            "seconds": seconds, "batches": run["batches"], "launches": counts,
            "vectors_checked": int(has.sum()),
            "instantiation": timing["instantiation"],
            **{key: timing[key] for key in (
                "columns", "fix_up_rounds", "mean_rounds_per_column", "fix_up_row_steps",
                "lane_row_slots", "cell_updates")},
        }
    })
    return launches, timing


# -- the paired-end paths ----------------------------------------------------------

COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def write_pairs(path1, path2, rng, n_pairs, read_len, mean, sd, poly_a=(0, 0),
                chunk=100000, low_window=None):
    """Read pairs of ``read_len`` bases from both ends of inserts whose
    lengths are normal (``mean``, ``sd``) clipped to 40-500: mate 1 reads
    the insert and then the TruSeq read-1 adapter, mate 2 the insert's
    reverse complement and then the read-2 adapter, each followed by random
    bases; 1 % substitutions on both mates. Pairs ``poly_a[0]`` up to
    ``poly_a[1]`` are near-poly-A instead (mate 1 all A but one C, mate 2
    all T): dozens of admissible insert diagonals, more than the bundle's
    candidate slots. With ``low_window`` = (share, window), that share of
    the pairs has one mate (either, at random) whose first ``window``
    qualities are 2 and a partner whose first ``window`` are 35: a mate
    that ``-w`` replaces. Names end in /1 and /2. Returns the insert
    lengths, -1 for the poly-A pairs, and the number of pairs planted with
    a low window."""
    inserts = np.clip(np.rint(rng.normal(mean, sd, n_pairs)), 40, 500).astype(np.int64)
    inserts[poly_a[0] : poly_a[1]] = -1
    n_low = 0
    t = np.arange(read_len)[None, :]
    adapters = [np.frombuffer(a.encode("ascii"), np.uint8) for a in (TRUSEQ, TRUSEQ2)]
    with open(path1, "wb") as out1, open(path2, "wb") as out2:
        for first in range(0, n_pairs, chunk):
            count = min(chunk, n_pairs - first)
            ins = inserts[first : first + count, None]
            frag = BASES[rng.integers(0, 4, (count, 500))]
            mates = []
            for mate, adapter in enumerate(adapters):
                tail = BASES[rng.integers(0, 4, (count, read_len + len(adapter)))]
                tail[:, : len(adapter)] = adapter
                if mate == 0:
                    own = frag[:, :read_len]
                else:
                    own = COMPLEMENT[
                        np.take_along_axis(frag, np.clip(ins - 1 - t, 0, 499), axis=1)
                    ]
                after = np.take_along_axis(tail, np.clip(t - ins, 0, None), axis=1)
                reads = np.where(t < ins, own, after)
                subs = rng.random((count, read_len)) < 0.01
                reads = np.where(subs, BASES[rng.integers(0, 4, (count, read_len))], reads)
                mates.append(reads.astype(np.uint8))
            poly = (ins[:, 0] < 0)
            if poly.any():
                mates[0][poly] = ord("A")
                rows = np.nonzero(poly)[0]
                mates[0][rows, rng.integers(20, 80, rows.size)] = ord("C")
                mates[1][poly] = ord("T")
            ids = np.arange(first, first + count)
            quals = [(33 + rng.integers(2, 41, (count, read_len))).astype(np.uint8)
                     for _ in (0, 1)]
            if low_window is not None:
                share, window = low_window
                planted = rng.random(count) < share
                low = rng.integers(0, 2, count)
                for mate in (0, 1):
                    quals[mate][planted & (low == mate), :window] = 33 + 2
                    quals[mate][planted & (low != mate), :window] = 33 + 35
                n_low += int(planted.sum())
            for out, reads, qual, suffix in (
                (out1, mates[0], quals[0], b"/1"), (out2, mates[1], quals[1], b"/2"),
            ):
                out.write(fastq_block(ids, reads, qual, suffix))
    return inserts, n_low


def pe_argv(aligner, in1, in2, out1, out2, work, report="report_pe.txt", named=False):
    """A paired command line; ``named`` names the two adapters (their
    names then stand in the summary and the side files, where an unnamed
    adapter's number depends on how many the process has seen)."""
    ad1, ad2 = ("ad1=" + TRUSEQ, "ad2=" + TRUSEQ2) if named else (TRUSEQ, TRUSEQ2)
    return [
        "trim", "--aligner", aligner, "-a", ad1, "-A", ad2,
        "-pe1", in1, "-pe2", in2, "-o", out1, "-p", out2,
        "--quiet", "--no-cache-adapters", "--report-file", os.path.join(work, report),
    ]


def defer_pair_check(tag, argv, outs, card_run, work):
    """Leave to the CPU phase the same command line on ``cpu`` for the
    first ``CPU_PAIRS`` pairs: its outputs must be the byte-identical prefix
    of the card's. The card's run must have had more batches than the
    prefix holds whole, so that the prefix reaches batches whose pinned
    slots were reused."""
    check(card_run["batches"] > turbo.TurboPairedRunner.DEPTH + 2, card_run)
    pairs = CPU_CHECK_RECORDS[tag]
    cpu_argv = list(argv)
    for mate, flag in enumerate(("-pe1", "-pe2"), 1):
        at = cpu_argv.index(flag) + 1
        cpu_argv[at] = write_prefix(
            cpu_argv[at], pairs, os.path.join(work, "{}_prefix.{}.fastq".format(tag, mate)))
    cpu_outs = [out + ".cpu" for out in outs]
    cpu_argv = [cpu_outs[outs.index(a)] if a in outs else a for a in cpu_argv]
    for out in outs:
        keep_card_prefix(out, pairs)
    defer_cpu(tag, [dict(
        argv=cpu_argv + ["--max-reads", str(pairs)],
        outs=[(cpu_out, out, None) for cpu_out, out in zip(cpu_outs, outs)],
        expect={"device": "cpu", "pairs": pairs}, report_run=("slot_overflow_pairs",),
    )])


def split_seconds(run):
    return {
        "parse (reader threads, both files)": run["parse_seconds"],
        "main thread waiting for parsed chunks": run["chunk_wait_seconds"],
        "main thread preparing batches (both mates)": run["prepare_seconds"],
        "main thread enqueueing uploads and device steps": run["dispatch_seconds"],
        "device wait": run["device_wait_seconds"],
        "main thread resolving pairs, filters, routing": run["resolve_seconds"],
        "format (writer thread)": run["format_seconds"],
        "write (writer thread)": run["write_seconds"],
    }


def phase_pe_insert(work, made, n_pairs, read_len, mean, kernel, poly_a):
    """``trim --aligner insert`` on seeded pairs (``made``: written by
    :func:`write_pairs` with ``poly_a``): the counts kernel the window
    selects runs once a pair batch, ``dp_locate_word32`` once a batch for
    each mate's fallback adapter match."""
    (in1, in2), (inserts, _), made = made
    outs = [os.path.join(work, "trimmed_pe{}.{}.fastq".format(read_len, i)) for i in (1, 2)]
    argv = pe_argv("insert", in1, in2, *outs, work)
    seconds, counts, run = run_trim(argv, "cuda")
    other = diag_counts_i32 if kernel is diag_counts_u8 else diag_counts_u8
    check(run["device"].startswith("cuda") and run["pairs"] == n_pairs, run)
    check(run["aligner"] == "insert" and run["device_aligners"] == 2, run)
    check(counts[kernel.name] == run["batches"] > 0, (counts, run))
    check(counts[other.name] == 0, (counts, run))
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"], (counts, run))
    check(counts["dp_locate_wide"] == 0, counts)
    if poly_a[1] > poly_a[0]:
        check(run["slot_overflow_pairs"] > 0, run)
    # over every batch: read-through pairs are cut to their insert length
    len1, len2 = output_lengths(outs[0]), output_lengths(outs[1])
    check(len1.shape[0] == len2.shape[0] == n_pairs, "pairs in != pairs out")
    through = (inserts >= 0) & (inserts < read_len)
    at_insert = (len1[through] == inserts[through]) & (len2[through] == inserts[through])
    share = float(at_insert.mean())
    check(share > 0.97, ("read-through pairs cut at their insert", share))
    check(np.all(len1[inserts >= read_len] <= read_len), "a long insert grew")
    tag = "pe_insert_path" if kernel is diag_counts_u8 else "pe_insert_wide_path"
    defer_pair_check(tag, argv, outs, run, work)
    return dict(
        argv="trim --aligner insert -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p",
        pairs=n_pairs, read_length=read_len, insert_mean=mean, insert_sd=70,
        input_bytes=os.path.getsize(in1) + os.path.getsize(in2),
        make_input_seconds=made, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts,
        slot_overflow_pairs=run["slot_overflow_pairs"],
        read_through_pairs=int(through.sum()), cut_at_insert_share=share,
        split_seconds=split_seconds(run),
    ), (in1, in2)


def phase_pe_adapter(work, inputs, n_pairs):
    """The same pairs with ``--aligner adapter``: each mate's lane runs
    ``dp_locate_word32`` once a batch for its adapter."""
    outs = [os.path.join(work, "trimmed_pa.{}.fastq".format(i)) for i in (1, 2)]
    argv = pe_argv("adapter", *inputs, *outs, work)
    seconds, counts, run = run_trim(argv, "cuda")
    check(run["aligner"] == "adapter" and run["pairs"] == n_pairs, run)
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"] > 0,
          (counts, run))
    check(run["device_aligners"] == 2, run)
    check(counts["diag_counts_u8"] == counts["diag_counts_i32"] == 0, counts)
    defer_pair_check("pe_adapter_path", argv, outs, run, work)
    return dict(
        argv="trim --aligner adapter -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p",
        pairs=n_pairs, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts, split_seconds=split_seconds(run),
    )


# -- the side paths: --stats, side files, demultiplexing, -w --------------------

#: the adapters of the single-end side path: (name, sequence)
SIDE_ADAPTERS = (
    ("truseq", TRUSEQ),
    ("nextera", "CTGTCTCTTATACACATCT"),
    ("umi", "TGGAATTCTCNNNNNNCCAAGG"),
)
#: records of each side path run again on the CPU (and alone on the card):
#: two batches whole, cut as ``CPU_PAIRS``
PREFIX_RECORDS = 2 * turbo.TurboTrimRunner.MAX_BATCH


def write_side_fastq(path, rng, n_reads, read_len=150, chunk=250000):
    """Reads of ``read_len`` bases: a quarter each carry one of
    ``SIDE_ADAPTERS`` at a random offset (cut off at the read's end; the
    UMI adapter with random bases in its N run), a quarter carry none; 1 %
    substitutions over every read. Returns the adapter index of each read
    (3: none), the offset of its copy, and whether no substitution fell
    into the copy's bases inside the read."""
    kinds_all, offsets_all, clean_all = [], [], []
    with open(path, "wb") as out:
        for first in range(0, n_reads, chunk):
            count = min(chunk, n_reads - first)
            reads = BASES[rng.integers(0, 4, (count, read_len))]
            kinds = rng.integers(0, 4, count)
            offsets = rng.integers(0, read_len, count)
            for idx, (_, seq) in enumerate(SIDE_ADAPTERS):
                adapter = np.frombuffer(seq.encode("ascii"), np.uint8)
                rows = np.nonzero(kinds == idx)[0]
                copies = np.broadcast_to(adapter, (rows.size, adapter.size)).copy()
                wild = adapter == ord("N")
                copies[:, wild] = BASES[rng.integers(0, 4, (rows.size, int(wild.sum())))]
                cols = offsets[rows][:, None] + np.arange(adapter.size)[None, :]
                inside = cols < read_len
                row_idx = np.broadcast_to(rows[:, None], cols.shape)
                reads[row_idx[inside], cols[inside]] = copies[inside]
            subs = rng.random((count, read_len)) < 0.01
            reads = np.where(subs, BASES[rng.integers(0, 4, (count, read_len))], reads)
            quals = (33 + rng.integers(2, 41, (count, read_len))).astype(np.uint8)
            out.write(fastq_block(np.arange(first, first + count), reads.astype(np.uint8), quals))
            lengths = np.array([len(seq) for _, seq in SIDE_ADAPTERS])[np.minimum(kinds, 2)]
            cols = np.arange(read_len)[None, :]
            inside = (cols >= offsets[:, None]) & (cols < (offsets + lengths)[:, None])
            kinds_all.append(kinds)
            offsets_all.append(offsets)
            clean_all.append(~(subs & inside).any(axis=1))
    return np.concatenate(kinds_all), np.concatenate(offsets_all), np.concatenate(clean_all)


def write_prefix(path, records, out_path, lines=4):
    """The first ``records`` records of ``path`` (``lines`` lines each: a
    FASTQ record, a FASTA or qual record on one line, a pair of SAM lines)
    into ``out_path``, after the SAM header lines (``@``) it starts with."""
    with open(path, "rb") as src, open(out_path, "wb") as dst:
        line = src.readline()
        if path.endswith(".sam"):
            while line.startswith(b"@"):
                dst.write(line)
                line = src.readline()
        for _ in range(lines * records):
            dst.write(line)
            line = src.readline()
    return out_path


def keep_card_prefix(path, records):
    """Cut the card's output ``path`` in place to what the first
    ``records`` records of the input can have made: at most eight lines a
    record (four of a FASTQ record; no side file of these paths writes more
    than two lines a record). The CPU phase compares the CPU's output with
    the prefix of this copy; a side file the card did not write stays
    absent."""
    if not os.path.exists(path):
        return
    kept = os.path.join(os.path.dirname(path), ".keep_" + os.path.basename(path))
    with open(path, "rb") as src, open(kept, "wb") as dst:
        for _ in range(8 * records):
            line = src.readline()
            if not line:
                break
            dst.write(line)
    os.replace(kept, path)


def kmer_counts():
    """A copy of the detect command's counts of k-mer ops by device type."""
    return {device: dict(kinds) for device, kinds in kmers.DEVICE_KMER_COUNTS.items()}


def run_summary(argv, device):
    """One command line (``argv[0]`` the command: trim, qc, detect or
    error) through its command's entry point, as :func:`run_trim` does,
    also returning the run's summary, its mode, how many position counts
    of the statistics and how many k-mer ops of detect ran on each device
    type, and the changes of the batched engine's ``BUILD_COUNTS`` and
    ``MATCH_COUNTS`` and of the records the pipeline ran without an engine
    (``per_record``). ``run`` is the turbo runner's record, None for a run
    of the per-record pipeline."""
    check_device_phase(device)
    cuda_kernel.reset_launch_counts()
    insert_kernel.reset_launch_counts()
    stats_before = dict(stats.DEVICE_STATS_COUNTS)
    kmers_before = kmer_counts()
    engine_before = (dict(engine.BUILD_COUNTS), dict(engine.MATCH_COUNTS))
    per_record_before = pipeline.PER_RECORD_COUNTS["records"]
    turbo.LAST_RUN.clear()
    began = time.perf_counter()
    retcode, summary = get_command(argv[0]).execute(argv[1:], device=device)
    seconds = time.perf_counter() - began
    counts = dict(cuda_kernel.launch_counts(), **insert_kernel.launch_counts())
    if retcode != 0 or "exception" in summary:
        raise RuntimeError("{} failed ({}): {} {}".format(
            argv[0], retcode, argv, summary.get("exception")))
    return dict(
        seconds=seconds, counts=counts, mode=summary["mode"], summary=summary,
        run=dict(turbo.LAST_RUN) if summary["mode"] == "turbo" else None,
        stats_counts={key: stats.DEVICE_STATS_COUNTS[key] - stats_before[key]
                      for key in stats_before},
        kmer_counts={device: {kind: count - kmers_before[device][kind]
                              for kind, count in kinds.items()}
                     for device, kinds in kmer_counts().items()},
        build_counts={key: engine.BUILD_COUNTS[key] - engine_before[0][key]
                      for key in engine_before[0]},
        match_counts={key: engine.MATCH_COUNTS[key] - engine_before[1][key]
                      for key in engine_before[1]},
        per_record=pipeline.PER_RECORD_COUNTS["records"] - per_record_before,
    )


def _plain_json(value):
    return json.loads(json.dumps(value, default=str))


#: the header lines of a report that hold the command line and the times
REPORT_HEADER = (b"Command line", b"Start time", b"Wallclock", b"CPU time")


def _report_sections(path):
    """A trim report from its trimming section on (the header holds the
    command line and the times); another command's report less its
    header's command line and times."""
    with open(path, "rb") as handle:
        data = handle.read()
    at = data.find(b"--------\nTrimming")
    if at >= 0:
        return data[at:]
    return b"".join(line for line in data.splitlines(True)
                    if not line.startswith(REPORT_HEADER))


SUMMARY_KEYS = ("pre", "post", "trim", "detect", "errorrate")


def count_tables(value):
    """A summary's additive parts: every count table and record count,
    without each histogram's derived statistics (its "summary"), which the
    merge of several ``--threads`` workers adds, as in the reference
    (ROADMAP.md queue 3 item 14)."""
    if isinstance(value, dict):
        return {key: count_tables(item) for key, item in value.items() if key != "summary"}
    return value


def report_at(argv):
    """The index in ``argv`` of the report's path: ``--report-file``'s of
    trim, ``-o``'s of qc, detect and error."""
    return argv.index("--report-file" if argv[0] == "trim" else "-o") + 1


def prefix_checks(make_argv, inputs, card_outs, work, tag, run_equal=(), lines=(4,)):
    """The path's checks against ``--device cpu``: the first records of
    ``inputs`` (``CPU_CHECK_RECORDS[tag]``) run alone on the card now,
    and on the CPU in the CPU phase, whose every output must be a
    byte-identical prefix of the card's full run (``card_outs``) and whose
    statistics, report and summary must equal the card's prefix run's.
    ``make_argv`` (inputs, folder) -> (argv, outputs, report); the CPU's
    run must also equal the card's prefix run in the fields ``run_equal``
    of the turbo runner's record. ``lines``: the lines of a record of each
    input (:func:`write_prefix`). Returns a record of the card's prefix
    run, and that run."""
    records = CPU_CHECK_RECORDS[tag]
    prefixes = [
        write_prefix(path, records,
                     os.path.join(work, "{}_prefix.{}{}".format(
                         tag, i, os.path.splitext(path)[1])),
                     lines[min(i, len(lines) - 1)])
        for i, path in enumerate(inputs)
    ]
    folders = {device: os.path.join(work, "{}_{}".format(tag, device))
               for device in ("cpu", "cuda")}
    for folder in folders.values():
        os.makedirs(folder)
    argv, outs, report = make_argv(prefixes, folders["cuda"])
    card = run_summary(argv, "cuda")
    if "pre" in card["summary"] or "post" in card["summary"]:
        check(card["stats_counts"]["cuda"] > 0, card["stats_counts"])
    for path in card_outs:
        keep_card_prefix(path, records)
    cpu_argv, cpu_outs, cpu_report = make_argv(prefixes, folders["cpu"])
    defer_cpu(tag, [dict(
        argv=cpu_argv, report=cpu_report, outs=list(zip(cpu_outs, card_outs, outs)),
        mode=card["mode"], per_record=card["per_record"],
        summary={key: _plain_json(card["summary"].get(key)) for key in SUMMARY_KEYS},
        report_sections=_report_sections(report),
        run_equal={key: card["run"][key] for key in run_equal},
    )])
    return {
        "records": records, "card_prefix_seconds": card["seconds"],
        "stats_counts_on_the_card_prefix": card["stats_counts"],
    }, card


# -- the --device cpu checks: one phase after the card's, in child processes --

#: every path whose output the card makes, and the records (reads or pairs)
#: of its input that the CPU runs again: each path has exactly one entry in
#: the CPU phase (the counts the checks had when each ran inside its phase)
CPU_CHECK_RECORDS = {
    "main_path": SLOT_REUSE_READS,
    "pe_insert_path": SLOT_REUSE_PAIRS,
    "pe_adapter_path": CPU_PAIRS,
    "pe_side_path": PREFIX_RECORDS,
    "pe_overwrite_path": PREFIX_RECORDS,
    "pe_insert_wide_path": CPU_PAIRS,
    "se_side_path": PREFIX_RECORDS,
    "se_engine_path": ENGINE_CPU_RECORDS,
    "pe_engine_path": ENGINE_CPU_RECORDS,
    "pe_engine_insert_check": INSERT_CHECK_PAIRS,
    "pe_correct_path": CPU_PAIRS,
    "se_sam_engine_path": ENGINE_CPU_RECORDS,
    "pe_sam_engine_path": ENGINE_CPU_RECORDS,
    "se_fastaqual_engine_path": ENGINE_CPU_RECORDS,
    "se_stats_serial_check": STATS_CHECK_READS,
    "qc_path": MAIN_CPU_READS,
    "pe_qc_path": CPU_PAIRS,
    "detect_path": DETECT_READS,
    "detect_known_path": DETECT_KNOWN_READS,
    "detect_khmer_path": DETECT_KHMER_READS,
    "pe_detect_check": PE_DETECT_PAIRS,
    "error_path": ERROR_RECORDS,
    "threads_path": THREADS_READS,
}
#: the CPU checks the card phases left for the CPU phase
CPU_PENDING = []
#: set while a CPU check runs (in the CPU phase's children, and in the main
#: process once it joins them): a card phase that ran a CPU check would
#: share the host with its timing
_IN_CPU_CHILD = False
#: the card phases that time nothing, and so run beside the CPU phase
UNTIMED_PHASES = ("phase_grid", "phase_diag_grid", "phase_goldens")


def check_device_phase(device):
    """A ``--device cpu`` run belongs to the CPU phase (its children, and
    the main process once it joins them), never to a card phase."""
    check((torch.device(device).type == "cpu") == _IN_CPU_CHILD,
          "a {} run in {}".format(device, "the CPU phase" if _IN_CPU_CHILD else "a card phase"))


def defer_cpu(tag, runs):
    """Leave ``tag``'s ``--device cpu`` check to the CPU phase. ``runs``,
    one dict a command line: ``argv`` (its outputs the CPU's), ``outs``
    [(CPU output, the card's output or its kept prefix, the card's prefix
    run's output or None)], and what the CPU's run must give: ``mode``
    ("turbo" unless given), ``expect`` (fields of the turbo runner's
    record), ``summary`` and ``report_sections`` (the card's prefix run's;
    with ``counts_only``, ``summary`` alone, as :func:`count_tables`),
    ``run_equal`` (fields of the card's prefix run's record), ``whole``
    (the card's outputs are whole, not prefixes), ``per_record`` (the
    records the pipeline runs without an engine: 0 unless given, and
    given only for a path that is scalar by the reference's design). Each run's report goes to
    a file of its own (``report``), as the children run side by side."""
    check(tag in CPU_CHECK_RECORDS, tag)
    check(all(job["tag"] != tag for job in CPU_PENDING), ("a second CPU check", tag))
    for i, spec in enumerate(runs):
        at = report_at(spec["argv"])
        if "report" not in spec:
            spec["report"] = os.path.join(
                os.path.dirname(spec["argv"][at]), "cpu_{}_{}.report.txt".format(tag, i))
        spec["argv"][at] = spec["report"]
    CPU_PENDING.append(dict(tag=tag, records=CPU_CHECK_RECORDS[tag], runs=runs))


def cpu_child(tag, argvs, threads, per_record):
    """One path's CPU check, in a spawned child of the CPU phase with
    ``threads`` of the host's threads: each command line on ``cpu``, which
    launches no kernel (the launch counts are per process, so the child
    checks its own; a child may take several checks one after another),
    matches no read per read on the engine's host path, and runs exactly
    ``per_record`` records (one count a command line) through the pipeline
    without an engine. Returns what the parent compares."""
    global _IN_CPU_CHILD
    _IN_CPU_CHILD = True
    torch.set_num_threads(threads)
    began = time.perf_counter()
    runs = []
    for argv, expected in zip(argvs, per_record):
        res = run_summary(argv, "cpu")
        check(sum(res["counts"].values()) == 0, (tag, res["counts"]))
        check(res["stats_counts"]["cuda"] == 0, (tag, res["stats_counts"]))
        check(not any(res["kmer_counts"]["cuda"].values()), (tag, res["kmer_counts"]))
        check(res["match_counts"]["scalar_reads"] == 0, (tag, res["match_counts"]))
        check(res["per_record"] == expected, (tag, res["per_record"], expected))
        summary = res.pop("summary")
        res["summary"] = {key: _plain_json(summary.get(key)) for key in SUMMARY_KEYS}
        res["report_sections"] = _report_sections(argv[report_at(argv)])
        runs.append(res)
    return dict(tag=tag, seconds=time.perf_counter() - began, threads=threads, runs=runs)


def compare_cpu_run(tag, spec, res):
    """The comparisons of one CPU run with the card's, as each path made
    them when its check ran inside its phase."""
    check(res["mode"] == spec.get("mode", "turbo"), (tag, res["mode"]))
    for key, value in spec.get("expect", {}).items():
        check(res["run"][key] == value, (tag, key, res["run"][key], value))
    for key, value in spec.get("run_equal", {}).items():
        check(res["run"][key] == value > 0, (tag, key, res["run"][key], value))
    if spec.get("counts_only"):
        check(count_tables(res["summary"]) == spec["summary"],
              tag + ": the card's and the CPU's count tables differ")
    elif "summary" in spec:
        check(res["summary"] == spec["summary"],
              tag + ": the card's and the CPU's summaries differ on the prefix")
        check(res["report_sections"] == spec["report_sections"],
              tag + ": the card's and the CPU's reports differ on the prefix")
    sizes = {}
    for cpu_out, card_out, card_prefix_out in spec["outs"]:
        if not os.path.exists(cpu_out):
            # a side file with no rows in the prefix is not written
            check(card_prefix_out is not None and not os.path.exists(card_prefix_out),
                  (tag, cpu_out))
            continue
        with open(cpu_out, "rb") as handle:
            cpu_bytes = handle.read()
        with open(card_out, "rb") as handle:
            card_bytes = handle.read(len(cpu_bytes) + 1)
        if spec.get("whole"):
            check(cpu_bytes == card_bytes, "CPU and GPU outputs differ: " + card_out)
        else:
            check(len(cpu_bytes) > 0 and cpu_bytes == card_bytes[: len(cpu_bytes)],
                  "CPU and GPU outputs differ: " + card_out)
        sizes[os.path.basename(card_out)] = len(cpu_bytes)
        os.remove(cpu_out)
    return dict(
        seconds=res["seconds"], identical_prefix_bytes=sizes,
        **{key: res["run"][key] for key in spec.get("report_run", ())},
    )


#: host threads of the CPU phase's largest check (the others take one
#: each); the phase runs one child fewer for each thread above one, so that
#: no core runs two threads
LARGEST_CHECK_THREADS = 2


def cpu_phase_plan(n_jobs, host_cores):
    """(children, threads of each job, longest first) of the CPU phase on a
    host of ``host_cores``: one core stays with the untimed card checks,
    the longest check takes ``LARGEST_CHECK_THREADS`` of the rest and
    every other check an equal share of what is left to the other
    children."""
    cores = max(1, host_cores - 1)
    extra = min(LARGEST_CHECK_THREADS, cores) - 1 if n_jobs > 1 else 0
    children = max(1, min(n_jobs, cores - extra))
    threads = max(1, (cores - extra) // children)
    return children, [threads + extra] + [threads] * (n_jobs - 1)


#: the seconds each CPU check took on one thread on the host of an NVIDIA
#: H100 80GB HBM3 at 700 W (PERF.md section 6): the CPU phase hands the
#: checks out longest first, so that no long check starts late
CPU_CHECK_SECONDS = {
    "pe_insert_wide_path": 226, "pe_insert_path": 211, "main_path": 168,
    "se_side_path": 134, "pe_overwrite_path": 134, "pe_adapter_path": 132,
    "se_engine_path": 99, "pe_side_path": 93, "pe_correct_path": 88,
    "pe_engine_path": 50, "se_sam_engine_path": 50, "pe_sam_engine_path": 49,
    "se_fastaqual_engine_path": 25, "pe_engine_insert_check": 13,
    "detect_path": 8, "pe_detect_check": 7, "detect_known_path": 7,
    "se_stats_serial_check": 4, "detect_khmer_path": 3, "pe_qc_path": 1, "qc_path": 1,
    "error_path": 1, "threads_path": 12,
}


def run_cpu_jobs(jobs, counter, results):
    """Take the CPU phase's checks one after another from the shared
    ``counter`` (the index of the next check in ``jobs``, each a tuple of
    :func:`cpu_child`'s arguments) until none is left, putting (index,
    result or the error's text) on ``results``: the loop of each child of
    the CPU phase, and of the main process once its untimed card checks
    are done."""
    while True:
        with counter.get_lock():
            index = counter.value
            counter.value += 1
        if index >= len(jobs):
            return
        try:
            results.put((index, cpu_child(*jobs[index])))
        except Exception:  # the parent raises it
            import traceback

            results.put((index, {"error": traceback.format_exc()}))


def start_cpu_phase():
    """Start every ``--device cpu`` check the card phases left, after the
    last timed card phase so that none shares the host with a timing: in
    spawned child processes, one a host core but the one that runs the
    untimed card checks (the grids, the goldens) meanwhile, less one for
    each extra thread of the largest check (:func:`cpu_phase_plan`). The
    checks are handed out longest first (``CPU_CHECK_SECONDS``): a child
    takes the next check when it is done with one, and sets its threads
    to that check's; the main process joins them once its untimed checks
    are done (:func:`finish_cpu_phase`), which then makes the comparisons
    each path made when its check ran inside its phase, on the same
    records."""
    jobs = sorted(CPU_PENDING, key=lambda job: CPU_CHECK_SECONDS.get(job["tag"], 0),
                  reverse=True)
    check(sorted(job["tag"] for job in jobs) == sorted(CPU_CHECK_RECORDS),
          ("CPU checks left by the card phases", [job["tag"] for job in jobs]))
    children, threads = cpu_phase_plan(len(jobs), os.cpu_count() or 1)
    args = [
        (job["tag"], [spec["argv"] for spec in job["runs"]], job_threads,
         [spec.get("per_record", 0) for spec in job["runs"]])
        for job, job_threads in zip(jobs, threads)
    ]
    context = multiprocessing.get_context("spawn")
    counter, results = context.Value("i", 0), context.Queue()
    began = time.perf_counter()
    processes = [context.Process(target=run_cpu_jobs, args=(args, counter, results))
                 for _ in range(children)]
    for process in processes:
        process.start()
    return dict(jobs=jobs, args=args, counter=counter, results=results,
                processes=processes, began=began, children=children,
                threads=dict(zip((job["tag"] for job in jobs), threads)))


def stop_cpu_phase(cpu):
    """Stop the CPU phase's children, whether or not they finished."""
    for process in cpu["processes"]:
        process.terminate()
    for process in cpu["processes"]:
        process.join()


def _cpu_results(cpu):
    """The results of every check of the CPU phase, in the order of its
    jobs: the main process runs what the children have not taken yet, then
    waits for the children's."""
    import queue

    global _IN_CPU_CHILD
    was_child, main_threads = _IN_CPU_CHILD, torch.get_num_threads()
    mine = queue.Queue()
    try:
        run_cpu_jobs(cpu["args"], cpu["counter"], mine)
    finally:
        _IN_CPU_CHILD = was_child
        torch.set_num_threads(main_threads)
    got = {}
    while not mine.empty():
        index, result = mine.get()
        got[index] = dict(result, process="main")
    while len(got) < len(cpu["jobs"]):
        try:
            index, result = cpu["results"].get(timeout=5)
        except queue.Empty:
            check(any(process.is_alive() for process in cpu["processes"]),
                  "a child of the CPU phase ended without its results")
            continue
        got[index] = dict(result, process="child")
    for process in cpu["processes"]:
        process.join()
    errors = [result["error"] for result in got.values() if "error" in result]
    check(not errors, "\n".join(errors))
    return [got[index] for index in range(len(cpu["jobs"]))]


def finish_cpu_phase(cpu):
    """Join the CPU phase's children (see :func:`_cpu_results`), compare,
    and print the phase's line: its wall time, each check's threads and
    seconds and the checks the main process ran. Returns the wall time."""
    try:
        results = _cpu_results(cpu)
    finally:
        stop_cpu_phase(cpu)
    wall = time.perf_counter() - cpu["began"]
    checks = {}
    for job, result in zip(cpu["jobs"], results):
        check(result["tag"] == job["tag"], (result["tag"], job["tag"]))
        runs = [compare_cpu_run(job["tag"], spec, res)
                for spec, res in zip(job["runs"], result["runs"])]
        checks[job["tag"]] = dict(records=job["records"], runs=runs)
    CPU_PENDING.clear()
    check(all(result["threads"] == cpu["threads"][result["tag"]] for result in results),
          "a CPU check ran with other threads than planned")
    emit({"cpu_phase": {
        "seconds": wall, "children": cpu["children"],
        "order": [job["tag"] for job in cpu["jobs"]],
        "threads": cpu["threads"],
        "child_seconds": {result["tag"]: result["seconds"] for result in results},
        "run_by_the_main_process": [result["tag"] for result in results
                                    if result["process"] == "main"],
        "checks": checks,
    }})
    return wall


# -- the side paths' phases ------------------------------------------------------


def count_records(path):
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as handle:
        return sum(chunk.count(b"\n") for chunk in iter(lambda: handle.read(1 << 24), b"")) // 4


def phase_se_side(work, made, n_reads):
    """Demultiplexing by three named adapters with info, rest and wildcard
    files and pre- and post-trim statistics."""
    (fastq,), (kinds, _, _), made = made

    def make_argv(inputs, folder):
        out = os.path.join(folder, "out.{name}.fastq")
        side = [os.path.join(folder, name) for name in ("info.txt", "rest.txt", "wc.txt")]
        report = os.path.join(folder, "report.txt")
        argv = ["trim"]
        for name, seq in SIDE_ADAPTERS:
            argv += ["-a", "{}={}".format(name, seq)]
        argv += ["-se", inputs[0], "-o", out, "--info-file", side[0], "-r", side[1],
                 "--wildcard-file", side[2], "--stats", "both",
                 "--quiet", "--no-cache-adapters", "--report-file", report]
        names = [name for name, _ in SIDE_ADAPTERS] + ["unknown"]
        return argv, [out.format(name=name) for name in names] + side, report

    folder = os.path.join(work, "se_side_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv([fastq], folder)
    res = run_summary(argv, "cuda")
    seconds, counts, run, summary, stats_counts = (
        res["seconds"], res["counts"], res["run"], res["summary"], res["stats_counts"])
    check(run["device"].startswith("cuda") and run["reads"] == n_reads, run)
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"] > 0, (counts, run))
    check(run["device_aligners"] == len(SIDE_ADAPTERS), run)
    check(stats_counts["cuda"] > 0 and stats_counts["cpu"] == 0, stats_counts)
    per_name = {
        os.path.basename(path): count_records(path) for path in outs[: len(SIDE_ADAPTERS) + 1]
    }
    written = summary["trim"]["formatters"]["records_written"]
    check(sum(per_name.values()) == n_reads == written, (per_name, written))
    for idx, (name, _) in enumerate(SIDE_ADAPTERS):
        check(per_name["out.{}.fastq".format(name)] > int((kinds == idx).sum()) // 2, per_name)
    check(os.path.getsize(outs[-3]) > 0, "empty info file")
    prefix, _ = prefix_checks(make_argv, [fastq], outs, work, "se_side_path")
    os.remove(fastq)
    return dict(
        argv="trim -a truseq=... -a nextera=... -a umi=... -se IN -o out.{name}.fastq "
             "--info-file -r --wildcard-file --stats both",
        reads=n_reads, read_length=150, make_input_seconds=made, seconds=seconds,
        reads_per_second=n_reads / seconds, batches=run["batches"], launches=counts,
        records_per_name=per_name, stats_counts=stats_counts,
        split_seconds=split_seconds(run), prefix_check=prefix,
    )


def phase_pe_side(work, inputs, n_pairs):
    """The 2x150 pairs with the insert aligner, ``--stats both``, an info
    and a rest file."""

    def make_argv(paths, folder):
        outs = [os.path.join(folder, "trimmed.{}.fastq".format(i)) for i in (1, 2)]
        side = [os.path.join(folder, name) for name in ("info.txt", "rest.txt")]
        report = os.path.join(folder, "report.txt")
        argv = pe_argv("insert", *paths, *outs, folder, report, named=True)
        argv += ["--stats", "both", "--info-file", side[0], "-r", side[1]]
        return argv, outs + side, report

    folder = os.path.join(work, "pe_side_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv(inputs, folder)
    res = run_summary(argv, "cuda")
    seconds, counts, run, summary, stats_counts = (
        res["seconds"], res["counts"], res["run"], res["summary"], res["stats_counts"])
    check(run["device"].startswith("cuda") and run["pairs"] == n_pairs, run)
    check(run["aligner"] == "insert", run)
    check(counts["diag_counts_u8"] == run["batches"] > 0, (counts, run))
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"], (counts, run))
    check(stats_counts["cuda"] > 0 and stats_counts["cpu"] == 0, stats_counts)
    pre = next(iter(summary["pre"].values()))
    check(pre["read1"]["counts"] == pre["read2"]["counts"] == n_pairs, "pre-trim statistics")
    prefix, _ = prefix_checks(make_argv, inputs, outs, work, "pe_side_path")
    return dict(
        argv="trim --aligner insert -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p --stats both "
             "--info-file -r",
        pairs=n_pairs, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts, stats_counts=stats_counts,
        split_seconds=split_seconds(run), prefix_check=prefix,
    )


def phase_pe_overwrite(work, made, n_pairs):
    """``-w 10,30,10`` with the adapter aligner on pairs of which a tenth
    have one mate with a low-quality 5' window."""
    inputs, (_, planted), made = made

    def make_argv(paths, folder):
        outs = [os.path.join(folder, "trimmed.{}.fastq".format(i)) for i in (1, 2)]
        report = os.path.join(folder, "report.txt")
        argv = pe_argv("adapter", *paths, *outs, folder, report, named=True)
        return argv + ["-w", "10,30,10"], outs, report

    folder = os.path.join(work, "pe_overwrite_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv(inputs, folder)
    res = run_summary(argv, "cuda")
    seconds, counts, run = res["seconds"], res["counts"], res["run"]
    check(run["device"].startswith("cuda") and run["pairs"] == n_pairs, run)
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"] > 0, (counts, run))
    # every planted pair is replaced: both trimmed mates keep at least the
    # 40 bases of the shortest insert, more than the window
    check(run["overwritten_pairs"] >= planted > 0, (run["overwritten_pairs"], planted))
    # the CPU's run of the prefix must overwrite the same pairs
    prefix, card = prefix_checks(make_argv, inputs, outs, work, "pe_overwrite_path",
                                 run_equal=("overwritten_pairs",))
    card_prefix = card["run"]["overwritten_pairs"]
    check(card_prefix > 0, card_prefix)
    for path in inputs:
        os.remove(path)
    return dict(
        argv="trim --aligner adapter -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p -w 10,30,10",
        pairs=n_pairs, make_input_seconds=made, seconds=seconds,
        pairs_per_second=n_pairs / seconds, batches=run["batches"], launches=counts,
        planted_low_windows=planted, overwritten_pairs=run["overwritten_pairs"],
        overwritten_pairs_in_prefix=card_prefix, split_seconds=split_seconds(run),
        prefix_check=prefix,
    )


# -- the engine paths: configurations the turbo runner declines ---------------


class _HostCalls:
    """Seconds and calls of the functions ``targets`` ((owner, attribute
    name) each) in a run, by wrapping them while the run lasts: the split
    of an engine path's wall, which runs on one thread."""

    def __init__(self, targets):
        self.targets = targets  # (owner, attribute name)
        self.seconds = {name: 0.0 for _, name in targets}
        self.calls = {name: 0 for _, name in targets}

    def __enter__(self):
        self._saved = []
        for owner, name in self.targets:
            real = getattr(owner, name)
            self._saved.append((owner, name, real))
            setattr(owner, name, self._timed(name, real))
        return self

    def _timed(self, name, real):
        def timed(*args, **kwargs):
            began = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - began
                self.calls[name] += 1
        return timed

    def __exit__(self, *exc):
        for owner, name, real in self._saved:
            setattr(owner, name, real)


def engine_split(calls, wall):
    """The seconds and calls of each wrapped function, and its share of
    the run's ``wall``."""
    return {
        name: {"calls": calls.calls[name], "seconds": calls.seconds[name],
               "share_of_wall": calls.seconds[name] / wall}
        for name in calls.seconds
    }


#: what the engine paths' split times: the DP of one adapter over one
#: padded batch (encode, upload, kernel, fetch), and the batched matcher's
#: rounds (the DP calls and the host's Match objects)
ENGINE_SPLIT = ((engine, "_locate_padded"), (engine.BatchMatcher, "match_rounds"))


def engine_batch(fastq, n_reads=1000, width=160):
    """The first ``n_reads`` reads of ``fastq`` as the engine hands a
    batch to the DP: upper-cased, ``width`` columns, padded with empty
    reads to ``engine._bucket_batch(n_reads)`` rows."""
    with open(fastq, "rb") as handle:
        chunk = runtime.parse_chunk(b"".join(handle.readline() for _ in range(4 * n_reads)))
    check(chunk.n == n_reads, (chunk.n, n_reads))
    rows = engine._bucket_batch(n_reads)
    reads = np.zeros((rows, width), np.uint8)
    lengths = np.zeros(rows, np.int32)
    reads[:n_reads] = chunk.padded_sequences(width)
    lengths[:n_reads] = chunk.seq_len
    reads = np.where((reads >= 97) & (reads <= 122), reads - 32, reads).astype(np.uint8)
    return reads, lengths


def engine_record(res, n_records, unit, batched=True):
    """What an engine path prints of one run: wall time and rate, the kernel
    launches, the changes of the engine's counters and the mode; checks
    that the batched engine served the run (``mode`` "serial", one engine
    built, no read matched per read on the host, and adapters matched
    through its batched matcher unless ``batched`` is False: the insert
    aligner has none)."""
    check(res["mode"] == "serial", res["mode"])
    check(res["build_counts"] == {"engine": 1, "fallback": 0}, res["build_counts"])
    check(res["match_counts"]["scalar_reads"] == 0, res["match_counts"])
    check((res["match_counts"]["batched"] > 0) == batched, res["match_counts"])
    return {
        "seconds": res["seconds"], unit: n_records,
        unit + "_per_second": n_records / res["seconds"], "launches": res["counts"],
        "mode": res["mode"], "build_counts": res["build_counts"],
        "match_counts": res["match_counts"],
    }


def output_sequences(path, read_len):
    """The sequences of a FASTQ output whose records all have ``read_len``
    bases, [n, read_len] uint8."""
    with open(path, "rb") as handle:
        chunk = runtime.parse_chunk(handle.read())
    check(bool(np.all(chunk.seq_len == read_len)), "a masked read changed its length")
    return chunk.padded_sequences(read_len)


def phase_se_engine(work, made, n_reads):
    """A multiplexed library trimmed in two rounds, masked so that lengths
    stay fixed for the tools downstream, each name tagged with the adapter
    found: ``-n 2 --mask-adapter -y _{name}``, which the turbo runner
    declines. The per-record pipeline runs it, its batched engine matching
    every adapter of every round on the card (``dp_locate_word32``)."""
    (fastq,), (kinds, offsets, clean), made = made

    def make_argv(inputs, folder):
        out = os.path.join(folder, "masked.fastq")
        report = os.path.join(folder, "report.txt")
        argv = ["trim"]
        for name, seq in SIDE_ADAPTERS:
            argv += ["-a", "{}={}".format(name, seq)]
        argv += ["-n", "2", "--mask-adapter", "-y", "_{name}", "-se", inputs[0], "-o", out,
                 "--quiet", "--no-cache-adapters", "--report-file", report]
        return argv, [out], report

    folder = os.path.join(work, "se_engine_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv([fastq], folder)
    with _HostCalls(ENGINE_SPLIT) as calls:
        res = run_summary(argv, "cuda")
    record = engine_record(res, n_reads, "reads")
    record["split"] = engine_split(calls, res["seconds"])
    counts = res["counts"]
    check(counts["dp_locate_word32"] > 0 and counts["dp_locate_wide"] == 0, counts)
    check(counts["diag_counts_u8"] == counts["diag_counts_i32"] == 0, counts)
    # the kernel at the engine's shape: one batch of 1,000 reads padded to
    # 1,024, TruSeq, 160 columns
    reads, lengths = engine_batch(fastq)
    truseq = CudaAligner(TRUSEQ, 0.1, BACK, min_overlap=3, device=DEVICE)
    record["kernel_at_engine_shape"] = time_kernel(
        dp_locate_word32, truseq, *device_inputs(truseq, reads, lengths))
    seqs = output_sequences(outs[0], 150)
    check(seqs.shape[0] == n_reads, "reads in != reads out")
    # a clean TruSeq copy with at least 20 of its bases inside the read is
    # masked from its planted offset on
    sure = (kinds == 0) & clean & (offsets <= 150 - 20)
    check(int(sure.sum()) > n_reads // 8, int(sure.sum()))
    from_offset = np.arange(150)[None, :] >= offsets[sure][:, None]
    unmasked = int(((seqs[sure] != ord("N")) & from_offset).any(axis=1).sum())
    check(unmasked == 0, "{} reads with a clean TruSeq copy not masked from its offset".format(
        unmasked))
    prefix, _ = prefix_checks(make_argv, [fastq], outs, work, "se_engine_path")
    return dict(
        argv="trim -a truseq=... -a nextera=... -a umi=... -n 2 --mask-adapter -y _{name} "
             "-se IN -o OUT",
        read_length=150, make_input_seconds=made, masked_copies_checked=int(sure.sum()),
        reads_masked=int((seqs == ord("N")).any(axis=1).sum()), prefix_check=prefix,
        **record,
    ), (fastq, kinds, offsets, clean)


def phase_pe_engine(work, made, n_pairs):
    """Methylation libraries made with the Swift Accel-NGS kit: ``--aligner
    adapter --bisulfite swift`` (a pair modifier the turbo runner declines),
    through the per-record pipeline with each mate's adapter matched on the
    card by its batched engine."""
    inputs, (inserts, _), made = made

    def make_argv(paths, folder):
        outs = [os.path.join(folder, "swift.{}.fastq".format(i)) for i in (1, 2)]
        report = os.path.join(folder, "report.txt")
        argv = pe_argv("adapter", *paths, *outs, folder, report, named=True)
        return argv + ["--bisulfite", "swift"], outs, report

    folder = os.path.join(work, "pe_engine_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv(inputs, folder)
    with _HostCalls(ENGINE_SPLIT) as calls:
        res = run_summary(argv, "cuda")
    record = engine_record(res, n_pairs, "pairs")
    record["split"] = engine_split(calls, res["seconds"])
    counts = res["counts"]
    check(counts["dp_locate_word32"] > 0 and counts["dp_locate_wide"] == 0, counts)
    check(counts["diag_counts_u8"] == counts["diag_counts_i32"] == 0, counts)
    len1, len2 = output_lengths(outs[0]), output_lengths(outs[1])
    check(len1.shape[0] == len2.shape[0] == n_pairs, "pairs in != pairs out")
    # read-through pairs are cut to their insert, and Swift's cuts take 10
    # more bases: from mate 1's 3' end and from mate 2's 5' end
    through = (inserts >= 20) & (inserts <= 140)
    share = float(((len1[through] == inserts[through] - 10)
                   & (len2[through] == inserts[through] - 10)).mean())
    check(share > 0.97, ("read-through pairs cut at their insert", share))
    check(bool(np.all(len1 <= 140) and np.all(len2 <= 140)), "Swift's cuts missing")
    prefix, _ = prefix_checks(make_argv, inputs, outs, work, "pe_engine_path")
    return dict(
        argv="trim --aligner adapter -a ad1=TRUSEQ -A ad2=TRUSEQ2 --bisulfite swift "
             "-pe1 -pe2 -o -p",
        read_length=150, insert_mean=220, insert_sd=70, make_input_seconds=made,
        read_through_pairs=int(through.sum()), cut_at_insert_share=share,
        prefix_check=prefix, **record,
    ), (inputs, inserts)


def phase_pe_engine_insert_check(work, seed):
    """The paired ``mask_adapter`` golden's configuration at size, with the
    insert aligner (``-n 3 --mask-adapter``: the diagonal counts of every
    pair batch on the card, ``diag_counts_u8``; pairs without an insert
    match fall back to each mate's scalar ``match_to``, as in the
    reference), and ``--merge-overlapping --merged-output`` with the
    adapter aligner (each pair aligned by the scalar ``Aligner``, as in the
    reference). Both per-pair host steps are timed; every pair runs again
    on the CPU, every output and the merged file compared whole."""
    from atropos_tpu_torch.adapters.model import Adapter
    from atropos_tpu_torch.align import Aligner
    from atropos_tpu_torch.align.batched import BatchInsertMatcher

    rng = np.random.default_rng([seed, 17])
    inputs = [os.path.join(work, "check_pairs.{}.fastq".format(i)) for i in (1, 2)]
    inserts, _ = write_pairs(*inputs, rng, INSERT_CHECK_PAIRS, 150, 220, 70,
                             poly_a=(0, INSERT_CHECK_POLY_A))
    folder = os.path.join(work, "pe_engine_check")
    os.makedirs(folder)
    specs, records = [], {}
    for label, aligner, extra, host in (
        ("insert", "insert", ["-n", "3", "--mask-adapter"],
         ((Adapter, "match_to"), (BatchInsertMatcher, "candidates"))),
        ("merge", "adapter", ["--merge-overlapping"], ((Aligner, "locate"),) + ENGINE_SPLIT),
    ):
        outs = [os.path.join(folder, "{}.{}.fastq".format(label, i)) for i in (1, 2)]
        report = os.path.join(folder, "{}.report.txt".format(label))
        argv = pe_argv(aligner, *inputs, *outs, folder, report, named=True) + extra
        if label == "merge":
            outs.append(os.path.join(folder, "merged.fastq"))
            argv += ["--merged-output", outs[-1]]
        with _HostCalls(host) as calls:
            res = run_summary(argv, "cuda")
        record = engine_record(res, INSERT_CHECK_PAIRS, "pairs", batched=label == "merge")
        counts = res["counts"]
        if label == "insert":
            # no adapter matched through the batched matcher: the DP kernel
            # does not run; the insert counts do
            check(counts["diag_counts_u8"] > 0 and counts["dp_locate_word32"] == 0, counts)
            seqs = [output_sequences(out, 150) for out in outs]
            through = (inserts >= 20) & (inserts < 150 - 10)
            masked = np.ones(int(through.sum()), bool)
            for mate in seqs:
                tail = np.arange(150)[None, :] >= inserts[through][:, None]
                masked &= ((mate[through] == ord("N")) | ~tail).all(axis=1)
            record["read_through_pairs"] = int(through.sum())
            record["masked_from_insert_share"] = float(masked.mean())
            check(record["masked_from_insert_share"] > 0.9, record["masked_from_insert_share"])
        else:
            check(counts["dp_locate_word32"] > 0 and counts["diag_counts_u8"] == 0, counts)
            record["merged_pairs"] = count_records(outs[-1])
            check(record["merged_pairs"] > INSERT_CHECK_PAIRS // 8, record["merged_pairs"])
        # the per-pair scalar step first: match_to, or the merge's locate
        record["split"] = engine_split(calls, res["seconds"])
        records[label] = record
        cpu_outs = [out + ".cpu" for out in outs]
        cpu_argv = [cpu_outs[outs.index(a)] if a in outs else a for a in argv]
        specs.append(dict(
            argv=cpu_argv, outs=[(c, o, None) for c, o in zip(cpu_outs, outs)],
            mode="serial", whole=True,
            summary={key: _plain_json(res["summary"].get(key)) for key in SUMMARY_KEYS},
            report_sections=_report_sections(report),
        ))
    defer_cpu("pe_engine_insert_check", specs)
    return dict(
        argv=["trim --aligner insert -a ad1=TRUSEQ -A ad2=TRUSEQ2 -n 3 --mask-adapter",
              "trim --aligner adapter -a ad1=TRUSEQ -A ad2=TRUSEQ2 --merge-overlapping "
              "--merged-output MERGED"],
        pairs=INSERT_CHECK_PAIRS, near_poly_a_pairs=INSERT_CHECK_POLY_A, runs=records,
    )


# -- the inputs the turbo runner reads no chunk of: SAM, FASTA + qual, --stats --


def fastq_to_sam(fastqs, sam, records):
    """The first ``records`` records of ``fastqs`` as unaligned SAM records,
    as ``samtools view`` prints an unaligned BAM: one FASTQ, flag 4; two
    (the mates of pairs), one queryname-sorted file with flags 77 and 141
    and the names without their /1 and /2."""
    handles = [open(path, "rb") for path in fastqs]
    flags = (b"4",) if len(fastqs) == 1 else (b"77", b"141")
    cut = 0 if len(fastqs) == 1 else 2
    try:
        with open(sam, "wb") as out:
            out.write(b"@HD\tVN:1.6\tSO:queryname\n@PG\tID:chip_smoke\n")
            left = records
            while left:
                lines = []
                for _ in range(min(50000, left)):
                    mates = [[h.readline() for _ in range(4)] for h in handles]
                    check(bool(mates[0][0]), ("fewer records than", records, fastqs))
                    left -= 1
                    for flag, (name, seq, _, qual) in zip(flags, mates):
                        lines.append(b"\t".join((
                            name[1 : len(name) - 1 - cut], flag, b"*", b"0", b"0", b"*",
                            b"*", b"0", b"0", seq[:-1], qual[:-1],
                        )))
                out.write(b"\n".join(lines) + b"\n")
    finally:
        for handle in handles:
            handle.close()
    return sam


#: a Phred value as a .qual file spells it
QUAL_TEXT = [str(value - 33).encode() for value in range(256)]


def fastq_to_fasta_qual(fastq, fasta, qual, records):
    """The first ``records`` records of ``fastq`` as a FASTA and a ``.qual``
    file of space-separated Phred values, one line a record each, as 454
    and Ion Torrent runs were kept."""
    with open(fastq, "rb") as src, open(fasta, "wb") as fa, open(qual, "wb") as qu:
        for _ in range(records):
            name = src.readline()
            check(bool(name), ("fewer records than", records, fastq))
            seq, _, values = src.readline(), src.readline(), src.readline()
            header = b">" + name[1:]
            fa.write(header + seq)
            qu.write(header + b" ".join([QUAL_TEXT[v] for v in values[:-1]]) + b"\n")
    return fasta, qual


def serial_record(res, n_records, unit, per_record=False):
    """:func:`engine_record` for a path of the per-record pipeline; with
    ``per_record`` the path is scalar by the reference's design: no engine
    is built, and every record runs through the pipeline without one."""
    if not per_record:
        record = engine_record(res, n_records, unit)
        check(res["per_record"] == 0, res["per_record"])
        return record
    check(res["mode"] == "serial", res["mode"])
    check(res["build_counts"] == {"engine": 0, "fallback": 0}, res["build_counts"])
    check(res["per_record"] == n_records > 0, (res["per_record"], n_records))
    return {
        "seconds": res["seconds"], unit: n_records,
        unit + "_per_second": n_records / res["seconds"], "launches": res["counts"],
        "mode": res["mode"], "build_counts": res["build_counts"],
        "per_record": res["per_record"],
    }


def phase_se_sam_engine(work, source, n_reads):
    """An unaligned BAM of a multiplexed library, viewed as SAM (flag 4):
    the first ``n_reads`` reads of ``se_engine_path``'s input (``source``:
    the FASTQ and its reads' adapter, offset and clean flag), trimmed of
    the three adapters. The turbo runner reads no SAM, so the per-record
    pipeline runs it, the SAM text reader in front and the batched engine
    matching every adapter on the card (``dp_locate_word32``). Every read
    with a clean TruSeq copy of at least 20 bases inside it is cut at the
    copy's offset."""
    fastq, kinds, offsets, clean = source
    kinds, offsets, clean = kinds[:n_reads], offsets[:n_reads], clean[:n_reads]
    sam = os.path.join(work, "reads.sam")
    began = time.perf_counter()
    fastq_to_sam([fastq], sam, n_reads)
    made = time.perf_counter() - began

    def make_argv(inputs, folder):
        out = os.path.join(folder, "trimmed.fastq")
        report = os.path.join(folder, "report.txt")
        argv = ["trim"]
        for name, seq in SIDE_ADAPTERS:
            argv += ["-a", "{}={}".format(name, seq)]
        argv += ["-se", inputs[0], "-o", out,
                 "--quiet", "--no-cache-adapters", "--report-file", report]
        return argv, [out], report

    folder = os.path.join(work, "se_sam_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv([sam], folder)
    with _HostCalls(ENGINE_SPLIT) as calls:
        res = run_summary(argv, "cuda")
    record = serial_record(res, n_reads, "reads")
    record["split"] = engine_split(calls, res["seconds"])
    counts = res["counts"]
    check(counts["dp_locate_word32"] > 0 and counts["dp_locate_wide"] == 0, counts)
    lengths = output_lengths(outs[0])
    check(lengths.shape[0] == n_reads, "reads in != reads out")
    sure = (kinds == 0) & clean & (offsets <= 150 - 20)
    share = float((lengths[sure] == offsets[sure]).mean())
    check(int(sure.sum()) > n_reads // 8 and share > 0.97, ("cut at the TruSeq copy", share))
    prefix, _ = prefix_checks(make_argv, [sam], outs, work, "se_sam_engine_path", lines=(1,))
    os.remove(sam)
    return dict(
        argv="trim -a truseq=... -a nextera=... -a umi=... -se IN.sam -o OUT",
        read_length=150, make_input_seconds=made, cut_at_copy_share=share,
        prefix_check=prefix, **record,
    )


def phase_pe_sam_engine(work, source, n_pairs):
    """The first ``n_pairs`` pairs of ``pe_engine_path``'s input
    (``source``: both FASTQs and the inserts) in one queryname-sorted SAM
    (flags 77 and 141), read as interleaved pairs (``-l``) through the SAM
    reader's paired form, with the adapter aligner: the per-record
    pipeline, each mate's adapter on the card (``dp_locate_word32``);
    read-through pairs are cut at their insert."""
    mates, inserts = source
    inserts = inserts[:n_pairs]
    sam = os.path.join(work, "pairs.sam")
    began = time.perf_counter()
    fastq_to_sam(mates, sam, n_pairs)
    made = time.perf_counter() - began

    def make_argv(inputs, folder):
        outs = [os.path.join(folder, "sam_pe.{}.fastq".format(i)) for i in (1, 2)]
        report = os.path.join(folder, "report.txt")
        argv = ["trim", "--aligner", "adapter", "-a", "ad1=" + TRUSEQ, "-A", "ad2=" + TRUSEQ2,
                "-l", inputs[0], "-o", outs[0], "-p", outs[1],
                "--quiet", "--no-cache-adapters", "--report-file", report]
        return argv, outs, report

    folder = os.path.join(work, "pe_sam_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv([sam], folder)
    with _HostCalls(ENGINE_SPLIT) as calls:
        res = run_summary(argv, "cuda")
    record = serial_record(res, n_pairs, "pairs")
    record["split"] = engine_split(calls, res["seconds"])
    counts = res["counts"]
    check(counts["dp_locate_word32"] > 0 and counts["diag_counts_u8"] == 0, counts)
    len1, len2 = output_lengths(outs[0]), output_lengths(outs[1])
    check(len1.shape[0] == len2.shape[0] == n_pairs, "pairs in != pairs out")
    through = (inserts >= 20) & (inserts <= 140)
    share = float(((len1[through] == inserts[through])
                   & (len2[through] == inserts[through])).mean())
    check(share > 0.97, ("read-through pairs cut at their insert", share))
    prefix, _ = prefix_checks(make_argv, [sam], outs, work, "pe_sam_engine_path", lines=(2,))
    os.remove(sam)
    return dict(
        argv="trim --aligner adapter -a ad1=TRUSEQ -A ad2=TRUSEQ2 -l IN.sam -o -p",
        read_length=150, insert_mean=220, insert_sd=70, make_input_seconds=made,
        read_through_pairs=int(through.sum()), cut_at_insert_share=share,
        prefix_check=prefix, **record,
    )


def phase_se_fastaqual_engine(work, source, n_reads):
    """The first ``n_reads`` reads of ``se_engine_path``'s input
    (``source``, as :func:`phase_se_sam_engine` takes it) kept as FASTA and
    ``.qual`` (``-se IN.fasta -sq IN.qual``), quality-trimmed and trimmed of
    the TruSeq adapter: the turbo runner reads no quality file, so the
    per-record pipeline runs it, ``dp_locate_word32`` matching the adapter
    on the card. Every read with a clean TruSeq copy is cut at or before
    the copy's offset."""
    fastq, kinds, offsets, clean = source
    clean = clean[:n_reads] & (kinds[:n_reads] == 0)
    starts = offsets[:n_reads]
    fasta, qual = os.path.join(work, "reads.fasta"), os.path.join(work, "reads.qual")
    began = time.perf_counter()
    fastq_to_fasta_qual(fastq, fasta, qual, n_reads)
    made = time.perf_counter() - began

    def make_argv(inputs, folder):
        out = os.path.join(folder, "trimmed.fastq")
        report = os.path.join(folder, "report.txt")
        argv = ["trim", "-a", "truseq=" + TRUSEQ, "-q", "20", "-se", inputs[0],
                "-sq", inputs[1], "-o", out,
                "--quiet", "--no-cache-adapters", "--report-file", report]
        return argv, [out], report

    folder = os.path.join(work, "se_fastaqual_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv([fasta, qual], folder)
    with _HostCalls(ENGINE_SPLIT) as calls:
        res = run_summary(argv, "cuda")
    record = serial_record(res, n_reads, "reads")
    record["split"] = engine_split(calls, res["seconds"])
    counts = res["counts"]
    check(counts["dp_locate_word32"] > 0 and counts["dp_locate_wide"] == 0, counts)
    lengths = output_lengths(outs[0])
    check(lengths.shape[0] == n_reads, "reads in != reads out")
    sure = clean & (starts <= 150 - 20)
    share = float((lengths[sure] <= starts[sure]).mean())
    check(int(sure.sum()) > n_reads // 8 and share > 0.97, ("cut at the TruSeq copy", share))
    prefix, _ = prefix_checks(make_argv, [fasta, qual], outs, work,
                              "se_fastaqual_engine_path", lines=(2,))
    for path in (fasta, qual):
        os.remove(path)
    return dict(
        argv="trim -a truseq=TRUSEQ -q 20 -se IN.fasta -sq IN.qual -o OUT",
        read_length=150, make_input_seconds=made, cut_at_copy_share=share,
        prefix_check=prefix, **record,
    )


def write_tiled_fastq(path, rng, n_reads, tiles=12):
    """``write_truseq_fastq``'s reads with Illumina names whose fifth field
    is one of ``tiles`` tiles."""
    plain = path + ".plain"
    write_truseq_fastq(plain, rng, n_reads)
    tile = 1101 + rng.integers(0, tiles, n_reads)
    with open(plain, "rb") as src, open(path, "wb") as out:
        for i in range(n_reads):
            src.readline()
            name = "@A00123:8:HXXXXDSXX:1:{}:{}:{}\n".format(tile[i], 1000 + i, 2000 + i)
            out.write(name.encode() + src.readline() + src.readline() + src.readline())
    os.remove(plain)
    return path


def phase_se_stats_serial_check(work, seed):
    """``--stats both:tiles`` on a configuration the turbo runner declines
    (``--times 2``): the reference collects these statistics per record,
    and builds no engine under them, so every record runs through the
    pipeline on the scalar aligner, as in the reference; the position
    counts of the statistics run on the card, one call a table and batch.
    Cut to ``STATS_CHECK_READS`` reads because of the scalar step; every
    read runs again on the CPU, the output, summary and report compared
    whole."""
    rng = np.random.default_rng([seed, 21])
    fastq = write_tiled_fastq(os.path.join(work, "tiled.fastq"), rng, STATS_CHECK_READS)
    folder = os.path.join(work, "se_stats_card")
    os.makedirs(folder)
    out = os.path.join(folder, "trimmed.fastq")
    report = os.path.join(folder, "report.txt")
    argv = ["trim", "--stats", "both:tiles", "-a", "truseq=" + TRUSEQ, "--times", "2",
            "-se", fastq, "-o", out, "--quiet", "--no-cache-adapters", "--report-file", report]
    res = run_summary(argv, "cuda")
    record = serial_record(res, STATS_CHECK_READS, "reads", per_record=True)
    check(sum(res["counts"].values()) == 0, res["counts"])
    batches = -(-STATS_CHECK_READS // 1000)
    check(0 < res["stats_counts"]["cuda"] <= batches * 2 * 3 * 13, res["stats_counts"])
    check(res["stats_counts"]["cpu"] == 0, res["stats_counts"])
    (source,) = res["summary"]["pre"].values()
    tiles = source["read1"]["tile_sequence_qualities"]["rows"]
    check(len(tiles) == 12, ("tiles", len(tiles)))
    record["stats_counts"] = res["stats_counts"]
    cpu_out = out + ".cpu"
    cpu_argv = [cpu_out if arg == out else arg for arg in argv]
    defer_cpu("se_stats_serial_check", [dict(
        argv=cpu_argv, outs=[(cpu_out, out, None)], mode="serial", whole=True,
        per_record=STATS_CHECK_READS,
        summary={key: _plain_json(res["summary"].get(key)) for key in SUMMARY_KEYS},
        report_sections=_report_sections(report),
    )])
    return dict(
        argv="trim --stats both:tiles -a truseq=TRUSEQ --times 2 -se IN -o OUT",
        read_length=150, tiles=len(tiles), **record,
    )


def phase_pe_correct(work, inputs, n_pairs):
    """``pe_insert_path``'s pairs with ``--correct-mismatches liberal``:
    the turbo runner corrects each batch's overlaps on the host from the
    insert candidates of ``diag_counts_u8`` (the pairs' 1 % substitutions
    on both mates give it mismatches to correct) and patches the corrected
    records into its output; ``dp_locate_word32`` serves each mate's
    fallback adapter match."""
    outs = [os.path.join(work, "corrected.{}.fastq".format(i)) for i in (1, 2)]
    argv = pe_argv("insert", *inputs, *outs, work, report="report_correct.txt")
    argv += ["--correct-mismatches", "liberal"]
    res = run_summary(argv, "cuda")
    seconds, counts, run = res["seconds"], res["counts"], res["run"]
    check(res["mode"] == "turbo" and run["device"].startswith("cuda"), res["mode"])
    check(run["aligner"] == "insert" and run["pairs"] == n_pairs, run)
    check(counts["diag_counts_u8"] == run["batches"] > 0, (counts, run))
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"], counts)
    (corrector,) = [entry for entry in res["summary"]["trim"]["modifiers"].values()
                    if "records_corrected" in entry]
    corrected = (corrector["records_corrected"], list(corrector["bp_corrected"]))
    check(corrected[0] > n_pairs // 100 and sum(corrected[1]) > 0, corrected)
    defer_pair_check("pe_correct_path", argv, outs, run, work)
    return dict(
        argv="trim --aligner insert -a TRUSEQ -A TRUSEQ2 --correct-mismatches liberal "
             "-pe1 -pe2 -o -p",
        pairs=n_pairs, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts, corrected_pairs=corrected[0],
        corrected_bp=corrected[1], split_seconds=split_seconds(run),
    )


# -- the qc, detect and error commands -------------------------------------------


def command_checks(tag, makers, work, mode):
    """Runs of qc, detect or error on the card and their ``--device cpu``
    check: each of ``makers`` (folder) -> (argv, report) runs on the card
    now and on the CPU in the CPU phase, whose summary and report (less
    the header's command line and times) must equal the card's. None of
    these paths launches a kernel. Returns the card's runs."""
    folders = {device: os.path.join(work, "{}_{}".format(tag, device))
               for device in ("cpu", "cuda")}
    for folder in folders.values():
        os.makedirs(folder)
    cards, specs = [], []
    for i, make_argv in enumerate(makers):
        argv, report = make_argv(os.path.join(folders["cuda"], str(i)))
        card = run_summary(argv, "cuda")
        check(card["mode"] == mode, (tag, card["mode"]))
        check(sum(card["counts"].values()) == 0, (tag, card["counts"]))
        check(not any(card["kmer_counts"]["cpu"].values()), (tag, card["kmer_counts"]))
        check(card["stats_counts"]["cpu"] == 0, (tag, card["stats_counts"]))
        cpu_argv, cpu_report = make_argv(os.path.join(folders["cpu"], str(i)))
        specs.append(dict(
            argv=cpu_argv, report=cpu_report, outs=[], mode=mode,
            summary={key: _plain_json(card["summary"].get(key)) for key in SUMMARY_KEYS},
            report_sections=_report_sections(report),
        ))
        cards.append(card)
    defer_cpu(tag, specs)
    return cards


def command_record(res, n_records, unit):
    """What a qc, detect or error path prints: its seconds and rate, and
    its position counts and k-mer ops on the card."""
    return {
        "seconds": res["seconds"], unit: n_records,
        unit + "_per_second": n_records / res["seconds"], "mode": res["mode"],
        "position_counts_on_cuda": res["stats_counts"]["cuda"],
        "kmer_ops_on_cuda": res["kmer_counts"]["cuda"],
    }


def phase_qc(work, fastq, n_reads):
    """``qc -se`` on the main path's reads: the native route (chunks parsed
    by the runtime, padded byte matrices into the statistics), the
    position counts on the card. Then ``--max-reads`` of the main path's
    CPU prefix on the card, and again on the CPU in the CPU phase."""
    folder = os.path.join(work, "qc_card")
    os.makedirs(folder)
    report = os.path.join(folder, "qc.txt")
    res = run_summary(["qc", "-se", fastq, "-o", report, "--quiet"], "cuda")
    check(res["mode"] == "turbo", res["mode"])
    check(sum(res["counts"].values()) == 0, res["counts"])
    check(res["stats_counts"]["cuda"] > 0 and res["stats_counts"]["cpu"] == 0,
          res["stats_counts"])
    read1 = next(iter(res["summary"]["pre"].values()))["read1"]
    check(read1["counts"] == n_reads == res["summary"]["total_record_count"], read1["counts"])
    check(res["summary"]["total_bp_counts"][0] == 150 * n_reads, "qc bases")
    records = CPU_CHECK_RECORDS["qc_path"]
    prefix = os.path.join(work, "main_prefix.fastq")

    def make_argv(out):
        report = out + ".qc.txt"
        return ["qc", "-se", prefix, "--max-reads", str(records), "-o", report,
                "--quiet"], report

    (card_prefix,) = command_checks("qc_path", [make_argv], work, "turbo")
    check(card_prefix["stats_counts"]["cuda"] > 0, card_prefix["stats_counts"])
    return dict(
        argv="qc -se reads.fastq -o qc.txt", read_length=150,
        **command_record(res, n_reads, "reads"),
        prefix_check={"records": records, "card_prefix_seconds": card_prefix["seconds"]},
    )


def phase_pe_qc(work, inputs, n_pairs):
    """``qc -pe1 -pe2`` on ``pe_insert_path``'s pairs, both mate files in
    lockstep on the native route; the first ``CPU_PAIRS`` pairs again on
    the card and on the CPU."""

    def make_argv(paths, folder):
        report = os.path.join(folder, "qc.txt")
        return ["qc", "-pe1", paths[0], "-pe2", paths[1], "-o", report, "--quiet"], [], report

    folder = os.path.join(work, "pe_qc_card")
    os.makedirs(folder)
    argv, _, _ = make_argv(inputs, folder)
    res = run_summary(argv, "cuda")
    check(res["mode"] == "turbo", res["mode"])
    check(sum(res["counts"].values()) == 0, res["counts"])
    check(res["stats_counts"]["cuda"] > 0 and res["stats_counts"]["cpu"] == 0,
          res["stats_counts"])
    pre = next(iter(res["summary"]["pre"].values()))
    check(pre["read1"]["counts"] == pre["read2"]["counts"] == n_pairs, "qc pairs")
    prefix, card_prefix = prefix_checks(make_argv, inputs, [], work, "pe_qc_path")
    check(card_prefix["mode"] == "turbo", card_prefix["mode"])
    return dict(argv="qc -pe1 IN1 -pe2 IN2 -o qc.txt", read_length=150,
                **command_record(res, n_pairs, "pairs"), prefix_check=prefix)


#: what the detect paths' split times: the two k-mer ops on the card (each
#: call with its uploads and fetches) and the whole counting of k-mers
#: (packing, the count op, k-mer strings and membership sets)
DETECT_SPLIT = ((kmers, "unique_counts"), (kmers, "intersection_counts"),
                (detect_command, "count_corpus"))


def detect_matches(res):
    """Each input's matches: the longest k-mer, whether known, the names."""
    return [[{"longest_kmer": match["longest_kmer"], "is_known": match["is_known"],
              "known_names": match["known_names"]} for match in matches]
            for matches in res["summary"]["detect"]["matches"]]


def phase_detect(work, tag, inputs, n_records, extra, kind):
    """``detect`` with ``extra`` options on the first ``n_records`` records
    of ``inputs`` (one file, or a pair), with the bundled contaminants, on
    the card and in the CPU phase on the CPU. The k-mer ops of ``kind``
    (``batches``: sort and count; ``intersect_batches``: the contaminant
    panel) run on the card; every input's matches are printed and one at
    least is found."""
    paths = [write_prefix(path, n_records, os.path.join(work, "{}.{}.fastq".format(tag, i)))
             for i, path in enumerate(inputs)]
    inputs_argv = ["-se", paths[0]] if len(paths) == 1 else [
        "-pe1", paths[0], "-pe2", paths[1]]

    def make_argv(out):
        report = out + ".detect.txt"
        return (["detect"] + inputs_argv + extra
                + ["--no-cache-contaminants", "-o", report, "--quiet"], report)

    with _HostCalls(DETECT_SPLIT) as calls:
        (res,) = command_checks(tag, [make_argv], work, "serial")
    check(res["kmer_counts"]["cuda"][kind] > 0, (tag, res["kmer_counts"]))
    matches = detect_matches(res)
    check(all(matches), (tag, "no contaminant found", matches))
    unit = "reads" if len(paths) == 1 else "pairs"
    shown = ["-se", "IN"] if len(paths) == 1 else ["-pe1", "IN1", "-pe2", "IN2"]
    return dict(argv=" ".join(["detect"] + shown + extra), **command_record(res, n_records, unit),
                split=engine_split(calls, res["seconds"]), matches=matches)


def phase_error(work, se_input, pe_inputs):
    """``error -se`` and ``error -pe1 -pe2`` at the default ``--max-reads``
    (``ERROR_RECORDS``): the quality estimator, on the host as in the
    reference (the command resolves its device all the same)."""
    paths = [write_prefix(path, ERROR_RECORDS,
                          os.path.join(work, "error_in.{}.fastq".format(i)))
             for i, path in enumerate(pe_inputs)]

    def maker(inputs_argv, name):
        def make_argv(out):
            report = out + "." + name
            return ["error"] + inputs_argv + ["-o", report, "--quiet"], report
        return make_argv

    runs = command_checks("error_path", [
        maker(["-se", se_input], "se.txt"),
        maker(["-pe1", paths[0], "-pe2", paths[1]], "pe.txt"),
    ], work, "serial")
    records = {}
    for res, name in zip(runs, ("se", "pe")):
        rate = res["summary"]["errorrate"]
        check(all(0 < value < 1 for value in rate["estimate"]), rate)
        check(list(rate["total_len"]) == [150 * ERROR_RECORDS] * len(rate["estimate"]), rate)
        records[name] = dict(command_record(res, ERROR_RECORDS, "records"),
                             estimate=list(rate["estimate"]))
    return records


def _host_intersections(contams, reads):
    """The intersection matrix by numpy on the host, a contaminant at a
    time: membership of every read code in the contaminant's set."""
    live = reads != kmers.SENTINEL
    out = np.empty((contams.shape[0], reads.shape[0]), np.int64)
    for row, contam in enumerate(contams):
        hit = np.isin(reads, contam[contam != kmers.SENTINEL]) & live
        out[row] = hit.sum(axis=1)
    return out


def phase_kmer_ops(seed, known_input):
    """The detect command's two k-mer ops on the card against numpy on the
    same inputs, tolerance 0: the count op at ``KMER_HOLD_CODES`` codes and
    ``KMER_HOLD_KS``, against ``np.unique``; the intersection op at M x R =
    256 and at the known path's shape (the bundled contaminants against
    every read of ``known_input``, forward), against the reference's
    ``intersection_size`` pair by pair and against ``np.isin``. Each op's
    time on the card (the call, uploads and fetches included) beside
    numpy's on the host."""
    from atropos_tpu_torch.adapters import AdapterCache

    rng = np.random.default_rng([seed, 31])
    counts = []
    for k in KMER_HOLD_KS:
        for size in KMER_HOLD_CODES:
            pool = rng.integers(0, 5 ** k, max(1, size // 8), dtype=np.int64)
            flat = pool[rng.integers(0, pool.shape[0], size)]
            began = time.perf_counter()
            want = np.unique(flat, return_counts=True)
            numpy_ms = (time.perf_counter() - began) * 1e3
            kmers.unique_counts(flat, DEVICE)  # warm: allocator, first launch
            torch.cuda.synchronize()
            began = time.perf_counter()
            got = kmers.unique_counts(flat, DEVICE)
            card_ms = (time.perf_counter() - began) * 1e3
            exact = bool(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]))
            check(exact, ("k-mer count op", k, size))
            counts.append(dict(k=k, codes=size, distinct=int(want[0].shape[0]),
                               card_ms=card_ms, numpy_ms=numpy_ms, max_abs_err=0))
    cache = AdapterCache(None)
    cache.load_default()
    contam_sets = [kmers.packed_kmer_set(seq, 12) for seq, _ in cache.iter_sequences()]
    contam_sets = [arr for arr in contam_sets if arr is not None]
    with open(known_input) as handle:
        lines = handle.read().splitlines()
    read_sets = [arr for arr in (kmers.packed_kmer_set(seq, 12) for seq in lines[1::4])
                 if arr is not None]
    intersects = []
    for name, contams, reads in (("M x R = 256", contam_sets[:16], read_sets[:16]),
                                 ("the known path's shape", contam_sets, read_sets)):
        contams_m, reads_m = kmers.padded_rows(contams), kmers.padded_rows(reads)
        kmers.intersection_counts(contams_m, reads_m, DEVICE)
        torch.cuda.synchronize()
        began = time.perf_counter()
        got = kmers.batch_intersections(contams, reads, DEVICE)
        card_ms = (time.perf_counter() - began) * 1e3
        began = time.perf_counter()
        want = _host_intersections(contams_m, reads_m)
        isin_ms = (time.perf_counter() - began) * 1e3
        check(np.array_equal(got, want), ("k-mer intersection op", name))
        sample = [(int(i), int(j)) for i, j in zip(rng.integers(0, len(contams), 2000),
                                                   rng.integers(0, len(reads), 2000))]
        began = time.perf_counter()
        pairs = [kmers.intersection_size(contams[i], reads[j]) for i, j in sample]
        pair_ms = (time.perf_counter() - began) * 1e3 / len(sample)
        check(pairs == [int(got[i, j]) for i, j in sample], ("intersection_size", name))
        intersects.append(dict(
            shape=name, contaminants=len(contams), reads=len(reads),
            widest_read_set=int(reads_m.shape[1]), widest_contaminant=int(contams_m.shape[1]),
            hits=int(got.sum()), card_ms=card_ms, numpy_isin_ms=isin_ms,
            intersection_size_ms_a_pair=pair_ms,
            intersection_size_ms_all_pairs=pair_ms * len(contams) * len(reads),
            max_abs_err=0,
        ))
    return {"count": counts, "intersect": intersects}


# -- the dtype probe ---------------------------------------------------------------


def probe_planes(seed):
    """The planes the probe kernels are held to their plain version on:
    (label, [L, N] uint8 reads on the card)."""
    for L, N in dtype_probe.SHAPES:
        for symbols in (4, 256):
            for rep in range(3):
                yield "bytes<{}".format(symbols), dtype_probe.make_reads(
                    [seed, 11, L, symbols, rep], L, N, symbols, device=DEVICE)
        for kind in dtype_probe.PLANES:
            yield kind, dtype_probe.make_plane(kind, [seed, 13, L], L, N, device=DEVICE)
    for L, N in PROBE_ODD_SHAPES:
        for symbols in (4, 256):
            yield "bytes<{}".format(symbols), dtype_probe.make_reads(
                [seed, 14, L, N, symbols], L, N, symbols, device=DEVICE)


def phase_dtype_probe(seed, launches=20):
    """Both probe kernels against the plain version on the card over both
    shapes of the probe tool, the query byte moving and fixed, bytes 0-3
    and 0-255 and 3 seeds, the planes of ``dtype_probe.PLANES``, and N of
    1,002 and 16,386 reads (the whole final state compared, not only the
    output); their times at the main path's shape and the plain version's,
    and the SASS instructions a row of their column loops; then the probe
    tool itself on the card, its launches counted."""
    began = time.perf_counter()
    max_err = {kernel.name: 0 for kernel in dtype_probe.KERNELS}
    compared = 0
    for label, reads in probe_planes(seed):
        L, N = reads.shape
        for dyn in (True, False):
            out_e, state_e = dtype_probe.probe_columns(reads, torch.int32, dyn, state=True)
            for kernel in dtype_probe.KERNELS:
                out, state = kernel(reads, dyn, state=True)
                torch.cuda.synchronize()
                err = max(int((out - out_e).abs().max()),
                          int((state - state_e).abs().max()))
                max_err[kernel.name] = max(max_err[kernel.name], err)
                check(err == 0, "{} disagrees with its plain version at L={} N={} {} "
                                "dyn={}".format(kernel.name, L, N, label, dyn))
                compared += 1
    timings = {}
    props = torch.cuda.get_device_properties(0)
    clock_hz = sm_clock_mhz() * 1e6
    for kernel in dtype_probe.KERNELS:
        per_shape = {}
        for L, N in dtype_probe.SHAPES:
            reads = dtype_probe.make_reads([seed, 12, L], L, N, 4, device=DEVICE)
            times, out = device_times(lambda: kernel(reads, True), launches)
            plain_began = time.perf_counter()
            expected = kernel.plain(reads, True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - plain_began) * 1e3
            check(torch.equal(out, expected), kernel.name + " disagrees at its timed shape")
            cells = dtype_probe.cell_updates(L, N)
            # an issued 32-bit operation updates one int32 cell, or two
            # int16 cells
            ops_ms = (
                cells * dtype_probe.OPS_PER_CELL / kernel.reads_per_thread
                / (props.multi_processor_count * INT_OPS_PER_SM_CLOCK * clock_hz) * 1e3
            )
            bytes_ms = (L * N + 4 * dtype_probe.OUT_ROWS * N) / HBM_BYTES_PER_SECOND * 1e3
            sass = PROBE_SASS_ROWS[kernel.name]
            per_shape[(L, N)] = dict(
                ms=times["ms"], queued_ms=times["queued_ms"], host_ms=times["host_ms"],
                plain_ms=plain_ms,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None,
                sass_per_row=sass["dyn"]["sass_per_row"],
                sass_per_row_nodyn=sass["nodyn"]["sass_per_row"],
                shape=dict(L=L, N=N, M1=dtype_probe.M1, dyn=True),
                cell_updates=cells, sm_count=props.multi_processor_count,
                sm_clock_mhz=clock_hz / 1e6,
            )
        timings[kernel.name] = per_shape
    # the probe tool on the card, its launches counted from 0
    dtype_probe.reset_launch_counts()
    tool = dtype_probe.main(["--seed", str(seed)], device="cuda")
    tool_launches = dtype_probe.launch_counts()
    for kernel in dtype_probe.KERNELS:
        check(tool_launches[kernel.name] > 0, (kernel.name, tool_launches))
    emit({
        "dtype_probe": {
            "compared": compared, "tolerance": 0, "seconds": time.perf_counter() - began,
            "timings": {
                name: {"L={},N={}".format(*shape): t for shape, t in per_shape.items()}
                for name, per_shape in timings.items()
            },
            "tool": [
                {key: r[key] for key in ("name", "L", "N", "ms", "reads_per_second",
                                         "cell_updates_per_second")}
                for r in tool
            ],
            "tool_launches": tool_launches,
        }
    })
    main_shape = dtype_probe.SHAPES[1]
    return max_err, tool_launches, {
        name: per_shape[main_shape] for name, per_shape in timings.items()
    }


def pair_step_inputs(inputs, work, read_len):
    """The first pair batch of ``inputs`` as the fused pair step takes it:
    the paired runner's insert stage, both mates prepared and uploaded."""
    from atropos_tpu_torch.commands import get_command
    from atropos_tpu_torch.commands.trim import RecordHandler
    from atropos_tpu_torch.commands.trim.builder import TrimStackBuilder

    command = get_command("trim")
    outs = [os.path.join(work, "unused.{}.fastq".format(i)) for i in (1, 2)]
    options = command.parse_args(pe_argv("insert", *inputs, *outs, work)[1:])
    runner = command.runner_class(options)
    modifiers, filters, formatters, writers = TrimStackBuilder(runner).build()
    pair = turbo.TurboPairedRunner.build(
        runner, RecordHandler(modifiers, filters, formatters), writers, device="cuda",
    ).insert_pair
    runner.reader.close()
    record = 1 + 8 + 2 + 1 + read_len + 3 + read_len + 1
    args = []
    for lane, path in ((pair.lane1, inputs[0]), (pair.lane2, inputs[1])):
        with open(path, "rb") as handle:
            chunk = runtime.parse_chunk(handle.read(32768 * record))
        check(chunk.n == 32768, "chunk.n == 32768")
        tok, host_args, bits = lane.prepare(chunk, slice(0, 32768))
        dev = [None if a is None else a.to(DEVICE) for a in host_args]
        luts = lane._view_luts_dev
        args += [tok, bits, dev, luts]
        args.append(chunk)
    tok1, bits1, dev1, luts1, chunk1, tok2, bits2, dev2, luts2, chunk2 = args
    kernel = insert_kernel.kernel_for(
        min(tok1.width, tok2.width), pair._n_symbols(chunk1, chunk2)
    )
    return pair, kernel, (tok1, bits1, dev1, luts1, tok2, bits2, dev2, luts2)


def time_pair_step(pair, kernel, step_args, launches=20):
    """The fused pair step alone, and beside it what of it the counts
    kernel and ``insert_candidate_slots`` (torch ops) take."""

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(launches):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    step_ms = timed(lambda: pair._step(*step_args, kernel))
    _, _, m_col, ref_plane, query_plane = pair._planes(*step_args)
    ref_T, query_T = ref_plane.T.contiguous(), query_plane.T.contiguous()
    counts = kernel(ref_T, query_T, m_col)
    result = dict(step_ms=step_ms, counts_kernel=kernel.name,
                  counts_kernel_ms=timed(lambda: kernel(ref_T, query_T, m_col)),
                  W=query_plane.shape[1], B=query_plane.shape[0])
    if query_plane.shape[1] <= insert_kernel.PACKED_MAX_W:
        slots_ms = timed(lambda: insert_candidate_slots(
            counts, m_col, ref_plane, query_plane, pair._step_table,
            pair.matcher.min_overlap, pair.matcher.max_matches,
        ))
        result.update(insert_candidate_slots_ms=slots_ms,
                      insert_candidate_slots_share=slots_ms / step_ms)
    return result, (ref_T, query_T, m_col)


# -- the multi-process ranks and --threads ------------------------------------


def rank_child(rank, world, port, argv, results):
    """One rank of :func:`run_ranks`, in a spawned process: join the Gloo
    group, run ``argv`` through the port's entry point on card 0 with the
    launch counts set to 0 just before, and put (rank, its seconds, counts
    and the turbo runner's record, or the error's text) on ``results``."""
    from atropos_tpu_torch.parallel import distributed

    try:
        distributed.initialize("localhost:{}".format(port), world, rank)
        seconds, counts, run = run_trim(argv, torch.device("cuda", 0))
        results.put((rank, dict(seconds=seconds, counts=counts, run=run)))
    except Exception:  # the parent raises it
        import traceback

        results.put((rank, {"error": traceback.format_exc()}))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(argv, world=2):
    """``argv`` in ``world`` ranks on the one card, spawned processes
    joined over localhost; returns each rank's result (:func:`rank_child`)
    and the wall time from the first start to the last result. Every rank
    is joined or stopped before this returns."""
    import queue

    context = multiprocessing.get_context("spawn")
    results = context.Queue()
    port = free_port()
    processes = [context.Process(target=rank_child, args=(rank, world, port, argv, results))
                 for rank in range(world)]
    began = time.perf_counter()
    got = {}
    try:
        for process in processes:
            process.start()
        while len(got) < world:
            try:
                rank, result = results.get(timeout=5)
            except queue.Empty:
                check(all(process.is_alive() for process in processes),
                      "a rank ended without its result")
                continue
            check("error" not in result, result.get("error"))
            got[rank] = result
        wall = time.perf_counter() - began
    finally:
        for process in processes:
            process.join(timeout=60)
            if process.is_alive():
                process.terminate()
                process.join()
    return [got[rank] for rank in range(world)], wall


def record_ends(data):
    """The end offset of each four-line record of a FASTQ ``data``."""
    newlines = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    check(newlines.size % 4 == 0, "a FASTQ output of whole records")
    return newlines[3::4] + 1


def record_ids(data, ends):
    """The 8-digit numbers that start each record's name (``@%08d``)."""
    starts = np.concatenate([[0], ends[:-1]])
    digits = np.frombuffer(data, np.uint8)[starts[:, None] + np.arange(1, 9)] - 48
    return (digits * 10 ** np.arange(7, -1, -1)).sum(axis=1)


def check_shards(shards, single, results):
    """The ranks' ``.{rank}`` shards of one output against the one-process
    run's output ``single``: their records disjoint, and laid out in the
    order of the chunks (pair batches) each rank's runner says it owned,
    the one-process output byte for byte. Removes the shards. Returns the
    records of each shard."""
    pieces, ids, counts = {}, [], []
    for rank, (path, result) in enumerate(zip(shards, results)):
        with open(path, "rb") as handle:
            data = handle.read()
        os.remove(path)
        ends = record_ends(data)
        ids.append(record_ids(data, ends))
        counts.append(int(ends.size))
        at, start = 0, 0
        for index, count in result["run"]["owned"]:
            check(index % len(shards) == rank, (rank, index))
            stop = int(ends[at + count - 1]) if count else start
            pieces[index] = (data, start, stop)
            at, start = at + count, stop
        check(at == ends.size, (path, at, ends.size))
    check(np.intersect1d(ids[0], ids[1]).size == 0, "a record in two shards")
    check(sorted(pieces) == list(range(len(pieces))), sorted(pieces))
    with open(single, "rb") as handle:
        whole = handle.read()
    cursor = 0
    for index in sorted(pieces):
        data, start, stop = pieces[index]
        check(whole[cursor : cursor + stop - start] == data[start:stop],
              "the shards differ from the one-process output at unit {}".format(index))
        cursor += stop - start
    check(cursor == len(whole), (single, cursor, len(whole)))
    return counts


def rank_record(results, wall, unit, kernels):
    """What a rank path prints: each rank's seconds, rate, launches and
    the split of its run's seconds."""
    return {
        "seconds_from_start_to_last_result": wall,
        "ranks": [{
            "rank": rank, unit: result["run"][unit], "seconds": result["seconds"],
            unit + "_per_second": result["run"][unit] / result["seconds"],
            "owned": len(result["run"]["owned"]), "batches": result["run"]["batches"],
            "launches": {name: result["counts"][name] for name in kernels},
            # where each rank's threads spent the run (the runner's record)
            "split_seconds": {key: value for key, value in result["run"].items()
                              if key.endswith("_seconds")},
        } for rank, result in enumerate(results)],
    }


def phase_ranks_se(work, fastq, single_out, single_report, n_reads):
    """The main path's command line in two ranks on the one card (Gloo over
    localhost): each rank trims the chunks whose index is its rank modulo
    two into its ``.{rank}`` shard with ``dp_locate_word32``, and rank 0
    writes the report of the merged summaries, which must be the
    one-process run's from its trimming section on."""
    out = os.path.join(work, "ranks.fastq")
    report = os.path.join(work, "ranks_report.txt")
    argv = ["trim", "-a", TRUSEQ, "-se", fastq, "-o", out, "--quiet", "--no-cache-adapters",
            "--report-file", report]
    results, wall = run_ranks(argv)
    for result in results:
        run, counts = result["run"], result["counts"]
        check(run["device"].startswith("cuda") and len(run["owned"]) > 1, run)
        check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"] > 0,
              (counts, run))
    check(sum(result["run"]["reads"] for result in results) == n_reads, "reads of the ranks")
    check(not os.path.exists(out), "a rank wrote the unsuffixed output")
    counts = check_shards([os.path.join(work, "ranks.{}.fastq".format(rank)) for rank in (0, 1)],
                          single_out, results)
    check(_report_sections(report) == _report_sections(single_report),
          "the merged report differs from the one-process report")
    record = rank_record(results, wall, "reads", ("dp_locate_word32",))
    record.update(argv="trim -a TRUSEQ -se reads.fastq -o ranks.fastq (2 ranks, Gloo)",
                  shard_records=counts)
    return record



def phase_ranks_pe(work, inputs):
    """``pe_insert_path``'s command line on its first ``RANK_PAIRS`` pairs,
    once in this process and once in two ranks on the one card, which own
    the pair batches whose index is their rank modulo two and launch
    ``diag_counts_u8``: the shards of both mates against the one-process
    outputs, the merged report against the one-process report."""
    def argv(tag):
        outs = [os.path.join(work, "{}.{}.fastq".format(tag, mate)) for mate in (1, 2)]
        return pe_argv("insert", *inputs, *outs, work, report=tag + "_report.txt",
                       named=True) + [
            "--max-reads", str(RANK_PAIRS)], outs

    single_argv, single_outs = argv("rank_single")
    seconds, counts, run = run_trim(single_argv, "cuda")
    check(run["pairs"] == RANK_PAIRS and counts["diag_counts_u8"] > 0, (counts, run))
    ranks_argv, outs = argv("ranks_pe")
    results, wall = run_ranks(ranks_argv)
    for result in results:
        run, counts = result["run"], result["counts"]
        check(run["device"].startswith("cuda") and len(run["owned"]) > 1, run)
        check(counts["diag_counts_u8"] == run["batches"] > 0, (counts, run))
    check(sum(result["run"]["pairs"] for result in results) == RANK_PAIRS, "pairs of the ranks")
    shard_records = []
    for out, single in zip(outs, single_outs):
        stem, ext = os.path.splitext(out)
        shard_records.append(check_shards(
            ["{}.{}{}".format(stem, rank, ext) for rank in (0, 1)], single, results))
        os.remove(single)
    check(_report_sections(os.path.join(work, "ranks_pe_report.txt"))
          == _report_sections(os.path.join(work, "rank_single_report.txt")),
          "the merged report differs from the one-process report")
    record = rank_record(results, wall, "pairs", ("diag_counts_u8", "dp_locate_word32"))
    record.update(argv="trim --aligner insert -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p "
                       "--max-reads {} (2 ranks, Gloo)".format(RANK_PAIRS),
                  pairs=RANK_PAIRS, one_process_seconds=seconds, shard_records=shard_records)
    return record


#: the --threads command lines of ``threads_path``: (name, the options)
THREADS_RUNS = (
    ("writer_process", ["--threads", "3"]),
    ("no_writer_process", ["--threads", "3", "--no-writer-process"]),
    ("preserve_order", ["--threads", "3", "--preserve-order"]),
)


def sorted_records(paths):
    records = []
    for path in paths:
        with open(path, "rb") as handle:
            lines = handle.read().split(b"\n")
        records += [b"\n".join(lines[i : i + 4]) for i in range(0, len(lines) - 1, 4)]
    return sorted(records)


def run_cli(argv, report):
    """Start ``python -m atropos_tpu_torch ARGV`` (the user's entry point,
    on the card by default) in a process of its own, its report written
    as text and JSON to ``report`` + ``.txt`` and ``.json``, its standard
    error to ``report`` + ``.err``."""
    import subprocess

    with open(report + ".err", "w") as err:
        process = subprocess.Popen(
            [sys.executable, "-m", "atropos_tpu_torch"] + argv
            + ["--report-formats", "txt", "json"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err,
        )
    return process, report


def finish_cli(started, began, timeout=600):
    """Wait for every run of :func:`run_cli` in ``started``; each run's
    summary (the JSON report) and its seconds from ``began`` to its end.
    A run still going at ``timeout`` is stopped, and so is every run when
    one fails."""
    ends = {}
    try:
        while len(ends) < len(started):
            for i, (process, _) in enumerate(started):
                if i not in ends and process.poll() is not None:
                    ends[i] = time.perf_counter() - began
            check(time.perf_counter() - began < timeout, "a --threads run hangs")
            time.sleep(0.05)
    finally:
        for process, _ in started:
            if process.poll() is None:
                process.kill()
                process.wait()
    summaries = []
    for process, report in started:
        with open(report + ".err") as handle:
            check(process.returncode == 0, handle.read()[-3000:])
        with open(report + ".json") as handle:
            summary = json.load(handle)
        check("exception" not in summary, summary.get("exception"))
        summaries.append(summary)
    return summaries, [ends[i] for i in range(len(started))]


def phase_threads(work):
    """``trim --threads 3`` (the writer process, ``--no-writer-process``'s
    ``.N`` shards, ``--preserve-order``) and ``qc --threads 2`` (in
    ``QC_THREADS_BATCHES`` batches) on the main path's first
    ``THREADS_READS`` reads, the four command lines at once,
    each through ``python -m atropos_tpu_torch`` in a process of its own:
    spawned workers running the per-record pipeline without an engine, as
    in the reference. The trim workers launch no kernel and do no device
    work; qc's workers count their positions on the card. The three trim
    runs' records and summaries must agree; in the CPU phase the same
    command lines without the worker options on ``--device cpu`` (the turbo
    runner, qc's native route) must give the ordered output byte for byte
    and the same summaries and reports, and qc's the same count tables and
    record counts: the merge of several workers adds each histogram's
    derived statistics, as in the reference (ROADMAP.md queue 3 item
    14)."""
    prefix = write_prefix(os.path.join(work, "main_prefix.fastq"), THREADS_READS,
                          os.path.join(work, "threads_in.fastq"))
    folder = os.path.join(work, "threads")
    os.makedirs(folder)

    def trim_argv(out, report):
        return ["trim", "-a", "truseq=" + TRUSEQ, "-se", prefix, "-o", out, "--quiet",
                "--no-cache-adapters", "--report-file", report]

    began = time.perf_counter()
    started = [
        run_cli(trim_argv(os.path.join(folder, name + ".fastq"), os.path.join(folder, name))
                + extra, os.path.join(folder, name))
        for name, extra in THREADS_RUNS
    ]
    # qc in QC_THREADS_BATCHES batches, which both workers take
    qc_argv = ["qc", "-se", prefix, "--batch-size",
               str(THREADS_READS // QC_THREADS_BATCHES), "--quiet"]
    qc_report = os.path.join(folder, "qc")
    started.append(run_cli(qc_argv + ["-o", qc_report, "--threads", "2"], qc_report))
    summaries, seconds = finish_cli(started, began)
    records, sections, reports = [], [], []
    for (name, extra), summary in zip(THREADS_RUNS, summaries):
        check(summary["mode"] == "parallel" and summary["threads"] == 3, summary["mode"])
        check(summary["device"].startswith("cuda"), summary["device"])
        check(summary["total_record_count"] == THREADS_READS, "threads reads")
        out = os.path.join(folder, name + ".fastq")
        if name == "no_writer_process":
            stem, ext = os.path.splitext(out)
            paths = [p for p in ("{}.{}{}".format(stem, i, ext) for i in range(3))
                     if os.path.exists(p)]
            check(paths and not os.path.exists(out), paths)
            shard_files = len(paths)
        else:
            paths = [out]
        records.append(sorted_records(paths))
        sections.append({key: _plain_json(summary.get(key)) for key in SUMMARY_KEYS})
        reports.append(_report_sections(os.path.join(folder, name + ".txt")))
    check(records[0] == records[1] == records[2], "the --threads runs' records differ")
    check(sections[0] == sections[1] == sections[2], "the --threads runs' summaries differ")
    check(reports[0] == reports[1] == reports[2], "the --threads runs' reports differ")
    qc = summaries[-1]
    check(qc["mode"] == "parallel" and qc["threads"] == 2, qc["mode"])
    check(qc["total_record_count"] == THREADS_READS, "qc threads reads")
    cpu_out = os.path.join(folder, "cpu.fastq")
    defer_cpu("threads_path", [
        dict(argv=trim_argv(cpu_out, os.path.join(folder, "cpu.txt")),
             outs=[(cpu_out, os.path.join(folder, "preserve_order.fastq"), None)],
             whole=True, summary=sections[2], report_sections=reports[2]),
        dict(argv=qc_argv + ["-o", os.path.join(folder, "cpu_qc.txt")], outs=[],
             counts_only=True,
             summary=count_tables({key: _plain_json(qc.get(key)) for key in SUMMARY_KEYS})),
    ])
    return {
        "argv": "trim -a truseq=TRUSEQ -se IN -o OUT --threads 3 [--no-writer-process | "
                "--preserve-order]; qc -se IN --batch-size {} -o OUT --threads 2 "
                "(all four at once)".format(THREADS_READS // QC_THREADS_BATCHES),
        "reads": THREADS_READS, "seconds": max(seconds),
        "seconds_of_each_process": dict(zip([name for name, _ in THREADS_RUNS] + ["qc"],
                                            seconds)),
        "no_writer_process_shard_files": shard_files,
        "host_only": "the trim workers: no kernel, no device op; "
                     "qc's workers count their positions on the card",
    }


# -- goldens ---------------------------------------------------------------------

#: single-end cases: (parameters, golden, input, [(file written, golden)]);
#: ``{work}`` is the phase's folder, ``{name}`` in a golden demultiplexes
GOLDENS = [
    ("-b TTAGACATATCTCCGTCG", "small.fastq", "small.fastq", []),
    ("-a VCCGAMCYUCKHRKDCUBBCNUWNSGHCGU", "illumina.fastq", "illumina.fastq.gz", []),
    ("-a TTAGACATAT -g GAGATTGCCA --no-indels", "no_indels.fasta", "no_indels.fasta", []),
    ("-a AATTTCAGGAATT -a GTTCTCTAGTTCT", "twoadapters.fasta", "twoadapters.fasta", []),
    ("-m 24 -O 10 -a AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA", "polya.fasta", "polya.fasta", []),
    ("--info-file {work}/info.txt -a adapt=GCCGAACTTCTTAGACTGCCTTAAGGACGT",
     "illumina.fastq", "illumina.fastq.gz", [("info.txt", "illumina.info.txt")]),
    ("-a first=AATTTCAGGAATT -a second=GTTCTCTAGTTCT", "twoadapters.{name}.fasta",
     "twoadapters.fasta",
     [("golden_twoadapters.{}.fasta".format(name), "twoadapters.{}.fasta".format(name))
      for name in ("first", "second", "unknown")]),
    # the cases the turbo runner declines: the per-record pipeline and its
    # batched engine
    ("-n 3 -e 0.1 --length-tag length= "
     "-b TGAGACACGCAACAGGGGAAAGGCAAGGCACACAGGGGATAGG "
     "-b TCCATCTCATCCCTGCGTGTCCCATCTGTTCCCTCCCTGTCTCA", "454.fa", "454.fa", []),
    ("-b CAAG -n 3 --mask-adapter", "anywhere_repeat.fastq", "anywhere_repeat.fastq", []),
    ("--strip-suffix _sequence -a XXXXXXX", "stripped.fasta", "simple.fasta", []),
    ("--info-file {work}/info5.txt --times 2 -a adapt=GCCGAACTTCTTA "
     "-a adapt2=GACTGCCTTAAGGACGT", "illumina5.fastq", "illumina5.fastq",
     [("info5.txt", "illumina5.info.txt")]),
    ("--no-trim --discard-untrimmed -a CCCTAGTTAAAC", "no-trim.fastq", "small.fastq", []),
    ("-a AAAAAAAAAA...TTTTTTTTTT", "linked.fasta", "linked.fasta", []),
]
#: the last of GOLDENS that the turbo runner declines
SERIAL_GOLDENS = 6


def phase_goldens(work):
    """The single-end cases above, every paired-end case of the ported
    slice (the table of ``tests/test_torch_goldens_pe.py``, both aligners,
    and interleaved input and output), and the 20 colorspace cases (the six
    of ``tests/test_torch_goldens.py`` and the 14 of
    ``tests/test_torch_colorspace.py``, which the pipeline runs per record
    on the scalar aligner and which launch no kernel), on the card."""
    import pathlib

    sys.path.insert(0, ROOT)
    from tests import test_torch_colorspace, test_torch_goldens
    from tests.test_torch_goldens_pe import PORTED, SIDE_OUTPUTS, _argv
    from tests.test_torch_goldens_pe import SERIAL as PE_SERIAL

    conformance = os.path.join(ROOT, "tests", "conformance")
    launches = 0
    runs = []  # (argv, [(written, golden)], mode)
    for i, (params, expected, inpath, side) in enumerate(GOLDENS):
        out = os.path.join(work, "golden_" + expected)
        compared = [(os.path.join(work, written), golden) for written, golden in side]
        if "{name}" not in expected:
            compared.append((out, expected))
        runs.append((["trim"] + params.replace("{work}", work).split() + [
            "-se", os.path.join(conformance, "data", inpath), "-o", out,
        ], compared, "serial" if i >= len(GOLDENS) - SERIAL_GOLDENS else "turbo"))
    for i, (name, aligner, params, in1, in2, exp1, exp2) in enumerate(PORTED):
        case_dir = pathlib.Path(work) / "pe{}".format(i)
        case_dir.mkdir()
        argv, out1, out2 = _argv(params, aligner, in1, in2, exp1, exp2, case_dir)
        pairs = [(out1, exp1), (out2, exp2)] + [
            (str(case_dir / written), golden) for written, golden in SIDE_OUTPUTS.get(name, ())
        ]
        runs.append((["trim"] + argv, [
            (path, golden.format(aligner=aligner)) for path, golden in pairs
        ], "serial" if name in PE_SERIAL else "turbo"))
    for aligner in ("adapter", "insert"):
        out = os.path.join(work, "interleaved_{}.fastq".format(aligner))
        runs.append((["trim"] + "-q 20 -a TTAGACATAT -A CAGTGGAGTA -m 14 -M 90".split() + [
            "--aligner", aligner, "-l", os.path.join(conformance, "data", "interleaved.fastq"),
            "-L", out,
        ], [(out, "interleaved.fastq")], "turbo"))
    colorspace = []  # the same, for the colorspace cases
    for name, params, expected, inpath in test_torch_goldens.CASES:
        if name in test_torch_goldens.COLORSPACE:
            case_dir = pathlib.Path(work) / ("cs_" + name)
            case_dir.mkdir()
            argv, out = test_torch_goldens._argv(params, expected, inpath, case_dir)
            side = test_torch_goldens.SIDE_OUTPUTS.get(name, ())
            colorspace.append((["trim"] + argv, [(out, expected)] + [
                (str(case_dir / written), golden) for written, golden in side
            ], "serial"))
    for name, params, expected, inpath, qualfile in test_torch_colorspace.CASES:
        case_dir = os.path.join(work, "cs_" + name)
        os.makedirs(case_dir)
        argv, out, _ = test_torch_colorspace.case_argv(
            params, expected, inpath, qualfile, case_dir)
        colorspace.append((["trim"] + argv, [(out, expected)], "serial"))
    check(len(colorspace) == 20, len(colorspace))
    modes = {}
    for argv, outputs, mode in runs + colorspace:
        argv = argv + ["--quiet", "--no-cache-adapters",
                       "--report-file", os.path.join(work, "report3.txt")]
        res = run_summary(argv, "cuda")
        check(res["mode"] == mode, (res["mode"], argv))
        modes[mode] = modes.get(mode, 0) + 1
        if "-c" in argv:
            # no engine, no kernel: every record on the scalar aligner
            check(sum(res["counts"].values()) == 0 and res["per_record"] > 0,
                  (res["counts"], res["per_record"], argv))
            check(res["build_counts"] == {"engine": 0, "fallback": 1}, res["build_counts"])
        else:
            launches += sum(res["counts"].values())
        for path, golden in outputs:
            with open(path, "rb") as got, open(
                os.path.join(conformance, "expected", golden), "rb"
            ) as want:
                if got.read() != want.read():
                    raise AssertionError("golden case differs on the card: {}".format(argv))
    check(launches >= len(runs), 'launches >= len(runs)')
    emit({"goldens": {"single_end_cases": len(GOLDENS),
                      "paired_end_cases": len(runs) - len(GOLDENS),
                      "colorspace_cases": len(colorspace),
                      "identical": len(runs) + len(colorspace), "launches": launches,
                      "colorspace_launches": 0, "modes": modes}})


# -- the large seeded inputs, written while the kernels build --------------------

#: the near-poly-A pairs of the 2x150 insert path: more insert candidates
#: than the bundle's slots
PE_POLY_A = (40000, 43000)


def input_writers(work, seed, n_reads):
    """The card phases' large seeded inputs: tag of the phase that reads
    it first -> (writer, paths, the key of its rng, the writer's further
    arguments)."""
    def paths(*names):
        return [os.path.join(work, name) for name in names]

    return {
        "pe_overwrite_path": (partial(write_pairs, low_window=(0.1, 10)),
                              paths("ow.1.fastq", "ow.2.fastq"), [seed, 10],
                              (PAIRS, 150, 220, 70)),
        "main_path": (write_truseq_fastq, paths("reads.fastq"), [seed, 2], (n_reads,)),
        "pe_insert_path": (write_pairs, paths("pairs150.1.fastq", "pairs150.2.fastq"),
                           [seed, 6, 150], (PAIRS, 150, 220, 70, PE_POLY_A)),
        "se_side_path": (write_side_fastq, paths("side.fastq"), [seed, 9], (SIDE_READS,)),
        "pe_insert_wide_path": (write_pairs, paths("pairs300.1.fastq", "pairs300.2.fastq"),
                                [seed, 6, 300], (WIDE_PAIRS, 300, 400, 70)),
        "pe_engine_path": (write_pairs, paths("engine_pairs.1.fastq", "engine_pairs.2.fastq"),
                           [seed, 16], (ENGINE_PAIRS, 150, 220, 70)),
        "se_engine_path": (write_side_fastq, paths("engine.fastq"), [seed, 15],
                           (ENGINE_READS,)),
    }


def write_input(writer, paths, key, args):
    """One input, in a process of the input pool: (paths, what ``writer``
    returns, its seconds)."""
    began = time.perf_counter()
    made = writer(*paths, np.random.default_rng(key), *args)
    return paths, made, time.perf_counter() - began


def start_inputs(work, seed, n_reads):
    """Start writing every input of :func:`input_writers`, longest first,
    in spawned processes, one a host core: they run while the kernels
    build, before any phase that times the card."""
    writers = input_writers(work, seed, n_reads)
    pool = multiprocessing.get_context("spawn").Pool(min(len(writers), os.cpu_count() or 1))
    pending = {tag: pool.apply_async(write_input, job) for tag, job in writers.items()}
    return dict(pool=pool, pending=pending, began=time.perf_counter())


def finish_inputs(inputs):
    """Wait for the inputs and stop the pool; print the wall time and each
    writer's seconds. Returns tag -> (paths, what the writer returned,
    its seconds)."""
    try:
        made = {tag: result.get() for tag, result in inputs["pending"].items()}
    finally:
        inputs["pool"].terminate()
        inputs["pool"].join()
    emit({"inputs": {
        "seconds": time.perf_counter() - inputs["began"],
        "make_input_seconds": {tag: seconds for tag, (_, _, seconds) in made.items()},
        "bytes": {tag: sum(os.path.getsize(path) for path in paths)
                  for tag, (paths, _, _) in made.items()},
    }})
    return made


# -- main --------------------------------------------------------------------------


#: the string-hash seed of this script and of the children it spawns: the
#: detect command names a contaminant's names in the order of a set of
#: strings, as the reference does (ROADMAP.md queue 3 item 10), so the
#: card's run and the CPU's check of it must hash strings alike
HASH_SEED = "0"


def with_fixed_hash_seed():
    """Run this script again in this process under ``HASH_SEED``, unless
    it already runs under it; the CPU phase's spawned children inherit
    the seed."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.environ["PYTHONHASHSEED"] = HASH_SEED
        os.execv(sys.executable, [sys.executable] + sys.argv)


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False\n")
        sys.exit(1)
    with_fixed_hash_seed()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=20240229)
    parser.add_argument("--reads", type=int, default=2000000,
                        help="reads of the main path's input")
    parser.add_argument("--main-path-runs", type=int, default=1,
                        help="times the main path's command is run (the "
                             "first run is the one checked and reported)")
    args = parser.parse_args()
    began = time.perf_counter()
    marks = [("start", began)]

    def mark(name):
        """The end of a stretch of phases, for the seconds line."""
        marks.append((name, time.perf_counter()))

    card = timing.smi("name,power.limit")
    emit({"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm_clock_max": timing.smi("clocks.max.sm")})
    work = tempfile.mkdtemp(prefix="atropos_chip_smoke_")
    cpu = None
    writing = start_inputs(work, args.seed, args.reads)
    try:
        try:
            phase_build()
        finally:
            made = finish_inputs(writing)
        mark("build and inputs")
        word32_launches, fastq, main_out = phase_main_path(
            work, made["main_path"], args.reads, args.main_path_runs
        )
        ranks_se = phase_ranks_se(work, fastq, main_out, os.path.join(work, "main_report.txt"),
                                  args.reads)
        emit({"ranks_se_path": ranks_se})
        keep_card_prefix(main_out, CPU_CHECK_RECORDS["main_path"])
        mark("main path and ranks_se_path")
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
        step["dp_kernel_queued_ms"] = word32_time["queued_ms"]
        emit({"device_step_at_main_path_shape": step})
        wide_launches, wide_time = phase_long_path(work, args.seed)

        # 2x150 pairs: the insert aligner (diag_counts_u8), then the adapter
        # aligner on the same files
        pe, inputs = phase_pe_insert(
            work, made["pe_insert_path"], PAIRS, 150, 220, diag_counts_u8, PE_POLY_A,
        )
        pair, kernel, step_args = pair_step_inputs(inputs, work, 150)
        check(kernel is diag_counts_u8, kernel.name)
        pe["pair_step"], u8_inputs = time_pair_step(pair, kernel, step_args)
        emit({"pe_insert_path": pe})
        u8_launches = pe["launches"]["diag_counts_u8"]
        u8_time = time_diag(diag_counts_u8, *u8_inputs)
        emit({"pe_adapter_path": phase_pe_adapter(work, inputs, PAIRS)})
        emit({"pe_side_path": phase_pe_side(work, inputs, PAIRS)})
        mark("turbo paths, first part")
        ranks_pe = phase_ranks_pe(work, inputs)
        emit({"ranks_pe_path": ranks_pe})
        mark("ranks_pe_path")
        pe_correct = phase_pe_correct(work, inputs, PAIRS)
        emit({"pe_correct_path": pe_correct})
        mark("pe_correct_path")

        # the qc, detect and error commands on the main path's reads and the
        # 2x150 pairs: the position counts and the k-mer ops on the card
        emit({"qc_path": phase_qc(work, fastq, args.reads)})
        os.remove(fastq)
        emit({"pe_qc_path": phase_pe_qc(work, inputs, PAIRS)})
        main_prefix = os.path.join(work, "main_prefix.fastq")
        emit({"detect_path": phase_detect(
            work, "detect_path", [main_prefix], DETECT_READS, [], "batches")})
        emit({"detect_known_path": phase_detect(
            work, "detect_known_path", [main_prefix], DETECT_KNOWN_READS, ["-i", "known"],
            "intersect_batches")})
        emit({"detect_khmer_path": phase_detect(
            work, "detect_khmer_path", [main_prefix], DETECT_KHMER_READS, ["-d", "khmer"],
            "batches")})
        emit({"pe_detect_check": phase_detect(
            work, "pe_detect_check", inputs, PE_DETECT_PAIRS, ["-i", "known"],
            "intersect_batches")})
        emit({"error_path": phase_error(work, main_prefix, inputs)})
        emit({"kmer_ops": phase_kmer_ops(
            args.seed, os.path.join(work, "detect_known_path.0.fastq"))})
        mark("qc, detect and error paths")
        emit({"threads_path": phase_threads(work)})
        mark("threads_path")
        for path in inputs:
            os.remove(path)
        emit({"pe_overwrite_path": phase_pe_overwrite(work, made["pe_overwrite_path"], PAIRS)})

        # 2x300 pairs (MiSeq v3): the window exceeds 255, diag_counts_i32
        wide_pe, wide_inputs = phase_pe_insert(
            work, made["pe_insert_wide_path"], WIDE_PAIRS, 300, 400, diag_counts_i32, (0, 0),
        )
        pair, kernel, step_args = pair_step_inputs(wide_inputs, work, 300)
        check(kernel is diag_counts_i32, kernel.name)
        wide_pe["pair_step"], i32_inputs = time_pair_step(pair, kernel, step_args)
        emit({"pe_insert_wide_path": wide_pe})
        i32_launches = wide_pe["launches"]["diag_counts_i32"]
        i32_time = time_diag(diag_counts_i32, *i32_inputs)
        for path in wide_inputs:
            os.remove(path)
        emit({"se_side_path": phase_se_side(work, made["se_side_path"], SIDE_READS)})
        mark("turbo paths, second part")
        probe_err, probe_launches, probe_times = phase_dtype_probe(args.seed)
        global_column = phase_global_column(args.seed)
        mark("dtype probe and global column")

        # the configurations the turbo runner declines: the per-record
        # pipeline, its batched engine on the card
        se_engine, se_source = phase_se_engine(work, made["se_engine_path"], ENGINE_READS)
        emit({"se_engine_path": se_engine})
        pe_engine, pe_source = phase_pe_engine(work, made["pe_engine_path"], ENGINE_PAIRS)
        emit({"pe_engine_path": pe_engine})
        insert_check = phase_pe_engine_insert_check(work, args.seed)
        emit({"pe_engine_insert_check": insert_check})
        mark("engine paths")
        # the inputs the turbo runner reads no chunk of: SAM (single-end and
        # paired) and FASTA + qual, made of the engine paths' reads, and
        # per-record --stats
        se_sam = phase_se_sam_engine(work, se_source, SAM_READS)
        emit({"se_sam_engine_path": se_sam})
        pe_sam = phase_pe_sam_engine(work, pe_source, SAM_PAIRS)
        emit({"pe_sam_engine_path": pe_sam})
        fastaqual = phase_se_fastaqual_engine(work, se_source, FASTAQUAL_READS)
        emit({"se_fastaqual_engine_path": fastaqual})
        for path in [se_source[0]] + list(pe_source[0]):
            os.remove(path)
        emit({"se_stats_serial_check": phase_se_stats_serial_check(work, args.seed)})
        mark("SAM, FASTA + qual and --stats paths")
        engine_launches = {
            "dp_locate_word32": sum(
                record["launches"]["dp_locate_word32"]
                for record in (se_engine, pe_engine, insert_check["runs"]["merge"],
                               se_sam, pe_sam, fastaqual)),
            "diag_counts_u8": insert_check["runs"]["insert"]["launches"]["diag_counts_u8"],
        }

        # after the last timed card phase: every --device cpu check, in
        # child processes, while the untimed card checks run here
        cpu = start_cpu_phase()
        max_err = phase_grid(args.seed)
        max_err.update(phase_diag_grid(args.seed))
        max_err.update(probe_err)
        phase_goldens(work)
        mark("grids and goldens beside the cpu phase")
        finish_cpu_phase(cpu)
        cpu = None
        mark("rest of the cpu phase")
    finally:
        if cpu is not None:
            stop_cpu_phase(cpu)
        shutil.rmtree(work, ignore_errors=True)

    emit({"dp_global_column": global_column})
    kernels = []
    for kernel, source, launches, measured in (
        (dp_locate_word32, "atropos_tpu_torch/csrc/dp_align.cu", word32_launches, word32_time),
        (dp_locate_wide, "atropos_tpu_torch/csrc/dp_align.cu", wide_launches, wide_time),
        (diag_counts_u8, "atropos_tpu_torch/csrc/diag_counts.cu", u8_launches, u8_time),
        (diag_counts_i32, "atropos_tpu_torch/csrc/diag_counts.cu", i32_launches, i32_time),
    ) + tuple(
        (kernel, "atropos_tpu_torch/csrc/dtype_probe.cu", probe_launches[kernel.name],
         probe_times[kernel.name])
        for kernel in dtype_probe.KERNELS
    ):
        if launches <= 0:
            raise AssertionError(kernel.name + " was not launched on its path")
        entry = {
            "name": kernel.name,
            "route": "cuda",
            "source": source,
            "replaces": kernel.replaces.split(" ")[0],
            "launches": launches,
            "max_abs_err": max_err[kernel.name],
        }
        if kernel.name in engine_launches:
            # launches on the engine paths (se_engine_path, pe_engine_path,
            # the insert check's -R run, the SAM and FASTA + qual paths; the
            # insert check's insert run for the counts)
            check(engine_launches[kernel.name] > 0, (kernel.name, engine_launches))
            entry["engine_launches"] = engine_launches[kernel.name]
        entry["rank_launches"] = {
            tag: [rank["launches"][kernel.name] for rank in record["ranks"]]
            for tag, record in (("ranks_se_path", ranks_se), ("ranks_pe_path", ranks_pe))
            if kernel.name in record["ranks"][0]["launches"]
        }
        if kernel is diag_counts_u8:
            # launches on the insert path with --correct-mismatches
            entry["correct_path_launches"] = pe_correct["launches"]["diag_counts_u8"]
            check(entry["correct_path_launches"] > 0, entry["correct_path_launches"])
        entry.update(measured)
        kernels.append(entry)
    print(card, flush=True)
    emit({"seconds": time.perf_counter() - began, "phase_seconds": {
        name: stamp - marks[i][1] for i, (name, stamp) in enumerate(marks[1:])}})
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
