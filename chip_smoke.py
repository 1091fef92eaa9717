#!/usr/bin/env python3
"""Start the port on the GPU: build, check and time its kernels, and drive
its single-end and paired-end paths end to end.

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
3. ``grid``     ``dp_locate_word32`` and ``dp_locate_wide`` against the plain
                PyTorch DP on the card over a covering set of configurations
                (indel costs 1, 2, 3 and 100000; adapters on both sides of
                every row cap of ``dp_locate_word32``'s register column, 15,
                16, 31, 32, 47, 48, 63 and 64 bases; 880-base adapters on
                512 reads of 7,328 bases, which ``dp_locate_wide`` serves one
                warp a read, with indel costs 1, 2, 3 and 100000 in both
                compare modes; adapters of 1,200 and 2,000 bases whose column
                lives in global memory): exact equality of all result rows
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
11. ``pe_overwrite_path``  1,000,000 new pairs of 2x150, a tenth of them
                with one mate's 5' window at quality 2 and the other's at 35,
                through ``--aligner adapter -w 10,30,10``
12. ``se_side_path``  2,000,000 reads of 150 bases, a quarter each carrying a
                TruSeq, a Nextera and a small-RNA UMI adapter, through ``-o
                out.{name}.fastq --info-file -r --wildcard-file --stats both``
                with the three adapters named
13. ``dtype_probe``  ``dtype_probe_i32`` and ``dtype_probe_i16x2`` against
                their plain version (the whole final state, both shapes of the
                probe tool, query byte moving and fixed, 3 seeds, the planes of
                ``dtype_probe.PLANES``, and N of 1,002 and 16,386 reads, no
                multiple of any block width), their times and SASS
                instructions a row, and the probe tool's run on the card
14. ``goldens``  seven upstream single-end cases (the info file and the
                demultiplexed outputs among them) and every paired-end case of
                the ported slice on the card against ``tests/conformance``
15. ``kernels``  for each kernel: launches on its path (counts set to 0 just
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
                ``insert_kernel.DIAGONAL_OPS`` a diagonal
16. the last line: ``{"ok": true, "device": {...}}``

Every path whose output the card makes also runs on ``--device cpu`` for a
prefix of its input, ``(DEPTH + 2) x MAX_BATCH`` = 163,840 reads or pairs:
the CPU's outputs must be byte-identical prefixes of the card's (the side
files and every demultiplexed file among them); for the side paths the card
also runs the prefix alone, and its statistics and report must equal the
CPU's.

Any phase that fails raises: the script then exits non-zero without the
last line. Without a usable card it exits non-zero at once.
"""
import argparse
import json
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
from atropos_tpu_torch.commands import get_command
from atropos_tpu_torch.commands import stats
from atropos_tpu_torch.engine import turbo
from atropos_tpu_torch.tools import dtype_probe
from cuda_tools import sass_rows, timing

ROOT = os.path.dirname(os.path.abspath(__file__))
TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
# TruSeq read-2 adapter: what mate 2 reads into after a short insert
TRUSEQ2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
PAIRS = 1000000  # 2x150 pairs of the insert and adapter paired-end paths
WIDE_PAIRS = 200000  # 2x300 pairs of the wide insert path
SIDE_READS = 2000000  # 150-base reads of the single-end side path
# pairs of each paired-end path run again on the CPU: a pair batch holds at
# most MAX_BATCH pairs, so this prefix holds the card's first DEPTH + 2
# batches whole, and batches DEPTH + 1 and DEPTH + 2 reuse pinned upload and
# fetch slots that earlier batches released
CPU_PAIRS = (turbo.TurboPairedRunner.DEPTH + 2) * turbo.TurboPairedRunner.MAX_BATCH
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
    return configs + row_caps + strips


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


def phase_grid(seed):
    began = time.perf_counter()
    compared = {"dp_locate_word32": 0, "dp_locate_wide": 0}
    max_err = {"dp_locate_word32": 0, "dp_locate_wide": 0}
    global_column = {}
    served = {}  # dp_locate_word32's instantiations: configurations each served
    served_wide = {}  # dp_locate_wide's
    rounds = {}  # the strips' fix-up rounds, by configuration
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
                # in global memory, and it is timed there for PERF.md
                how = kernel.instantiation(cfg["m"], aligner.k, cfg["L"])
                check(how.kind == "global", (kernel.name, "global column", cfg, how))
                global_column[kernel.name] = time_kernel(
                    kernel, aligner, reads_T, lens, launches=5
                )
        found_total += int(expected[0].sum())
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
            "global_column": global_column,
        }
    })
    return max_err, global_column


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
    cuda_kernel.reset_launch_counts()
    insert_kernel.reset_launch_counts()
    began = time.perf_counter()
    retcode = port_main(argv, device=device)
    seconds = time.perf_counter() - began
    counts = dict(cuda_kernel.launch_counts(), **insert_kernel.launch_counts())
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


def compare_with_cpu(argv, outs, cpu_outs, card_run):
    """The same command line on ``cpu`` for the first ``CPU_PAIRS`` pairs:
    its outputs must be the byte-identical prefix of the card's. The card's
    run must have had more batches than the prefix holds whole, so that
    the prefix reaches batches whose pinned slots were reused."""
    check(card_run["batches"] > turbo.TurboPairedRunner.DEPTH + 2, card_run)
    pairs = CPU_PAIRS
    cpu_argv = [cpu_outs[outs.index(a)] if a in outs else a for a in argv]
    cpu_argv += ["--max-reads", str(pairs)]
    seconds, counts, run = run_trim(cpu_argv, "cpu")
    check(run["device"] == "cpu" and run["pairs"] == pairs, run)
    check(sum(counts.values()) == 0, counts)
    sizes = []
    for out, cpu_out in zip(outs, cpu_outs):
        with open(cpu_out, "rb") as handle:
            cpu_bytes = handle.read()
        with open(out, "rb") as handle:
            card_prefix = handle.read(len(cpu_bytes))
        check(len(cpu_bytes) > 0 and cpu_bytes == card_prefix,
              "CPU and GPU outputs differ: " + out)
        sizes.append(len(cpu_bytes))
        os.remove(cpu_out)
    return {"pairs": pairs, "seconds": seconds, "identical_prefix_bytes": sizes,
            "slot_overflow_pairs": run["slot_overflow_pairs"]}


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


def phase_pe_insert(work, seed, n_pairs, read_len, mean, kernel, poly_a):
    """``trim --aligner insert`` on seeded pairs: the counts kernel the
    window selects runs once a pair batch, ``dp_locate_word32`` once a
    batch for each mate's fallback adapter match."""
    rng = np.random.default_rng([seed, 6, read_len])
    in1 = os.path.join(work, "pairs{}.1.fastq".format(read_len))
    in2 = os.path.join(work, "pairs{}.2.fastq".format(read_len))
    began = time.perf_counter()
    inserts, _ = write_pairs(in1, in2, rng, n_pairs, read_len, mean, 70, poly_a)
    made = time.perf_counter() - began
    outs = [os.path.join(work, "trimmed_pe.{}.fastq".format(i)) for i in (1, 2)]
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
    cpu = compare_with_cpu(argv, outs, [o + ".cpu" for o in outs], run)
    for out in outs:
        os.remove(out)
    return dict(
        argv="trim --aligner insert -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p",
        pairs=n_pairs, read_length=read_len, insert_mean=mean, insert_sd=70,
        input_bytes=os.path.getsize(in1) + os.path.getsize(in2),
        make_input_seconds=made, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts,
        slot_overflow_pairs=run["slot_overflow_pairs"],
        read_through_pairs=int(through.sum()), cut_at_insert_share=share,
        split_seconds=split_seconds(run), cpu_check=cpu,
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
    cpu = compare_with_cpu(argv, outs, [o + ".cpu" for o in outs], run)
    for out in outs:
        os.remove(out)
    return dict(
        argv="trim --aligner adapter -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p",
        pairs=n_pairs, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts, split_seconds=split_seconds(run),
        cpu_check=cpu,
    )


# -- the side paths: --stats, side files, demultiplexing, -w --------------------

#: the adapters of the single-end side path: (name, sequence)
SIDE_ADAPTERS = (
    ("truseq", TRUSEQ),
    ("nextera", "CTGTCTCTTATACACATCT"),
    ("umi", "TGGAATTCTCNNNNNNCCAAGG"),
)
#: records of each side path run again on the CPU (and alone on the card)
PREFIX_RECORDS = turbo.TurboTrimRunner.MAX_BATCH * (turbo.TurboTrimRunner.DEPTH + 2)


def write_side_fastq(path, rng, n_reads, read_len=150, chunk=250000):
    """Reads of ``read_len`` bases: a quarter each carry one of
    ``SIDE_ADAPTERS`` at a random offset (cut off at the read's end; the
    UMI adapter with random bases in its N run), a quarter carry none; 1 %
    substitutions over every read. Returns the adapter index of each read
    (3: none)."""
    kinds_all = []
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
            kinds_all.append(kinds)
    return np.concatenate(kinds_all)


def write_prefix(path, records, out_path):
    """The first ``records`` FASTQ records of ``path`` into ``out_path``."""
    with open(path, "rb") as src, open(out_path, "wb") as dst:
        for _ in range(4 * records):
            dst.write(src.readline())
    return out_path


def run_trim_summary(argv, device):
    """One command line through the trim command's entry point, as
    :func:`run_trim` does, also returning the run's summary and how many
    position counts of the statistics ran on each device type."""
    cuda_kernel.reset_launch_counts()
    insert_kernel.reset_launch_counts()
    stats_before = dict(stats.DEVICE_STATS_COUNTS)
    began = time.perf_counter()
    retcode, summary = get_command("trim").execute(argv[1:], device=device)
    seconds = time.perf_counter() - began
    counts = dict(cuda_kernel.launch_counts(), **insert_kernel.launch_counts())
    if retcode != 0 or "exception" in summary:
        raise RuntimeError("trim failed ({}): {} {}".format(
            retcode, argv, summary.get("exception")))
    stats_counts = {
        key: stats.DEVICE_STATS_COUNTS[key] - stats_before[key] for key in stats_before
    }
    return seconds, counts, dict(turbo.LAST_RUN), summary, stats_counts


def _plain_json(value):
    return json.loads(json.dumps(value, default=str))


def _report_sections(path):
    """A report from its trimming section on (the header holds the command
    line and the times)."""
    with open(path, "rb") as handle:
        data = handle.read()
    return data[data.index(b"--------\nTrimming"):]


def prefix_checks(make_argv, inputs, card_outs, work, tag):
    """The side path's checks against ``--device cpu``: the first
    ``PREFIX_RECORDS`` records of ``inputs`` through the CPU, whose every output
    must be a byte-identical prefix of the card's full run
    (``card_outs``); and the same prefix through the card alone, whose
    statistics, report and summary must equal the CPU's. ``make_argv``
    (inputs, folder) -> (argv, outputs, report)."""
    prefixes = [
        write_prefix(path, PREFIX_RECORDS,
                     os.path.join(work, "{}_prefix.{}.fastq".format(tag, i)))
        for i, path in enumerate(inputs)
    ]
    runs = {}
    for device in ("cpu", "cuda"):
        folder = os.path.join(work, "{}_{}".format(tag, device))
        os.makedirs(folder)
        argv, outs, report = make_argv(prefixes, folder)
        seconds, counts, run, summary, stats_counts = run_trim_summary(argv, device)
        if device == "cpu":
            check(sum(counts.values()) == 0, counts)
        runs[device] = dict(seconds=seconds, run=run, outs=outs, report=report,
                            summary=summary, stats_counts=stats_counts)
    cpu, card = runs["cpu"], runs["cuda"]
    check(cpu["stats_counts"]["cuda"] == 0, cpu["stats_counts"])
    sizes = {}
    for cpu_out, card_prefix_out, card_out in zip(cpu["outs"], card["outs"], card_outs):
        if not os.path.exists(cpu_out):
            # a side file with no rows in the prefix is not written
            check(not os.path.exists(card_prefix_out), card_prefix_out)
            continue
        with open(cpu_out, "rb") as handle:
            cpu_bytes = handle.read()
        with open(card_out, "rb") as handle:
            card_prefix = handle.read(len(cpu_bytes))
        check(cpu_bytes == card_prefix, "CPU and GPU outputs differ: " + card_out)
        sizes[os.path.basename(card_out)] = len(cpu_bytes)
    for key in ("pre", "post", "trim"):
        check(_plain_json(cpu["summary"].get(key)) == _plain_json(card["summary"].get(key)),
              "{}: the card's and the CPU's '{}' differ on the prefix".format(tag, key))
    check(_report_sections(cpu["report"]) == _report_sections(card["report"]),
          tag + ": the card's and the CPU's reports differ on the prefix")
    if "pre" in card["summary"] or "post" in card["summary"]:
        check(card["stats_counts"]["cuda"] > 0, card["stats_counts"])
    for prefix in prefixes:
        os.remove(prefix)
    return {
        "records": PREFIX_RECORDS, "cpu_seconds": cpu["seconds"],
        "card_prefix_seconds": card["seconds"], "identical_prefix_bytes": sizes,
        "stats_counts_on_the_card_prefix": card["stats_counts"],
    }, runs


def count_records(path):
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as handle:
        return sum(chunk.count(b"\n") for chunk in iter(lambda: handle.read(1 << 24), b"")) // 4


def phase_se_side(work, seed, n_reads):
    """Demultiplexing by three named adapters with info, rest and wildcard
    files and pre- and post-trim statistics."""
    rng = np.random.default_rng([seed, 9])
    fastq = os.path.join(work, "side.fastq")
    began = time.perf_counter()
    kinds = write_side_fastq(fastq, rng, n_reads)
    made = time.perf_counter() - began

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
    seconds, counts, run, summary, stats_counts = run_trim_summary(argv, "cuda")
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
    cpu, runs = prefix_checks(make_argv, [fastq], outs, work, "se_side")
    os.remove(fastq)
    shutil.rmtree(folder, ignore_errors=True)
    return dict(
        argv="trim -a truseq=... -a nextera=... -a umi=... -se IN -o out.{name}.fastq "
             "--info-file -r --wildcard-file --stats both",
        reads=n_reads, read_length=150, make_input_seconds=made, seconds=seconds,
        reads_per_second=n_reads / seconds, batches=run["batches"], launches=counts,
        records_per_name=per_name, stats_counts=stats_counts,
        split_seconds=split_seconds(run),
        cpu_check=cpu,
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
    seconds, counts, run, summary, stats_counts = run_trim_summary(argv, "cuda")
    check(run["device"].startswith("cuda") and run["pairs"] == n_pairs, run)
    check(run["aligner"] == "insert", run)
    check(counts["diag_counts_u8"] == run["batches"] > 0, (counts, run))
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"], (counts, run))
    check(stats_counts["cuda"] > 0 and stats_counts["cpu"] == 0, stats_counts)
    pre = next(iter(summary["pre"].values()))
    check(pre["read1"]["counts"] == pre["read2"]["counts"] == n_pairs, "pre-trim statistics")
    cpu, _ = prefix_checks(make_argv, inputs, outs, work, "pe_side")
    shutil.rmtree(folder, ignore_errors=True)
    return dict(
        argv="trim --aligner insert -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p --stats both "
             "--info-file -r",
        pairs=n_pairs, seconds=seconds, pairs_per_second=n_pairs / seconds,
        batches=run["batches"], launches=counts, stats_counts=stats_counts,
        split_seconds=split_seconds(run), cpu_check=cpu,
    )


def phase_pe_overwrite(work, seed, n_pairs):
    """``-w 10,30,10`` with the adapter aligner on pairs of which a tenth
    have one mate with a low-quality 5' window."""
    rng = np.random.default_rng([seed, 10])
    inputs = [os.path.join(work, "ow.{}.fastq".format(i)) for i in (1, 2)]
    began = time.perf_counter()
    _, planted = write_pairs(*inputs, rng, n_pairs, 150, 220, 70, low_window=(0.1, 10))
    made = time.perf_counter() - began

    def make_argv(paths, folder):
        outs = [os.path.join(folder, "trimmed.{}.fastq".format(i)) for i in (1, 2)]
        report = os.path.join(folder, "report.txt")
        argv = pe_argv("adapter", *paths, *outs, folder, report, named=True)
        return argv + ["-w", "10,30,10"], outs, report

    folder = os.path.join(work, "pe_overwrite_card")
    os.makedirs(folder)
    argv, outs, _ = make_argv(inputs, folder)
    seconds, counts, run, _, _ = run_trim_summary(argv, "cuda")
    check(run["device"].startswith("cuda") and run["pairs"] == n_pairs, run)
    check(counts["dp_locate_word32"] == run["batches"] * run["device_aligners"] > 0, (counts, run))
    # every planted pair is replaced: both trimmed mates keep at least the
    # 40 bases of the shortest insert, more than the window
    check(run["overwritten_pairs"] >= planted > 0, (run["overwritten_pairs"], planted))
    cpu, runs = prefix_checks(make_argv, inputs, outs, work, "pe_overwrite")
    card_prefix = runs["cuda"]["run"]["overwritten_pairs"]
    cpu_prefix = runs["cpu"]["run"]["overwritten_pairs"]
    check(card_prefix == cpu_prefix > 0, (card_prefix, cpu_prefix))
    for path in inputs:
        os.remove(path)
    shutil.rmtree(folder, ignore_errors=True)
    return dict(
        argv="trim --aligner adapter -a TRUSEQ -A TRUSEQ2 -pe1 -pe2 -o -p -w 10,30,10",
        pairs=n_pairs, make_input_seconds=made, seconds=seconds,
        pairs_per_second=n_pairs / seconds, batches=run["batches"], launches=counts,
        planted_low_windows=planted, overwritten_pairs=run["overwritten_pairs"],
        overwritten_pairs_in_prefix=cpu_prefix, split_seconds=split_seconds(run),
        cpu_check=cpu,
    )


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
]


def phase_goldens(work):
    """The single-end cases above, and every paired-end case of the ported
    slice (the table of ``tests/test_torch_goldens_pe.py``, both aligners,
    and interleaved input and output), on the card."""
    import pathlib

    sys.path.insert(0, ROOT)
    from tests.test_torch_goldens_pe import PORTED, SIDE_OUTPUTS, _argv

    conformance = os.path.join(ROOT, "tests", "conformance")
    launches = 0
    runs = []  # (argv, [(written, golden)])
    for params, expected, inpath, side in GOLDENS:
        out = os.path.join(work, "golden_" + expected)
        compared = [(os.path.join(work, written), golden) for written, golden in side]
        if "{name}" not in expected:
            compared.append((out, expected))
        runs.append((["trim"] + params.replace("{work}", work).split() + [
            "-se", os.path.join(conformance, "data", inpath), "-o", out,
        ], compared))
    for i, (name, aligner, params, in1, in2, exp1, exp2) in enumerate(PORTED):
        case_dir = pathlib.Path(work) / "pe{}".format(i)
        case_dir.mkdir()
        argv, out1, out2 = _argv(params, aligner, in1, in2, exp1, exp2, case_dir)
        pairs = [(out1, exp1), (out2, exp2)] + [
            (str(case_dir / written), golden) for written, golden in SIDE_OUTPUTS.get(name, ())
        ]
        runs.append((["trim"] + argv, [
            (path, golden.format(aligner=aligner)) for path, golden in pairs
        ]))
    for aligner in ("adapter", "insert"):
        out = os.path.join(work, "interleaved_{}.fastq".format(aligner))
        runs.append((["trim"] + "-q 20 -a TTAGACATAT -A CAGTGGAGTA -m 14 -M 90".split() + [
            "--aligner", aligner, "-l", os.path.join(conformance, "data", "interleaved.fastq"),
            "-L", out,
        ], [(out, "interleaved.fastq")]))
    for argv, outputs in runs:
        argv = argv + ["--quiet", "--no-cache-adapters",
                       "--report-file", os.path.join(work, "report3.txt")]
        _, counts, _ = run_trim(argv, "cuda")
        launches += sum(counts.values())
        for path, golden in outputs:
            with open(path, "rb") as got, open(
                os.path.join(conformance, "expected", golden), "rb"
            ) as want:
                if got.read() != want.read():
                    raise AssertionError("golden case differs on the card: {}".format(argv))
    check(launches >= len(runs), 'launches >= len(runs)')
    emit({"goldens": {"single_end_cases": len(GOLDENS),
                      "paired_end_cases": len(runs) - len(GOLDENS),
                      "identical": len(runs), "launches": launches}})


# -- main --------------------------------------------------------------------------


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False\n")
        sys.exit(1)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=20240229)
    parser.add_argument("--reads", type=int, default=2000000,
                        help="reads of the main path's input")
    parser.add_argument("--main-path-runs", type=int, default=1,
                        help="times the main path's command is run (the "
                             "first run is the one checked and reported)")
    args = parser.parse_args()
    began = time.perf_counter()

    card = timing.smi("name,power.limit")
    emit({"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "sm_clock_max": timing.smi("clocks.max.sm")})
    phase_build()
    max_err, global_column = phase_grid(args.seed)
    max_err.update(phase_diag_grid(args.seed))

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
        step["dp_kernel_queued_ms"] = word32_time["queued_ms"]
        emit({"device_step_at_main_path_shape": step})
        os.remove(fastq)
        wide_launches, wide_time = phase_long_path(work, args.seed)

        # 2x150 pairs: the insert aligner (diag_counts_u8), then the adapter
        # aligner on the same files
        pe, inputs = phase_pe_insert(
            work, args.seed, PAIRS, 150, 220, diag_counts_u8, poly_a=(40000, 43000),
        )
        pair, kernel, step_args = pair_step_inputs(inputs, work, 150)
        check(kernel is diag_counts_u8, kernel.name)
        pe["pair_step"], u8_inputs = time_pair_step(pair, kernel, step_args)
        emit({"pe_insert_path": pe})
        u8_launches = pe["launches"]["diag_counts_u8"]
        u8_time = time_diag(diag_counts_u8, *u8_inputs)
        emit({"pe_adapter_path": phase_pe_adapter(work, inputs, PAIRS)})
        emit({"pe_side_path": phase_pe_side(work, inputs, PAIRS)})
        for path in inputs:
            os.remove(path)
        emit({"pe_overwrite_path": phase_pe_overwrite(work, args.seed, PAIRS)})

        # 2x300 pairs (MiSeq v3): the window exceeds 255, diag_counts_i32
        wide_pe, wide_inputs = phase_pe_insert(
            work, args.seed, WIDE_PAIRS, 300, 400, diag_counts_i32, poly_a=(0, 0),
        )
        pair, kernel, step_args = pair_step_inputs(wide_inputs, work, 300)
        check(kernel is diag_counts_i32, kernel.name)
        wide_pe["pair_step"], i32_inputs = time_pair_step(pair, kernel, step_args)
        emit({"pe_insert_wide_path": wide_pe})
        i32_launches = wide_pe["launches"]["diag_counts_i32"]
        i32_time = time_diag(diag_counts_i32, *i32_inputs)
        for path in wide_inputs:
            os.remove(path)
        emit({"se_side_path": phase_se_side(work, args.seed, SIDE_READS)})
        probe_err, probe_launches, probe_times = phase_dtype_probe(args.seed)
        max_err.update(probe_err)
        phase_goldens(work)
    finally:
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
        entry.update(measured)
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
