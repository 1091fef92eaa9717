"""Time a DP kernel of this tree against another tree's, on one card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python -m cuda_tools.dp_compare --parent DIR [--kernel dp_locate_wide]
        [--threads 32,64,128] [--row-caps 64 | --row-caps 0,28]

``DIR`` holds the ``atropos_tpu_torch`` package of another tree, for
example a parent commit unpacked with ``git archive PARENT
atropos_tpu_torch | tar -x -C DIR``. The tool

1. writes the batches of ``chip_smoke.py`` (same seed, same generators),
   with the plain version's result of each. For ``dp_locate_word32`` (the
   default): the main path's first batch as the kernel sees it (TruSeq,
   m = 33, k = 3, L = 160, B = 32,768) and every grid configuration that
   this tree serves from its register column. For ``dp_locate_wide``: the
   long path's batch (m = 880, k = 264, L = 7,328, B = 1,024) as "main",
   and every grid configuration that ``chip_smoke.py`` hands this kernel;
2. times the kernel on each batch in four processes, in turns:
   the other tree, this tree, this tree, the other tree. Each process
   imports the package of its tree and builds the kernels from that tree's
   sources, and times each batch with :func:`cuda_tools.timing.device_times`,
   as ``chip_smoke.py`` times every kernel: the median of 20 launches each
   between two events (``ms``, the wrapper's host work included), and 20
   launches queued behind a device sleep (``queued_ms``, the kernel alone);
   5 of each for a batch whose first launch takes more than 50 ms.
   Every timed launch's last result must equal the plain version's. With
   ``--threads``, this tree's processes also time the main batch at each of
   those block widths of its instantiation; with ``--row-caps``, every
   batch at each of those row caps that holds its adapter, other than the
   one the shape is served with: for ``dp_locate_word32`` the register
   batches; for ``dp_locate_wide`` 0 times one read a thread (shared or
   global column) and ``STRIP_ROWS`` the strips, on every batch they hold
   (:meth:`_DpKernel.launch` with the instantiation named);
3. prints one JSON line: the card's name and power limit, and per batch
   its shape, the instantiation this tree serves it with, and both times of
   each of the four runs.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

from cuda_tools import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = 20
#: launches of a batch whose first launch takes more than SLOW_MS
SLOW_LAUNCHES, SLOW_MS = 5, 50.0
SEED = 20240229  # chip_smoke.py's default --seed: the same batches
TIMES = ("ms", "queued_ms")


def make_batches(path, seed, kernel_name):
    """The batches of ``kernel_name``, as ``chip_smoke.py`` builds them,
    into ``path`` (npz)."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from atropos_tpu_torch.align import cuda_kernel
    from atropos_tpu_torch.align.cuda_kernel import CudaAligner, dp_locate_word32

    kernel = getattr(cuda_kernel, kernel_name)
    arrays, shapes = {}, []

    def add(name, aligner, reads_T, lens):
        params = aligner._dp_params()
        expected = kernel.plain(
            reads_T, lens, aligner.ref_bytes, aligner.thresholds, **params
        )
        L, B = reads_T.shape
        how = kernel.instantiation(aligner.m, aligner.k, L)
        arrays.update({
            name + "/reads_T": reads_T.cpu().numpy(),
            name + "/lens": lens.cpu().numpy(),
            name + "/ref": aligner.ref_bytes.cpu().numpy(),
            name + "/thr": aligner.thresholds.cpu().numpy(),
            name + "/expected": expected.cpu().numpy(),
        })
        shapes.append(dict(name=name, params=params, L=L, B=B,
                           instantiation=how._asdict()))

    with tempfile.TemporaryDirectory() as work:
        if kernel is dp_locate_word32:
            fastq = os.path.join(work, "reads.fastq")
            # one chunk of the generator: the main path's first 250,000 reads
            smoke.write_truseq_fastq(fastq, np.random.default_rng([seed, 2]), 250000)
            reads, lengths = smoke.truseq_batch(fastq)
            truseq = CudaAligner(smoke.TRUSEQ, 0.1, smoke.BACK, min_overlap=3,
                                 device=smoke.DEVICE)
            add("main", truseq, *smoke.device_inputs(truseq, reads, lengths))
        else:
            fasta = os.path.join(work, "long.fasta")
            vector, _, _ = smoke.write_long_fasta(fasta, seed)
            add("main", *smoke.long_batch(fasta, vector))
    for cfg in smoke.grid_configs():
        rng = np.random.default_rng([seed, 1, cfg["idx"]])
        adapter = smoke.make_adapter(rng, cfg["m"], cfg["iupac"])
        aligner = CudaAligner(
            adapter, cfg["e"], cfg["flags"], wildcard_ref=cfg["iupac"],
            min_overlap=3, indel_cost=cfg["indel_cost"], device=smoke.DEVICE,
        )
        fits32 = dp_locate_word32.fits(cfg["m"], aligner.k, cfg["L"])
        if kernel is dp_locate_word32:
            if not fits32 or dp_locate_word32.instantiation(
                    cfg["m"], aligner.k, cfg["L"]).kind != "registers":
                continue
        elif fits32 and cfg["idx"] % 3:
            continue  # phase_grid hands these to dp_locate_word32 alone
        reads, lengths = smoke.random_batch(rng, cfg["B"], cfg["L"], adapter, cfg["place"])
        add("grid{}".format(cfg["idx"]), aligner, *smoke.device_inputs(aligner, reads, lengths))
    torch.cuda.synchronize()
    arrays["params"] = np.array(json.dumps({s["name"]: s["params"] for s in shapes}))
    np.savez(path, **arrays)
    return shapes


def time_batches(root, path, kernel_name, threads, row_caps):
    """Times of ``root``'s ``kernel_name`` on every batch of ``path``;
    with ``threads``, also the main batch at each of those block widths,
    and with ``row_caps``, every batch at each of those row caps that holds
    it, other than its own."""
    sys.path.insert(0, root)
    import torch

    from atropos_tpu_torch.align import cuda_kernel
    from cuda_tools.timing import device_times

    package = os.path.dirname(os.path.dirname(os.path.abspath(cuda_kernel.__file__)))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError("imported {}, not the tree under {}".format(package, root))
    device = torch.device("cuda", 0)
    clock_mhz = float(timing.smi("clocks.max.sm").split()[0])
    data = np.load(path)
    names = sorted({key.split("/")[0] for key in data.files} - {"params"})
    params = json.loads(str(data["params"]))
    kernel = getattr(cuda_kernel, kernel_name)

    def timed(name, how=None):
        args = [torch.from_numpy(data[name + "/" + part]).to(device)
                for part in ("reads_T", "lens", "ref", "thr")]
        expected = torch.from_numpy(data[name + "/expected"]).to(device)
        if how is None:
            def call():
                return kernel(*args, **params[name])
        else:
            def call():
                return kernel.launch(*args, how, **params[name])
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        stop.record()
        torch.cuda.synchronize()
        launches = SLOW_LAUNCHES if start.elapsed_time(stop) > SLOW_MS else LAUNCHES
        times, out = device_times(call, launches, clock_mhz)
        times["launches"] = launches
        if not torch.equal(out, expected):
            raise AssertionError("{}: {} differs from the plain version".format(root, name))
        return times

    result = {name: timed(name) for name in names}
    if not (threads or row_caps):
        return result
    for name in names:
        p = params[name]
        L = data[name + "/reads_T"].shape[0]
        how = kernel.instantiation(p["m"], p["k"], L)
        if name == "main":
            for count in threads:
                result["main@{}".format(count)] = timed(name, how._replace(threads=count))
        for cap in row_caps:
            if how.kind == "registers":
                other = how._replace(row_cap=cap) if p["m"] + 1 <= cap else how
            elif cap == cuda_kernel.STRIP_ROWS and kernel.holds_strips(p["m"], p["k"], L):
                other = cuda_kernel.Instantiation("warps", cap, cuda_kernel.STRIP_THREADS)
            elif cap == 0 and kernel.word_bits == 64:
                width, global_col = kernel.block_layout(p["m"])
                other = cuda_kernel.Instantiation(
                    "global" if global_col else "shared", 0, width)
            else:
                other = how
            if other != how:
                result["{}@rows{}".format(name, cap)] = timed(name, other)
    return result


def run_child(argv):
    return timing.run_child("cuda_tools.dp_compare", argv, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of the other tree")
    parser.add_argument("--kernel", default="dp_locate_word32",
                        choices=("dp_locate_word32", "dp_locate_wide"))
    parser.add_argument("--threads", default="",
                        help="comma-separated block widths to time on the main batch")
    parser.add_argument("--row-caps", default="",
                        help="comma-separated row caps to time every batch at")
    parser.add_argument("--make", help=argparse.SUPPRESS)
    parser.add_argument("--time", nargs=2, metavar=("ROOT", "BATCHES"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    threads = [int(t) for t in args.threads.split(",") if t]
    row_caps = [int(c) for c in args.row_caps.split(",") if c]
    if args.make:
        print(json.dumps(make_batches(args.make, SEED, args.kernel)))
        return 0
    if args.time:
        print(json.dumps(time_batches(args.time[0], args.time[1], args.kernel, threads,
                                      row_caps)))
        return 0
    if not args.parent:
        parser.error("--parent is required")
    card = timing.smi("name,power.limit")
    with tempfile.TemporaryDirectory() as work:
        batches = os.path.join(work, "batches.npz")
        shapes = run_child(["--make", batches, "--kernel", args.kernel])
        runs = []
        for label in ("parent", "this", "this", "parent"):
            root = os.path.abspath(args.parent) if label == "parent" else ROOT
            extra = ["--kernel", args.kernel]
            if label == "this":
                extra += ["--threads", args.threads, "--row-caps", args.row_caps]
            runs.append((label, run_child(["--time", root, batches] + extra)))
    report = {"device": card, "kernel": args.kernel, "launches": LAUNCHES, "batches": []}
    this_runs = [r for label, r in runs if label == "this"]
    for shape in shapes:
        name = shape["name"]
        entry = dict(shape)
        for key in TIMES:
            for label in ("parent", "this"):
                entry["{}_{}".format(label, key)] = [
                    r[name][key] for run_label, r in runs if run_label == label
                ]
            entry["ratio_" + key] = float(
                np.mean(entry["this_" + key]) / np.mean(entry["parent_" + key])
            )
        entry["this_host_ms"] = [r[name]["host_ms"] for r in this_runs]
        entry["parent_host_ms"] = [r[name]["host_ms"] for label, r in runs if label == "parent"]
        for cap in row_caps:
            key = "{}@rows{}".format(name, cap)
            if key in this_runs[0]:
                entry["rows{}".format(cap)] = {t: [r[key][t] for r in this_runs] for t in TIMES}
        report["batches"].append(entry)
    if threads:
        report["threads"] = {
            str(count): {t: [r["main@{}".format(count)][t] for r in this_runs] for t in TIMES}
            for count in threads
        }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
