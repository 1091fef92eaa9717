"""Time the dtype probe's kernels of this tree against another tree's, on
one card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python -m cuda_tools.probe_compare --parent DIR
        [--constants PROBE16_THREADS=32,PAIR_LANES=1+PROBE16_THREADS=128]

``DIR`` holds the ``atropos_tpu_torch`` package of another tree, for
example a parent commit unpacked with ``git archive PARENT
atropos_tpu_torch | tar -x -C DIR``. The tool

1. writes the reads ``chip_smoke.py`` times the probe on (same seed, same
   generator: bytes 0-3 at each shape of ``dtype_probe.SHAPES``, the TPU
   tool's L = 104, N = 16,384 and the main path's L = 160, N = 32,768);
2. times ``dtype_probe_i32`` and ``dtype_probe_i16x2`` at both shapes,
   the query byte moving (``dyn``) and fixed, in four processes taken in
   turns: the other tree, this tree, this tree, the other tree. Each
   process imports the package of its tree, builds the kernels from that
   tree's sources, and times each run with
   :func:`cuda_tools.timing.device_times`, as ``chip_smoke.py`` does: the
   median of 20 launches each between two events (``ms``, the wrapper's
   host work included) and 20 launches queued behind a device sleep
   (``queued_ms``, the kernel alone). Every timed output must equal the
   plain version's (that tree's ``probe_columns``, on the card). With
   ``--constants``, copies of this tree whose ``csrc/dtype_probe.cu`` sets
   a constant otherwise (``PROBE16_THREADS``, the 16-bit kernel's block
   width; ``PAIR_LANES``, the lanes that split a read pair's rows; ``+``
   joins settings of one copy) are timed as well, between this tree's two
   runs and in both orders, each checked like this tree;
3. prints one JSON line: the card's name and power limit, and per run
   (kernel, shape, dyn) the times of each process and the ratios of this
   tree's (and each copy's) mean times to the other tree's.
"""
import argparse
import json
import os
import sys

import numpy as np

from cuda_tools import timing

ROOT = timing.ROOT
LAUNCHES = 20
SEED = 20240229  # chip_smoke.py's default --seed: the same reads
TIMES = ("ms", "queued_ms")
SOURCE = os.path.join("atropos_tpu_torch", "csrc", "dtype_probe.cu")


def run_name(kernel, L, N, dyn):
    """A run's name: ``KERNEL/L=..,N=../dyn`` (or ``/nodyn``)."""
    return "{}/L={},N={}/{}".format(kernel, L, N, "dyn" if dyn else "nodyn")


def make_reads(path, seed):
    """The reads of every shape (see the module docstring) into ``path``
    (npz); returns the shapes."""
    sys.path.insert(0, ROOT)
    from atropos_tpu_torch.tools import dtype_probe

    arrays = {
        "L={},N={}".format(L, N): dtype_probe.make_reads([seed, 12, L], L, N, 4).numpy()
        for L, N in dtype_probe.SHAPES
    }
    np.savez(path, **arrays)
    return [list(shape) for shape in dtype_probe.SHAPES]


def time_runs(root, path, shapes):
    """Times of ``root``'s probe kernels on the reads of ``path``, each
    output held to that tree's plain version."""
    sys.path.insert(0, root)
    import torch

    from atropos_tpu_torch.tools import dtype_probe

    package = os.path.dirname(os.path.dirname(os.path.abspath(dtype_probe.__file__)))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError("imported {}, not the tree under {}".format(package, root))
    device = torch.device("cuda", 0)
    clock_mhz = float(timing.smi("clocks.max.sm").split()[0])
    data = np.load(path)
    result = {}
    for L, N in shapes:
        reads = torch.from_numpy(data["L={},N={}".format(L, N)]).to(device)
        for dyn in (True, False):
            expected = dtype_probe.probe_columns(reads, torch.int32, dyn)
            for kernel in dtype_probe.KERNELS:
                name = run_name(kernel.name, L, N, dyn)
                times, out = timing.device_times(lambda: kernel(reads, dyn), LAUNCHES,
                                                 clock_mhz)
                if not torch.equal(out, expected):
                    raise AssertionError("{}: {} differs from the plain version".format(
                        root, name))
                result[name] = times
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of the other tree")
    parser.add_argument("--constants", default="",
                        help="comma-separated NAME=VALUE[+NAME=VALUE] settings of "
                             "csrc/dtype_probe.cu's constants, each timed as a copy")
    parser.add_argument("--make", help=argparse.SUPPRESS)
    parser.add_argument("--time", nargs=2, metavar=("ROOT", "READS"), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.make:
        shapes = make_reads(args.make, SEED)
        with open(args.make + ".json", "w") as handle:
            json.dump(shapes, handle)
        print(json.dumps(shapes))
        return 0
    if args.time:
        with open(args.time[1] + ".json") as handle:
            shapes = json.load(handle)
        print(json.dumps(time_runs(args.time[0], args.time[1], shapes)))
        return 0
    if not args.parent:
        parser.error("--parent is required")
    card = timing.smi("name,power.limit")
    settings = [c for c in args.constants.split(",") if c]
    shapes, order, runs = timing.compare_session(
        "cuda_tools.probe_compare", args.parent,
        lambda work: ["--make", os.path.join(work, "reads.npz")],
        lambda work, label, root: ["--time", root, os.path.join(work, "reads.npz")],
        lambda work: {s: timing.constant_variant(work, SOURCE, s) for s in settings},
    )
    report = {"device": card, "launches": LAUNCHES, "order": order, "runs": []}
    for L, N in shapes:
        for kernel in ("dtype_probe_i32", "dtype_probe_i16x2"):
            for dyn in (True, False):
                name = run_name(kernel, L, N, dyn)
                entry = dict(name=name, kernel=kernel, shape="L={},N={}".format(L, N),
                             dyn=dyn)
                entry.update(timing.turn_times(name, runs, TIMES))
                report["runs"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
