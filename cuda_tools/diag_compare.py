"""Time the diagonal-count kernels of this tree against another tree's, on
one card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card::

    python -m cuda_tools.diag_compare --parent DIR
        [--constants PAIR_LANES=8,PAIR_LANES=32,QWORDS=4] [--stage-pack]

``DIR`` holds the ``atropos_tpu_torch`` package of another tree, for
example a parent commit unpacked with ``git archive PARENT
atropos_tpu_torch | tar -x -C DIR``. The tool

1. writes the batches of ``chip_smoke.py`` (same seed, same generators):
   the first pair batch of pe_insert_path (2x150, ``diag_counts_u8``) and
   of pe_insert_wide_path (2x300, ``diag_counts_i32``) as the fused pair
   step hands them to its counts kernel (``chip_smoke.py::pair_step_inputs``),
   and every configuration of ``chip_smoke.py::DIAG_GRID``;
2. times each batch's kernel in four processes, in turns: the other tree,
   this tree, this tree, the other tree. Each process imports the package
   of its tree, builds the kernels from that tree's sources, and times each
   batch with :func:`cuda_tools.timing.device_times`, as ``chip_smoke.py``
   does: the median of 20 launches each between two events (``ms``, the
   wrapper's host work included) and 20 launches queued behind a device
   sleep (``queued_ms``, the kernel alone). Every timed result must equal
   the plain version's (that tree's, on the card). With ``--constants``,
   copies of this tree whose ``csrc/diag_counts.cu`` sets one constant
   otherwise (``PAIR_LANES``, the lanes that split a pair's diagonals;
   ``QWORDS``, the query words a lane keeps in registers; ``WARPS``, a
   block's warps; ``MIN_BLOCKS``, the blocks an SM must hold, which caps
   the registers; ``+`` joins settings of one copy) are timed as well,
   between this tree's two runs and in both orders, each checked like this
   tree; with ``--stage-pack``, a copy whose count phase is cut out (stage,
   pack and write only; its output is not checked) times what packing
   costs;
3. prints one JSON line: the card's name and power limit, and per batch
   its shape, kernel, the times of each run and the ratios of this tree's
   mean times to the other tree's.
"""
import argparse
import json
import os
import re
import sys
import tempfile

import numpy as np

from cuda_tools import timing

ROOT = timing.ROOT
LAUNCHES = 20
SEED = 20240229  # chip_smoke.py's default --seed: the same batches
TIMES = ("ms", "queued_ms")
SOURCE = os.path.join("atropos_tpu_torch", "csrc", "diag_counts.cu")
#: the count phase of diag_body, which --stage-pack cuts out (the counts
#: tile keeps the zeros the first step writes)
COUNT_CALL = re.compile(r"count_pair<Out>\(q4, [^;]*\);")
NO_COUNT = "/* count cut */"


def make_batches(path, seed):
    """The batches (see the module docstring) into ``path`` (npz); returns
    their shapes."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke

    arrays, shapes = {}, []

    def add(name, kernel, ref_T, query_T, m_col, detail):
        W, B = query_T.shape
        arrays.update({
            name + "/ref": ref_T.cpu().numpy(),
            name + "/query": query_T.cpu().numpy(),
            name + "/m": m_col.reshape(-1).cpu().numpy(),
        })
        shapes.append(dict(name=name, kernel=kernel.name, W=W, B=B, **detail))

    with tempfile.TemporaryDirectory() as work:
        for name, n_pairs, read_len, mean, poly_a in (
            ("pe_insert_path", smoke.PAIRS, 150, 220, (40000, 43000)),
            ("pe_insert_wide_path", smoke.WIDE_PAIRS, 300, 400, (0, 0)),
        ):
            # as phase_pe_insert writes them: the first batch depends on
            # every insert length drawn, so the whole input is written
            rng = np.random.default_rng([seed, 6, read_len])
            inputs = [os.path.join(work, "pairs{}.{}.fastq".format(read_len, i))
                      for i in (1, 2)]
            smoke.write_pairs(*inputs, rng, n_pairs, read_len, mean, 70, poly_a)
            pair, kernel, step_args = smoke.pair_step_inputs(inputs, work, read_len)
            _, _, m_col, ref_plane, query_plane = pair._planes(*step_args)
            add(name, kernel, ref_plane.T.contiguous(), query_plane.T.contiguous(),
                m_col, dict(source="first pair batch"))
            for path_ in inputs:
                os.remove(path_)
    for idx, (kernel, W, alphabet, lengths, B) in enumerate(smoke.DIAG_GRID):
        rng = np.random.default_rng([seed, 5, idx])
        ref_T, query_T, m_col = smoke.diag_batch(rng, W, B, alphabet, lengths)
        add("grid{}".format(idx), kernel, ref_T, query_T, m_col,
            dict(source="DIAG_GRID", symbols=len(alphabet), lengths=lengths))
    torch.cuda.synchronize()
    np.savez(path, **arrays)
    return shapes


def time_batches(root, path, shapes, check=True):
    """Times of ``root``'s kernels on every batch of ``path``."""
    sys.path.insert(0, root)
    import torch

    from atropos_tpu_torch.align import insert_kernel
    from cuda_tools.timing import device_times

    package = os.path.dirname(os.path.dirname(os.path.abspath(insert_kernel.__file__)))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError("imported {}, not the tree under {}".format(package, root))
    device = torch.device("cuda", 0)
    clock_mhz = float(timing.smi("clocks.max.sm").split()[0])
    data = np.load(path)
    result = {}
    for shape in shapes:
        name = shape["name"]
        kernel = getattr(insert_kernel, shape["kernel"])
        args = [torch.from_numpy(data[name + "/" + part]).to(device)
                for part in ("ref", "query", "m")]
        times, out = device_times(lambda: kernel(*args), LAUNCHES, clock_mhz)
        if check and not torch.equal(out, kernel.plain(*args)):
            raise AssertionError("{}: {} differs from the plain version".format(root, name))
        result[name] = times
    return result


def stage_pack_variant(work):
    return timing.source_variant(work, "stage_pack", SOURCE,
                                 lambda text: COUNT_CALL.sub(NO_COUNT, text, count=1))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of the other tree")
    parser.add_argument("--constants", default="",
                        help="comma-separated NAME=VALUE settings of csrc/diag_counts.cu's "
                             "constants (PAIR_LANES=8, QWORDS=4, ...), each timed as a copy")
    parser.add_argument("--stage-pack", action="store_true",
                        help="also time the kernels without their count phase")
    parser.add_argument("--make", help=argparse.SUPPRESS)
    parser.add_argument("--time", nargs=2, metavar=("ROOT", "BATCHES"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--unchecked", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.make:
        shapes = make_batches(args.make, SEED)
        with open(args.make + ".json", "w") as handle:
            json.dump(shapes, handle)
        print(json.dumps(shapes))
        return 0
    if args.time:
        with open(args.time[1] + ".json") as handle:
            shapes = json.load(handle)
        print(json.dumps(time_batches(args.time[0], args.time[1], shapes,
                                      check=not args.unchecked)))
        return 0
    if not args.parent:
        parser.error("--parent is required")
    card = timing.smi("name,power.limit")
    settings = [c for c in args.constants.split(",") if c]

    def variants(work):
        roots = {s: timing.constant_variant(work, SOURCE, s) for s in settings}
        if args.stage_pack:
            roots["stage_pack"] = stage_pack_variant(work)
        return roots

    def time_argv(work, label, root):
        extra = ["--unchecked"] if label == "stage_pack" else []
        return ["--time", root, os.path.join(work, "batches.npz")] + extra

    shapes, order, runs = timing.compare_session(
        "cuda_tools.diag_compare", args.parent,
        lambda work: ["--make", os.path.join(work, "batches.npz")], time_argv, variants)
    report = {"device": card, "launches": LAUNCHES, "order": order, "batches": []}
    for shape in shapes:
        entry = dict(shape)
        entry.update(timing.turn_times(shape["name"], runs, TIMES))
        report["batches"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
