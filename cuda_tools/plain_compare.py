"""Hold this tree's plain DP against another tree's on ``chip_smoke.py``'s
grid of configurations.

Run from the root of a checkout; no card is needed::

    python -m cuda_tools.plain_compare --parent DIR [--reads 64] [--device cpu]

``DIR`` holds the ``atropos_tpu_torch`` package of another tree, for
example a parent commit unpacked with ``git archive PARENT
atropos_tpu_torch | tar -x -C DIR``. The plain version
(``align/batched.py::_locate_kernel``) is what ``chip_smoke.py`` and the
card tests hold both DP kernels against, so a change to it is checked here
on its own. The tool

1. writes the batch of every configuration of ``chip_smoke.grid_configs``
   (same seed, same generators) as the kernels see it, cut to its first
   ``--reads`` reads: a read's result depends on that read alone;
2. runs each tree's ``_locate_kernel`` on every batch, the two trees in two
   processes at once, each importing the package of its tree;
3. prints one JSON line: per configuration its shape, whether the two
   ``[8, B]`` results are equal, and each tree's seconds. It exits 1 if any
   result differs.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20240229  # chip_smoke.py's default --seed: the same batches


def make_batches(path, seed, reads, device):
    """Every grid configuration's batch, cut to ``reads`` reads, into
    ``path`` (npz); returns the configurations' shapes."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from atropos_tpu_torch.align.cuda_kernel import CudaAligner

    arrays, shapes = {}, []
    for cfg in smoke.grid_configs():
        rng = np.random.default_rng([seed, 1, cfg["idx"]])
        adapter = smoke.make_adapter(rng, cfg["m"], cfg["iupac"])
        aligner = CudaAligner(
            adapter, cfg["e"], cfg["flags"], wildcard_ref=cfg["iupac"],
            min_overlap=3, indel_cost=cfg["indel_cost"], device=device,
        )
        batch, lengths = smoke.random_batch(rng, cfg["B"], cfg["L"], adapter, cfg["place"])
        dev = torch.from_numpy(batch[:reads]).to(device)
        if not aligner._compare_ascii:
            dev = aligner.query_lut[dev.long()]
        name = "grid{}".format(cfg["idx"])
        arrays.update({
            name + "/reads_T": dev.T.contiguous().cpu().numpy(),
            name + "/lens": lengths[None, :reads],
            name + "/ref": aligner.ref_bytes.cpu().numpy(),
            name + "/thr": aligner.thresholds.cpu().numpy(),
        })
        params = aligner._dp_params()
        shapes.append(dict(name=name, L=cfg["L"], B=min(reads, cfg["B"]), **params))
    arrays["params"] = np.array(json.dumps({s.pop("name"): s for s in shapes}))
    np.savez(path, **arrays)


def run_tree(root, path, out, device):
    """``root``'s plain version on every batch of ``path``: the results
    into ``out`` (npz), the seconds of each batch printed as JSON."""
    sys.path.insert(0, root)
    import torch

    from atropos_tpu_torch.align import batched

    package = os.path.dirname(os.path.dirname(os.path.abspath(batched.__file__)))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError("imported {}, not the tree under {}".format(package, root))
    torch.set_num_threads(1)
    data = np.load(path)
    params = json.loads(str(data["params"]))
    results, seconds = {}, {}
    for name, p in params.items():
        args = [torch.from_numpy(data[name + "/" + part]).to(device)
                for part in ("reads_T", "lens", "ref", "thr")]
        kwargs = {key: p[key] for key in (
            "m", "k", "flags", "min_overlap", "ins_cost", "del_cost", "compare_ascii")}
        began = time.perf_counter()
        results[name] = batched._locate_kernel(*args, **kwargs).cpu().numpy()
        seconds[name] = time.perf_counter() - began
    np.savez(out, **results)
    print(json.dumps(seconds))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="root of the other tree")
    parser.add_argument("--reads", type=int, default=64,
                        help="reads of each configuration's batch to keep")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--run", nargs=3, metavar=("ROOT", "BATCHES", "OUT"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.run:
        run_tree(*args.run, args.device)
        return 0
    with tempfile.TemporaryDirectory() as work:
        batches = os.path.join(work, "batches.npz")
        make_batches(batches, SEED, args.reads, args.device)
        roots = {"parent": os.path.abspath(args.parent), "this": ROOT}
        children = {
            label: subprocess.Popen(
                [sys.executable, "-m", "cuda_tools.plain_compare", "--parent", roots["parent"],
                 "--device", args.device, "--run", root, batches,
                 os.path.join(work, label + ".npz")],
                cwd=ROOT, stdout=subprocess.PIPE, text=True)
            for label, root in roots.items()
        }
        seconds = {}
        for label, child in children.items():
            stdout, _ = child.communicate()
            if child.returncode != 0:
                raise RuntimeError("{} tree failed".format(label))
            seconds[label] = json.loads(stdout.strip().splitlines()[-1])
        params = json.loads(str(np.load(batches)["params"]))
        got = {label: np.load(os.path.join(work, label + ".npz")) for label in roots}
        report = []
        for name, p in params.items():
            report.append(dict(
                name=name, **{key: p[key] for key in ("m", "k", "L", "B", "ins_cost")},
                equal=bool(np.array_equal(got["parent"][name], got["this"][name])),
                parent_seconds=seconds["parent"][name], this_seconds=seconds["this"][name],
            ))
    differ = [r["name"] for r in report if not r["equal"]]
    print(json.dumps({"configurations": len(report), "differ": differ,
                      "reads": args.reads, "device": args.device, "batches": report}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
