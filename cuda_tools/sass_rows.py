"""Count the instructions of one row of ``dp_body_reg``'s column loop, and
of a row of ``dp_body_warp``'s strips.

Run from the root of a checkout on a machine with the CUDA toolkit, after
the DP kernels were built::

    python -m cuda_tools.sass_rows [--row-cap 48]

``chip_smoke.py`` runs :func:`row_instructions` on the library it has just
built, for every row cap, and bounds the register instantiations by
``ops_per_row``; and :func:`strip_row_instructions`, whose count it
reports beside the strips' bound.

It disassembles ``build/libdp_align.so`` with ``cuobjdump -sass`` (or
reads a saved listing given with ``--sass FILE``), takes the register
instantiation of ``--row-cap`` rows, and finds its row groups: the column
loop's unrolled rows go in groups of ``RowGroup<R>`` rows, and before each
group the warp branches to one place past the rows when the group lies
below every read's band. The instructions from one such branch to the
next are one group; their median count over the loop, divided by the
group's rows, is the instructions a row takes (the group's share of the
branch included). Prints one JSON line with that count, the group size,
the counts of the groups, and how many of a group's instructions are
register moves (``MOV``, ``IMAD.MOV``): the moves ptxas adds to rotate the
unrolled column are no work of the cell rule, so ``ops_per_row`` counts a
row's instructions without them.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

from atropos_tpu_torch.align import _build, cuda_kernel

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"^(@!?U?P\w+\s+)?BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def group_rows(row_cap):
    """Rows a group holds in the ``row_cap`` instantiation: the value of
    ``RowGroup<R>`` in csrc/dp_align.cu, read from the source."""
    with open(os.path.join(_build.CSRC_DIR, "dp_align.cu")) as handle:
        source = handle.read()
    match = re.search(
        r"RowGroup \{ static constexpr int value = R <= (\d+) \? (\d+) : (\d+); \}", source
    )
    small_cap, small, large = (int(v) for v in match.groups())
    return small if row_cap <= small_cap else large


def functions(listing):
    """{mangled name: [(address, instruction)]} of a cuobjdump listing."""
    out = {}
    for block in re.split(r"\n\s+Function : ", listing)[1:]:
        name, body = block.split("\n", 1)
        out[name.strip()] = [(int(a, 16), text) for a, text in _INSN.findall(body)]
    return out


def row_instructions(listing, row_cap):
    rows = group_rows(row_cap)
    key = "reg_kernelILi{}E".format(row_cap)
    (name,) = [n for n in functions(listing) if key in n]
    insns = functions(listing)[name]
    # the group branches all jump to one place: the most common target of
    # a conditional branch
    targets = collections.Counter()
    branches = []
    for index, (_, text) in enumerate(insns):
        match = _BRANCH.match(text)
        if match and match.group(1) and match.group(2):
            targets[match.group(2)] += 1
            branches.append((index, match.group(2)))
    join, count = targets.most_common(1)[0]
    at = [index for index, target in branches if target == join]
    sizes = [b - a for a, b in zip(at, at[1:])]
    moves = [
        sum(1 for _, text in insns[a:b] if re.match(r"(IMAD\.)?MOV", text.split()[0]))
        for a, b in zip(at, at[1:])
    ]
    def median(values):
        return sorted(values)[len(values) // 2]

    return dict(
        function=name, row_cap=row_cap, group_rows=rows, groups=count,
        group_instructions=sizes, group_moves=moves,
        instructions_per_row=median(sizes) / rows,
        moves_per_row=median(moves) / rows,
        ops_per_row=median([s - v for s, v in zip(sizes, moves)]) / rows,
    )


def strip_row_instructions(listing, rows):
    """Instructions a row of ``dp_body_warp``, ``rows`` rows a lane, in the
    timed (not the instrumented) launch: the column loop (the longest
    backward branch of the warp kernel) from its
    head to its first vote (``VOTE.ANY``, the fix-up's first) is one
    straight run, the column's set-up and its ``rows`` rows of the
    speculative walk; that count over ``rows``. Also the whole loop body's
    count, the fix-up rounds' unrolled rows and the rare row-m branch
    included."""
    key = "warp_kernelILb0E"
    (name,) = [n for n in functions(listing) if key in n]
    insns = functions(listing)[name]
    index = {address: i for i, (address, _) in enumerate(insns)}
    loops = []
    for i, (address, text) in enumerate(insns):
        match = _BRANCH.match(text)
        if match and match.group(2):
            target = int(match.group(2), 16)
            if target < address and target in index:
                loops.append((index[target], i))
    head, tail = max(loops, key=lambda loop: loop[1] - loop[0])
    votes = [i for i in range(head, tail) if "VOTE.ANY" in insns[i][1]]
    walk = votes[0] - head
    return dict(
        function=name, strip_rows=rows, column_loop_instructions=tail + 1 - head,
        walk_instructions=walk, instructions_per_row=walk / rows,
        shuffles=sum(1 for _, text in insns[head:votes[0]] if "SHFL" in text),
    )


def disassemble(name):
    """The ``cuobjdump -sass`` listing of the built library ``name``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run(
        [cuobjdump, "-sass", _build.library_path(name)],
        capture_output=True, text=True, check=True,
    ).stdout


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--row-cap", type=int, default=48)
    parser.add_argument("--sass", help="a saved cuobjdump -sass listing")
    args = parser.parse_args(argv)
    if args.sass:
        with open(args.sass) as handle:
            listing = handle.read()
    else:
        listing = disassemble("dp_align")
    print(json.dumps(row_instructions(listing, args.row_cap)))
    print(json.dumps(strip_row_instructions(listing, cuda_kernel.STRIP_ROWS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
