"""The measurement tools beside the port (``cuda_tools/``) on the CPU: the
copies of the package with a constant set otherwise, which
``diag_compare.py`` and ``probe_compare.py`` time, the session in which
the compare tools take turns, the flags of ``chip_smoke.py``'s DP grid,
its ``--device cpu`` checks (one a card path, on the records each had
before they moved into one phase, run only by that phase's children), and
the count of the dtype probe's column loops in a SASS listing
(``sass_rows.py --probe``). The tools' timings run only on a card."""
import os
import time

import pytest

from cuda_tools import probe_compare, sass_rows, timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(root, source):
    with open(os.path.join(root, source)) as handle:
        return handle.read()


def test_constant_variant_sets_each_constant_of_a_copy(tmp_path):
    source = probe_compare.SOURCE
    root = timing.constant_variant(str(tmp_path), source, "PAIR_LANES=1+PROBE16_THREADS=32")
    assert root == str(tmp_path / "PAIR_LANES=1+PROBE16_THREADS=32")
    text = _read(root, source)
    assert "constexpr int PAIR_LANES = 1;" in text
    assert "constexpr int PROBE16_THREADS = 32;" in text
    original = _read(ROOT, source)
    assert text.replace("PAIR_LANES = 1;", "").replace("PROBE16_THREADS = 32;", "") == (
        original.replace("PAIR_LANES = 2;", "").replace("PROBE16_THREADS = 64;", ""))
    assert not os.path.exists(os.path.join(root, "atropos_tpu_torch", "build"))


def test_constant_variant_refuses_a_name_the_source_lacks(tmp_path):
    with pytest.raises(RuntimeError, match="NO_SUCH"):
        timing.constant_variant(str(tmp_path), probe_compare.SOURCE, "PAIR_LANES=1+NO_SUCH=3")
    with pytest.raises(RuntimeError, match="nothing to change"):
        timing.constant_variant(str(tmp_path), probe_compare.SOURCE, "PAIR_LANES=2")


def _function(name, body):
    lines = ["\t\tFunction : " + name]
    for address, text in body:
        lines.append("        /*{:04x}*/                   {} ;".format(address, text))
    return "\n".join(lines)


def _loop(start, size, extra):
    """``size`` instructions from ``start`` (``extra`` among them), closed
    by a branch back to ``start``."""
    body = [(start + 16 * i, text) for i, text in enumerate(
        extra + ["IMAD R2, R3, 0xffff, RZ"] * (size - 1 - len(extra)))]
    body.append((start + 16 * (size - 1), "@!P1 BRA 0x{:x}".format(start)))
    return body


def _probe_listing(i16_extra):
    i32 = [(0, "MOV R1, c[0x0][0x28]")] + _loop(0x10, 40, ["LDG.E.U8 R4, [R2.64]"]) + (
        _loop(0x400, 30, ["IMAD.MOV.U32 R5, RZ, RZ, R6"])) + [(0x800, "EXIT")]
    i16 = _loop(0x10, 20, ["MOV R7, R8", "LDG.E.U16.CONSTANT R4, [R2.64]"] + i16_extra) + (
        _loop(0x400, 12, i16_extra))
    return "\n".join([
        "code for sm_90a",
        _function("_ZN12_GLOBAL__N_122dtype_probe_i32_kernelEPKhPiS2_iiii", i32),
        _function("_ZN12_GLOBAL__N_124dtype_probe_i16x2_kernelEPKhPiS2_iiii", i16),
    ])


@pytest.mark.parametrize("lanes", [1, 2])
def test_probe_row_instructions_counts_both_column_loops(lanes):
    """A 16-bit column loop that shuffles is read as two lanes a pair, one
    that does not as one lane."""
    shuffles = ["SHFL.UP PT, R9, R10, 0x1, RZ"] if lanes == 2 else []
    counts = sass_rows.probe_row_instructions(_probe_listing(shuffles))
    rows = 33
    i32_counts, i16_counts = counts["dtype_probe_i32"], counts["dtype_probe_i16x2"]
    assert (i32_counts["lanes"], i32_counts["rows"]) == (1, rows)
    assert i32_counts["dyn"] == dict(instructions=40, moves=0, sass_per_row=40 / rows)
    assert i32_counts["nodyn"] == dict(instructions=30, moves=1, sass_per_row=29 / rows)
    assert i16_counts["lanes"] == lanes
    assert i16_counts["dyn"] == dict(instructions=20, moves=1,
                                     sass_per_row=19 * lanes / rows)
    assert i16_counts["nodyn"] == dict(instructions=12, moves=0,
                                       sass_per_row=12 * lanes / rows)


def test_compare_session_takes_turns(monkeypatch):
    """parent, this, the copies, the copies in the other order, this,
    parent; each turn timed by the tool's child with its tree's root."""
    calls = []

    def run_child(module, argv, cwd):
        calls.append((module, argv, cwd))
        if argv[0] == "--make":
            return ["shapes"]
        return {"run": {"ms": float(len(calls)), "root": argv[1]}}

    monkeypatch.setattr(timing, "run_child", run_child)
    made, order, runs = timing.compare_session(
        "cuda_tools.tool", "parent_dir",
        lambda work: ["--make", work],
        lambda work, label, root: ["--time", root, label],
        lambda work: {"A=1": "copy_a", "B=2": "copy_b"},
    )
    assert made == ["shapes"]
    assert order == ["parent", "this", "A=1", "B=2", "B=2", "A=1", "this", "parent"]
    roots = dict(parent=os.path.abspath("parent_dir"), this=ROOT)
    roots.update({"A=1": "copy_a", "B=2": "copy_b"})
    assert [label for label, _ in runs] == order
    assert [argv for _, argv, _ in calls[1:]] == [["--time", roots[o], o] for o in order]
    assert all(module == "cuda_tools.tool" and cwd == ROOT for module, _, cwd in calls)
    # the work directory is gone after the session
    assert not os.path.exists(calls[0][1][1])


def test_turn_times_lists_each_trees_turns_and_ratios_to_the_parent():
    runs = [("parent", {"x": {"ms": 4.0}}), ("this", {"x": {"ms": 1.0}}),
            ("A=1", {"x": {"ms": 6.0}}), ("A=1", {"x": {"ms": 10.0}}),
            ("this", {"x": {"ms": 3.0}}), ("parent", {"x": {"ms": 4.0}})]
    assert timing.turn_times("x", runs, ("ms",)) == {
        "parent_ms": [4.0, 4.0], "this_ms": [1.0, 3.0], "A=1_ms": [6.0, 10.0],
        "ratio_ms": 0.5, "ratio_A=1_ms": 2.0,
    }


def test_grid_flags_are_the_adapter_types():
    """``chip_smoke.py``'s DP grid, which ``dp_compare.py`` times too, hands
    each configuration its adapter type's flags (a module constant of the
    same name once shadowed ``PREFIX``, leaving the prefix rows with none)."""
    import chip_smoke
    from atropos_tpu_torch.adapters.model import ADAPTER_TYPES

    types = {"a": "back", "g": "front", "b": "anywhere", "prefix": "prefix", "suffix": "suffix"}
    configs = chip_smoke.grid_configs()
    assert {cfg["flag_name"] for cfg in configs} == set(types)
    for cfg in configs:
        assert cfg["flags"] == ADAPTER_TYPES[types[cfg["flag_name"]]].flags, cfg


def test_probe_compare_names_its_runs():
    assert probe_compare.run_name("dtype_probe_i16x2", 160, 32768, True) == (
        "dtype_probe_i16x2/L=160,N=32768/dyn")
    assert probe_compare.run_name("dtype_probe_i32", 104, 16384, False).endswith("/nodyn")


#: the paths whose output ``chip_smoke.py`` makes on the card, and the
#: records of their input each ``--device cpu`` check runs: (DEPTH + 2) x
#: MAX_BATCH = 163,840 reads of the main path and pairs of the insert path,
#: whose prefixes reach the batches that reuse pinned slots; two batches,
#: 65,536 pairs or records, of the other paired and side paths; 32,768
#: records of the engine paths; the whole 2,048 pairs of the insert check
CPU_CHECKS = {
    "main_path": 163840, "pe_insert_path": 163840, "pe_adapter_path": 65536,
    "pe_side_path": 65536, "pe_overwrite_path": 65536, "pe_insert_wide_path": 65536,
    "se_side_path": 65536, "se_engine_path": 32768, "pe_engine_path": 32768,
    "pe_engine_insert_check": 2048, "pe_correct_path": 65536, "se_sam_engine_path": 32768,
    "pe_sam_engine_path": 32768, "se_fastaqual_engine_path": 32768,
    "se_stats_serial_check": 8192,
    # the qc, detect and error commands: qc on 65,536 reads of the main
    # path's CPU prefix and on the paired prefix, detect and error on every
    # record of their inputs
    "qc_path": 65536, "pe_qc_path": 65536, "detect_path": 1000, "detect_known_path": 4000,
    "detect_khmer_path": 10000, "pe_detect_check": 2000, "error_path": 10000,
    # --threads: the main path's first 20,000 reads without the worker options
    "threads_path": 20000,
}


def _deferred_tags():
    """The path tags ``chip_smoke.py``'s phases hand to the CPU phase: the
    string arguments of every ``defer_cpu``, ``defer_pair_check`` and
    ``prefix_checks`` call, the tag argument of every ``command_checks``
    call and of ``main``'s calls of ``phase_detect``, and the tags chosen
    beside such a call."""
    import ast

    tree = ast.parse(_read(ROOT, "chip_smoke.py"))
    tags = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and (
            node.name.startswith("phase_") or node.name == "main"
        ):
            for sub in ast.walk(node):
                name = getattr(sub, "func", None) and getattr(sub.func, "id", None)
                if isinstance(sub, ast.Call) and name in (
                    "defer_cpu", "defer_pair_check", "prefix_checks", "command_checks",
                    "phase_detect",
                ):
                    args = {"phase_detect": sub.args[1:2],
                            "command_checks": sub.args[:1]}.get(name, sub.args)
                    tags += [a.value for a in args
                             if isinstance(a, ast.Constant) and isinstance(a.value, str)]
                elif isinstance(sub, ast.Assign) and any(
                    getattr(t, "id", None) == "tag" for t in sub.targets
                ):
                    tags += [c.value for c in ast.walk(sub.value)
                             if isinstance(c, ast.Constant) and isinstance(c.value, str)]
    return tags


def test_every_card_path_has_one_cpu_check_of_its_records():
    import chip_smoke

    assert chip_smoke.CPU_CHECK_RECORDS == CPU_CHECKS
    assert sorted(chip_smoke.CPU_CHECK_SECONDS) == sorted(CPU_CHECKS)
    tags = _deferred_tags()
    assert sorted(tags) == sorted(CPU_CHECKS), tags


@pytest.mark.parametrize("jobs,cores,children,threads", [
    (15, 8, 6, [2] + [1] * 14),   # the card's machine: 8 cores, one for the card
    (22, 8, 6, [2] + [1] * 21),
    (10, 8, 6, [2] + [1] * 9),
    (3, 8, 3, [3, 2, 2]),
    (1, 8, 1, [7]),
    (4, 2, 1, [1, 1, 1, 1]),
])
def test_cpu_phase_plan(jobs, cores, children, threads):
    """The largest check takes two threads and the phase one child fewer,
    so that the children's threads never exceed the host's cores less the
    one that runs the untimed card checks."""
    import chip_smoke

    plan = chip_smoke.cpu_phase_plan(jobs, cores)
    assert plan == (children, threads)
    assert sum(sorted(threads, reverse=True)[:children]) <= max(1, cores - 1)


def test_cpu_checks_run_only_in_the_cpu_phase(tmp_path, monkeypatch):
    """A card phase cannot run a ``--device cpu`` check (it would share the
    host with the phase's timing), deferring one runs nothing, a path
    cannot defer two, and the CPU phase runs what was deferred in a spawned
    child (the main process joins only for what no child has taken) and
    compares its output with the card's."""
    import chip_smoke

    from .conformance_utils import cutpath, datapath

    out = str(tmp_path / "cpu.fastq")
    argv = ["trim", "-b", "TTAGACATATCTCCGTCG", "-se", datapath("small.fastq"), "-o", out,
            "--quiet", "--no-cache-adapters", "--report-file", str(tmp_path / "report.txt")]
    for run in (chip_smoke.run_trim, chip_smoke.run_summary):
        with pytest.raises(AssertionError):
            run(argv, "cpu")
    assert not os.path.exists(out)
    monkeypatch.setattr(chip_smoke, "CPU_CHECK_RECORDS", {"small": 10})
    monkeypatch.setattr(chip_smoke, "CPU_PENDING", [])
    chip_smoke.defer_cpu("small", [dict(
        argv=argv, outs=[(out, cutpath("small.fastq"), None)], expect={"device": "cpu"},
    )])
    with pytest.raises(AssertionError):
        chip_smoke.defer_cpu("small", [dict(argv=list(argv), outs=[])])
    assert not os.path.exists(out) and len(chip_smoke.CPU_PENDING) == 1
    cpu = chip_smoke.start_cpu_phase()
    waited = time.monotonic()
    while cpu["counter"].value < 1 and time.monotonic() - waited < 300:
        time.sleep(0.2)
    assert chip_smoke.finish_cpu_phase(cpu) > 0
    assert chip_smoke.CPU_PENDING == [] and not os.path.exists(out)
    assert os.path.exists(str(tmp_path / "cpu_small_0.report.txt"))


def test_the_cpu_phase_follows_every_timed_phase():
    """``main`` starts the CPU phase after every phase that times the card
    and before only the phases that time nothing, which run beside it."""
    import ast

    import chip_smoke

    tree = ast.parse(_read(ROOT, "chip_smoke.py"))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [
        node.func.id for node in sorted(
            (n for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)),
            key=lambda n: (n.lineno, n.col_offset))
    ]
    start, finish = calls.index("start_cpu_phase"), calls.index("finish_cpu_phase")
    beside = [name for name in calls[start + 1 : finish] if name.startswith("phase_")]
    assert sorted(set(beside)) == sorted(chip_smoke.UNTIMED_PHASES)
    timed = [name for name in calls if name.startswith(("phase_", "time_"))
             and name not in chip_smoke.UNTIMED_PHASES]
    assert timed and all(calls.index(name) < start for name in timed)
    timing = {"time_kernel", "time_diag", "time_pair_step", "time_device_step",
              "device_times", "perf_counter"}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in chip_smoke.UNTIMED_PHASES:
            called = {getattr(n.func, "id", getattr(n.func, "attr", None))
                      for n in ast.walk(node) if isinstance(n, ast.Call)}
            assert not called & (timing - {"perf_counter"}), (node.name, called & timing)
