"""The measurement tools beside the port (``cuda_tools/``) on the CPU: the
copies of the package with a constant set otherwise, which
``diag_compare.py`` and ``probe_compare.py`` time, the session in which
the compare tools take turns, the flags of ``chip_smoke.py``'s DP grid,
and the count of the
dtype probe's column loops in a SASS listing (``sass_rows.py --probe``).
The tools' timings run only on a card."""
import os

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
