"""Import hygiene and the device rule of the port.

The port imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``atropos_tpu``: checked by a source scan and by running one single-end
trim in a subprocess in which a ``sys.meta_path`` finder refuses those
packages. Asking for ``cuda`` on a machine without a card raises and
writes no output; only an explicit ``cpu`` runs on the CPU.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

from .conformance_utils import cutpath, datapath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "atropos_tpu_torch")

BLOCKER = r'''
import sys

class Refuse:
    BLOCKED = ("jax", "jaxlib", "atropos_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.BLOCKED:
            raise ImportError("refused in this test: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for name in list(sys.modules):
    assert name.split(".")[0] not in Refuse.BLOCKED, name
'''


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-c", BLOCKER + code, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for top in (PORT, os.path.join(ROOT, "cuda_tools")):
        for folder, _, names in os.walk(top):
            if os.path.basename(folder) in ("build", "__pycache__"):
                continue
            paths += [
                os.path.join(folder, name)
                for name in names
                if name.endswith((".py", ".cu", ".h", ".cpp"))
            ]
    return sorted(paths)


FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|atropos_tpu)(\.|\s|$)", re.MULTILINE
)
DYNAMIC = re.compile(r"import_module\(\s*[\"'](jax|atropos_tpu)[\"'.]")


def test_sources_exist():
    names = {os.path.relpath(path, ROOT) for path in _sources()}
    for needed in (
        "chip_smoke.py",
        "atropos_tpu_torch/__main__.py",
        "atropos_tpu_torch/align/cuda_kernel.py",
        "atropos_tpu_torch/align/insert_kernel.py",
        "atropos_tpu_torch/align/batched.py",
        "atropos_tpu_torch/commands/trim/modifiers/paired.py",
        "atropos_tpu_torch/commands/stats.py",
        "atropos_tpu_torch/csrc/dp_align.cu",
        "atropos_tpu_torch/csrc/diag_counts.cu",
        "atropos_tpu_torch/csrc/dtype_probe.cu",
        "atropos_tpu_torch/csrc/shared_limit.h",
        "atropos_tpu_torch/tools/dtype_probe.py",
        "cuda_tools/timing.py",
        "cuda_tools/dp_compare.py",
        "cuda_tools/diag_compare.py",
        "cuda_tools/probe_compare.py",
        "cuda_tools/sass_rows.py",
        "cuda_tools/plain_compare.py",
        "atropos_tpu_torch/engine/turbo.py",
        "atropos_tpu_torch/runtime/fastq.cpp",
    ):
        assert needed in names


@pytest.mark.parametrize(
    "path", _sources(), ids=[os.path.relpath(p, ROOT) for p in _sources()]
)
def test_no_jax_and_no_reference_package_imports(path):
    with open(path) as handle:
        text = handle.read()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)
    assert not DYNAMIC.search(text)


ENVIRON = re.compile(r"environ|getenv")


def test_no_environment_switch():
    """No environment variable selects a path: the only one the port reads
    is ``CUDA_HOME``, where ``nvcc`` may live."""
    found = []
    for path in _sources():
        with open(path) as handle:
            for line in handle:
                if ENVIRON.search(line):
                    found.append((os.path.relpath(path, ROOT), line.strip()))
    assert found == [(
        "atropos_tpu_torch/align/_build.py",
        'for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):',
    )]


#: calls that build or launch a kernel, or run a device step
LAUNCHING = {
    "_lib", "build", "load", "_step", "_dispatch", "_core", "_planes", "submit",
    "kernel", "aligner", "dp_locate_word32", "dp_locate_wide", "diag_counts_u8",
    "diag_counts_i32", "kernel_for", "dtype_probe_i32", "dtype_probe_i16x2",
    "position_byte_counts", "add_batch", "collect_matrices",
}


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            func = sub.func
            if isinstance(func, ast.Name):
                yield func.id
            elif isinstance(func, ast.Attribute):
                yield func.attr


@pytest.mark.parametrize(
    "path",
    [
        p for p in _sources()
        if p.endswith(".py") and (
            "/align/" in p or "/engine/" in p or "/tools/" in p
            or "/cuda_tools/" in p
            or p.endswith("/commands/stats.py")
        )
    ],
    ids=lambda p: os.path.relpath(p, ROOT),
)
def test_no_except_around_a_build_or_a_launch(path):
    """No ``except`` catches what a kernel build, a launch or a device step
    raises: there is no other implementation to fall back to."""
    with open(path) as handle:
        tree = ast.parse(handle.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            called = set()
            for stmt in node.body:
                called.update(_called_names(stmt))
            assert not called & LAUNCHING, (node.lineno, called & LAUNCHING)


def test_trim_runs_with_jax_and_the_reference_package_blocked(tmp_path):
    out = str(tmp_path / "small.fastq")
    done = _run(
        r'''
from atropos_tpu_torch.__main__ import main
rc = main(
    ["trim", "-b", "TTAGACATATCTCCGTCG", "-se", sys.argv[1], "-o", sys.argv[2],
     "--quiet", "--adapter-cache-file", sys.argv[3], "--report-file", sys.argv[4]],
    device="cpu",
)
loaded = sorted(n for n in sys.modules if n.split(".")[0] in Refuse.BLOCKED)
assert not loaded, loaded
import torch
assert "torch" in sys.modules
sys.exit(rc)
''',
        datapath("small.fastq"), out, str(tmp_path / ".adapters"),
        str(tmp_path / "report.txt"),
    )
    assert done.returncode == 0, done.stderr
    with open(out) as got, open(cutpath("small.fastq")) as expected:
        assert got.read() == expected.read()


def test_paired_insert_trim_runs_with_jax_and_the_reference_package_blocked(tmp_path):
    outs = [str(tmp_path / "out.{}.fastq".format(i)) for i in (1, 2)]
    done = _run(
        r'''
from atropos_tpu_torch.__main__ import main
from atropos_tpu_torch.engine import turbo
rc = main(
    ["trim", "--aligner", "insert", "-a", "TTAGACATAT", "-A", "CAGTGGAGTA", "-m", "14",
     "-pe1", sys.argv[1], "-pe2", sys.argv[2], "-o", sys.argv[3], "-p", sys.argv[4],
     "--quiet", "--adapter-cache-file", sys.argv[5], "--report-file", sys.argv[6]],
    device="cpu",
)
assert turbo.LAST_RUN["aligner"] == "insert", turbo.LAST_RUN
loaded = sorted(n for n in sys.modules if n.split(".")[0] in Refuse.BLOCKED)
assert not loaded, loaded
sys.exit(rc)
''',
        datapath("paired.1.fastq"), datapath("paired.2.fastq"), *outs,
        str(tmp_path / ".adapters"), str(tmp_path / "report.txt"),
    )
    assert done.returncode == 0, done.stderr
    for out, golden in zip(outs, ("paired_insert.1.fastq", "paired_insert.2.fastq")):
        with open(out) as got, open(cutpath(golden)) as expected:
            assert got.read() == expected.read()


def test_side_files_stats_and_probe_run_with_jax_and_the_reference_package_blocked(
        tmp_path):
    """Demultiplexed output with info and rest files and ``--stats both``,
    a paired ``-w`` trim, and the dtype probe tool, on ``cpu``."""
    mux = str(tmp_path / "mux.{name}.fasta")
    outs = [str(tmp_path / "ow.{}.fastq".format(i)) for i in (1, 2)]
    done = _run(
        r'''
from atropos_tpu_torch.__main__ import main
from atropos_tpu_torch.commands import stats
from atropos_tpu_torch.tools import dtype_probe
args = sys.argv[1:]
tail = ["--quiet", "--adapter-cache-file", args[6], "--report-file", args[7]]
rc = main(
    ["trim", "-a", "first=AATTTCAGGAATT", "-a", "second=GTTCTCTAGTTCT",
     "-se", args[0], "-o", args[1], "--info-file", args[1] + ".info",
     "-r", args[1] + ".rest"] + tail,
    device="cpu",
)
rc |= main(
    ["trim", "--stats", "both", "-a", "TTAGACATAT", "-se", args[2],
     "-o", args[1] + ".stats.fastq"] + tail,
    device="cpu",
)
assert stats.DEVICE_STATS_COUNTS["cpu"] > 0 and stats.DEVICE_STATS_COUNTS["cuda"] == 0
rc |= main(
    ["trim", "-w", "10,30,10", "-pe1", args[3], "-pe2", args[4],
     "-o", args[5], "-p", args[5].replace(".1.", ".2.")] + tail,
    device="cpu",
)
results = dtype_probe.main(["--device", "cpu", "--shape", "40,8"])
assert len(results) == 4 and dtype_probe.launch_counts() == {
    "dtype_probe_i32": 0, "dtype_probe_i16x2": 0}
loaded = sorted(n for n in sys.modules if n.split(".")[0] in Refuse.BLOCKED)
assert not loaded, loaded
sys.exit(rc)
''',
        datapath("twoadapters.fasta"), mux, datapath("small.fastq"),
        datapath("lowq.fastq"), datapath("highq.fastq"), outs[0],
        str(tmp_path / ".adapters"), str(tmp_path / "report.txt"),
    )
    assert done.returncode == 0, done.stderr
    for name in ("first", "second", "unknown"):
        with open(mux.format(name=name)) as got, open(
            cutpath("twoadapters.{}.fasta".format(name))
        ) as expected:
            assert got.read() == expected.read()
    for out, golden in zip(outs, ("lowq.fastq", "highq.fastq")):
        with open(out) as got, open(cutpath(golden)) as expected:
            assert got.read() == expected.read()


def test_blocker_really_blocks():
    done = _run("import atropos_tpu\n")
    assert done.returncode != 0 and "refused in this test" in done.stderr
    done = _run("import jax\n")
    assert done.returncode != 0 and "refused in this test" in done.stderr


@pytest.mark.parametrize("how", ["default", "option", "argument"])
def test_cuda_without_a_card_raises_and_writes_nothing(tmp_path, how):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from atropos_tpu_torch import DeviceUnavailableError
    from atropos_tpu_torch.__main__ import main

    out = str(tmp_path / "out.fastq")
    report = str(tmp_path / "report.txt")
    argv = [
        "trim", "-b", "TTAGACATATCTCCGTCG", "-se", datapath("small.fastq"),
        "-o", out, "--quiet", "--report-file", report,
        "--adapter-cache-file", str(tmp_path / ".adapters"),
    ]
    kwargs = {}
    if how == "option":
        argv += ["--device", "cuda"]
    elif how == "argument":
        kwargs["device"] = "cuda"
    with pytest.raises(DeviceUnavailableError):
        main(argv, **kwargs)
    assert not os.path.exists(out)
    assert not os.path.exists(report)


def test_device_argument_overrides_option(tmp_path):
    from atropos_tpu_torch.__main__ import main

    out = str(tmp_path / "out.fastq")
    rc = main(
        [
            "trim", "-b", "TTAGACATATCTCCGTCG", "-se", datapath("small.fastq"),
            "-o", out, "--quiet", "--device", "cuda",
            "--report-file", str(tmp_path / "report.txt"),
            "--adapter-cache-file", str(tmp_path / ".adapters"),
        ],
        device="cpu",
    )
    assert rc == 0 and os.path.exists(out)


def test_lane_and_aligner_take_the_device_explicitly():
    import torch

    from atropos_tpu_torch import DeviceUnavailableError, resolve_device
    from atropos_tpu_torch.align.batched import BatchAligner
    from atropos_tpu_torch.align.cuda_kernel import CudaAligner
    from atropos_tpu_torch.engine.turbo import _MateLane

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    kwargs = dict(cut_front=0, cut_back=0, quality=None, nextseq=None,
                  cutter=None, cutter_mod=None)
    assert _MateLane(device="cpu", **kwargs).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            resolve_device(None)
        with pytest.raises(DeviceUnavailableError):
            _MateLane(**kwargs)
    aligner = CudaAligner("ACGTACGT", 0.1, 14, device="cpu")
    assert isinstance(aligner, BatchAligner)
    assert aligner.ref_bytes.device.type == "cpu"
    assert {name for name, _ in aligner.named_buffers()} == {
        "ref_bytes", "thresholds", "query_lut",
    }


@pytest.mark.parametrize("command", ["qc", "detect", "error"])
def test_other_commands_are_not_ported(command):
    from atropos_tpu_torch import NotPortedError
    from atropos_tpu_torch.__main__ import main

    with pytest.raises(NotPortedError) as err:
        main([command, "-se", datapath("small.fastq")], device="cpu")
    assert "ROADMAP.md queue 1 item 6" in str(err.value)


@pytest.mark.parametrize("extra,topic", [
    (["-pe1", "paired.1.fastq", "-pe2", "paired.2.fastq", "-A", "ACGT",
      "--aligner", "insert", "--correct-mismatches", "liberal"], "insert-correct"),
    (["-l", "interleaved.fastq", "-A", "ACGT", "-L", "{tmp}/il.fastq",
      "--aligner", "insert", "--merge-overlapping"], "engine"),
    (["-pe1", "paired.1.fastq", "-pe2", "paired.2.fastq", "-A", "ACGT",
      "--bisulfite", "swift"], "engine"),
    (["-pe1", "paired.1.fastq", "-pe2", "paired.2.fastq", "-A", "ACGT",
      "--aligner", "insert", "-w", "10,30,10"], "engine"),
    (["-se", "small.fastq", "--threads", "2"], "multi-gpu"),
    (["-se", "small.fastq", "--stats", "both:tiles"], "engine"),
    (["-se", "small.fastq", "--times", "2"], "engine"),
    (["-se", "small.fastq", "--op-order", "ACGQW"], "engine"),
])
def test_options_outside_the_slice_raise(tmp_path, extra, topic):
    from atropos_tpu_torch import NotPortedError
    from atropos_tpu_torch.__main__ import main

    extra = [
        x.replace("{tmp}", str(tmp_path)) if "{tmp}" in x
        else datapath(x) if x.endswith(".fastq") else x
        for x in extra
    ]
    out = str(tmp_path / "out.fastq")
    argv = ["trim", "-a", "TTAGACATATCTCCGTCG", "-q", "10", "--quiet",
            "--report-file", str(tmp_path / "report.txt"),
            "--adapter-cache-file", str(tmp_path / ".adapters")]
    if "-l" not in extra:
        argv += ["-o", out]
    if "-pe1" in extra:
        argv += ["-p", str(tmp_path / "out2.fastq")]
    with pytest.raises(NotPortedError) as err:
        main(argv + extra, device="cpu")
    assert err.value.topic == topic
    assert not os.path.exists(out)
