"""``--correct-mismatches`` with the insert aligner against the JAX package.

The overlap error correction of read pairs (``liberal``, ``conservative``
and ``N``) on the turbo paired runner, where the port corrects each batch
on the host from the insert candidates of the diagonal-count kernels
(``_InsertPair._correct``) and patches the corrected records into the
native formatter's output, and through each of the runner's three
declines (FASTA input without qualities, ``--stats``, side files), where
the per-record pipeline corrects pair by pair. At 2x150 (window <= 255:
``diag_counts_u8``'s slots) and 2x300 (window > 255: ``diag_counts_i32``
and the host's rebuild of the candidate stream). Both packages must give
the same mode, the same bytes and the same summary, the correction
counts among them, and these must be non-zero. Inputs are made with numpy
from a seed; adapters are named; tolerance 0.
"""
import pytest

from atropos_tpu_torch.engine import turbo as port_turbo

from .test_torch_align import seeded
from .test_torch_engine_cli import run_both, tail
from .test_torch_turbo_pe import AD1, AD2, make_pairs, write_pairs

ACTIONS = ("liberal", "conservative", "N")

#: the turbo runner's declines of a correcting insert aligner: (extra
#: argv, the reason the runner logs)
DECLINES = {
    "fasta": "insert correction without qualities",
    "stats": "--stats with insert correction",
    "side_files": "side files with insert correction",
}


def _pairs(tmp_path, read_len, seed, fasta=False):
    rng = seeded("insert-correct", read_len * 10 + seed)
    pairs = make_pairs(rng, 160, read_len, "ACGTN", n_rate=0.005, sub_rate=0.03,
                       poly_a=2)
    if not fasta:
        return write_pairs(tmp_path, pairs)
    paths = []
    for mate in (0, 1):
        path = str(tmp_path / "in.{}.fasta".format(mate + 1))
        with open(path, "w") as handle:
            handle.write("".join(">{}\n{}\n".format(p[mate][0], p[mate][1]) for p in pairs))
        paths.append(path)
    return paths


def _argv(action, inputs, outs, extra=()):
    return ["--aligner", "insert", "-a", "ad1=" + AD1, "-A", "ad2=" + AD2,
            "--correct-mismatches", action, "-pe1", inputs[0], "-pe2", inputs[1],
            "-o", outs[0], "-p", outs[1]] + list(extra)


def _corrections(summary):
    """The correction counts of the insert cutter in a comparable summary."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if "records_corrected" in node:
                found.append((node["records_corrected"], node["bp_corrected"]))
            for value in node.values():
                walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)

    walk(summary)
    return found


@pytest.mark.parametrize("read_len", [150, 300])
@pytest.mark.parametrize("action", ACTIONS)
def test_turbo_correction(tmp_path, monkeypatch, read_len, action):
    inputs = _pairs(tmp_path, read_len, len(action))
    outs = [str(tmp_path / "o1.fastq"), str(tmp_path / "o2.fastq")]
    run = run_both(_argv(action, inputs, outs) + tail(tmp_path), outs,
                   str(tmp_path / "report.txt"), monkeypatch, mode="turbo")
    ((pairs, bp),) = _corrections(run[2])
    assert pairs > 0 and bp[0] + bp[1] > 0


@pytest.mark.parametrize("decline", sorted(DECLINES))
@pytest.mark.parametrize("read_len", [150, 300])
def test_declined_correction(tmp_path, monkeypatch, decline, read_len):
    """The three configurations the turbo runner declines run through the
    pipeline in both packages with the same bytes and corrections."""
    action = "N" if decline == "fasta" else "liberal"
    inputs = _pairs(tmp_path, read_len, 3, fasta=decline == "fasta")
    ext = "fasta" if decline == "fasta" else "fastq"
    outs = [str(tmp_path / ("o1." + ext)), str(tmp_path / ("o2." + ext))]
    extra = {
        "fasta": [],
        "stats": ["--stats", "both"],
        "side_files": ["--info-file", str(tmp_path / "info.txt")],
    }[decline]
    if decline == "side_files":
        outs.append(extra[1])
    declined = []
    monkeypatch.setattr(port_turbo.TurboPairedRunner, "_decline",
                        staticmethod(lambda reason: declined.append(reason)))
    run = run_both(_argv(action, inputs, outs[:2], extra) + tail(tmp_path), outs,
                   str(tmp_path / "report.txt"), monkeypatch)
    assert declined == [DECLINES[decline]]
    ((pairs, bp),) = _corrections(run[2])
    assert pairs > 0 and bp[0] + bp[1] > 0


@pytest.mark.parametrize("action", ["liberal", "conservative"])
def test_quality_correction_without_qualities_fails_alike(tmp_path, action):
    """FASTA pairs with a quality-based action: both packages fail the run
    with the same error."""
    from atropos_tpu import commands as jax_commands
    from atropos_tpu_torch import commands as port_commands

    inputs = _pairs(tmp_path, 150, 4, fasta=True)
    outs = [str(tmp_path / "o1.fasta"), str(tmp_path / "o2.fasta")]
    argv = _argv(action, inputs, outs) + tail(tmp_path)
    results = []
    for execute in (
        lambda: jax_commands.get_command("trim").execute(argv),
        lambda: port_commands.get_command("trim").execute(argv, device="cpu"),
    ):
        retcode, summary = execute()
        results.append((retcode, summary["mode"], summary.get("exception", {}).get("message")))
    assert results[0] == results[1] and results[0][0] != 0
