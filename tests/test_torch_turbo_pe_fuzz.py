"""A seeded fuzz of the paired-end turbo slice: the same argv through
``atropos_tpu`` and through ``atropos_tpu_torch`` on ``cpu`` gives
byte-identical outputs and equal summaries. The draws cover both
aligners, legacy mode, indel costs 1 to 3, error rates,
``--adapter-max-rmp``, ``--insert-match-error-rate``, cuts, quality and N
trimming, length filters, pair filters, ``--stats``, info files, ``-w``
mate overwrite (adapter aligner), two files or interleaved input and
output, gz, lowercase, more than 14 symbols, windows above 255 and
near-poly-A pairs.

All inputs are made from a seed with numpy; tolerance 0.
"""
import pytest
import torch

from .test_torch_align import seeded
from .test_torch_turbo_pe import AD1, AD2, assert_same, io_argv, make_pairs, tail, write_pairs
from .test_torch_turbo_se import run_both

torch.set_num_threads(1)


def random_pe_config(rng):
    """One draw of the options of the paired slice."""
    aligner = ("adapter", "insert")[int(rng.integers(2))]
    parts = ["--aligner", aligner]
    if aligner == "adapter" and rng.random() < 0.3:
        parts += ["-a", "ad1=" + AD1]  # legacy mode: read 2 is left alone
    else:
        parts += ["-a", "ad1=" + AD1, "-A", "ad2=" + AD2]
    parts += ["--indel-cost", ("1", "2", "3")[int(rng.integers(3))]]
    parts += ["-e", ("0.1", "0.2", "0.3")[int(rng.integers(3))]]
    if rng.random() < 0.6:
        parts += ["--adapter-max-rmp", ("0.001", "0.01", "1e-5")[int(rng.integers(3))]]
    if aligner == "insert" and rng.random() < 0.5:
        parts += ["--insert-match-error-rate", ("0.1", "0.3")[int(rng.integers(2))]]
    if rng.random() < 0.4:
        parts += ["-q", str(int(rng.integers(5, 30)))]
    if rng.random() < 0.3:
        parts += ["-u", str(int(rng.integers(1, 6))), "-U", str(-int(rng.integers(1, 6)))]
    if rng.random() < 0.3:
        parts += ["--trim-n"]
    if rng.random() < 0.5:
        parts += ["-m", str(int(rng.integers(1, 40)))]
    if rng.random() < 0.3:
        parts += ["-M", str(int(rng.integers(50, 90)))]
    if rng.random() < 0.3:
        parts += ["--pair-filter", ("any", "both")[int(rng.integers(2))]]
    if rng.random() < 0.2:
        parts += ["--discard-untrimmed"]
    # -w runs without --stats and side files (the turbo runner declines
    # those together), and only with the adapter aligner
    if aligner == "adapter" and rng.random() < 0.3:
        window = int(rng.integers(5, 15))
        parts += ["-w", "{},{},{}".format(int(rng.integers(5, 15)), int(rng.integers(20, 35)), window)]
        if rng.random() < 0.3:
            parts += ["--op-order", "WCGQA"]
    elif rng.random() < 0.3:
        parts += ["--stats", ("pre", "post", "both")[int(rng.integers(3))]]
    return parts


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_paired(tmp_path, seed):
    rng = seeded("fuzz-pe", seed)
    parts = random_pe_config(rng)
    alphabet = ("ACGT", "ACGTN", "ACGTNRYKMSWBDHV")[int(rng.integers(3))]
    read_len = (80, 120, 270)[int(rng.integers(3))]
    pairs = make_pairs(rng, 120, read_len, alphabet, n_rate=0.01,
                       lowercase=(0.0, 0.2)[int(rng.integers(2))],
                       poly_a=int(rng.integers(0, 3)))
    layout = int(rng.integers(3))
    # gz only below the 64 KiB of a pipe: the reference's piped gzip reader
    # is closed unread by its turbo runner and fails its close when its
    # gzip process was still writing
    gz = rng.random() < 0.3 and read_len <= 120
    inputs = write_pairs(tmp_path, pairs, gz=gz, interleaved=layout == 2)
    io, outs = io_argv(inputs, tmp_path, interleaved_out=layout == 1)
    if "-w" not in parts and rng.random() < 0.3:
        outs.append(str(tmp_path / "info.txt"))
        io += ["--info-file", outs[-1]]
    argv = parts + io
    assert_same(run_both(argv + tail(tmp_path), outs), "seed {}: {}".format(seed, argv))


def random_correct_config(rng, tmp_path):
    """One draw of ``--correct-mismatches`` with the insert aligner: the
    action, the options of the slice beside it, and now and then one of
    the turbo runner's declines (``--stats``, an info file). Returns
    (argv parts, extra outputs, the mode both packages must choose)."""
    parts = ["--aligner", "insert", "-a", "ad1=" + AD1, "-A", "ad2=" + AD2,
             "--correct-mismatches", ("liberal", "conservative", "N")[int(rng.integers(3))]]
    parts += ["-e", ("0.1", "0.2")[int(rng.integers(2))]]
    if rng.random() < 0.5:
        parts += ["--insert-match-error-rate", ("0.1", "0.3")[int(rng.integers(2))]]
    if rng.random() < 0.4:
        parts += ["-q", str(int(rng.integers(5, 30)))]
    if rng.random() < 0.3:
        parts += ["-u", str(int(rng.integers(1, 6))), "-U", str(-int(rng.integers(1, 6)))]
    if rng.random() < 0.4:
        parts += ["-m", str(int(rng.integers(1, 40)))]
    if rng.random() < 0.3:
        parts += ["--trim-n"]
    outs, mode = [], "turbo"
    roll = rng.random()
    if roll < 0.2:
        parts += ["--stats", ("pre", "post", "both")[int(rng.integers(3))]]
        mode = "serial"
    elif roll < 0.35:
        outs.append(str(tmp_path / "info.txt"))
        parts += ["--info-file", outs[-1]]
        mode = "serial"
    return parts, outs, mode


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_paired_correct_mismatches(tmp_path, monkeypatch, seed):
    """``--correct-mismatches`` with the insert aligner, on the turbo runner
    or through its declines: the same mode, bytes, summary (the correction
    counts among them) and report in both packages."""
    from .test_torch_engine_cli import run_both as run_both_modes

    rng = seeded("fuzz-pe-correct", seed)
    parts, side_outs, mode = random_correct_config(rng, tmp_path)
    read_len = (80, 150, 270)[int(rng.integers(3))]
    pairs = make_pairs(rng, 120, read_len, ("ACGT", "ACGTN")[int(rng.integers(2))],
                       n_rate=0.01, poly_a=int(rng.integers(0, 3)), sub_rate=0.03)
    layout = int(rng.integers(3))
    inputs = write_pairs(tmp_path, pairs, interleaved=layout == 2)
    io, outs = io_argv(inputs, tmp_path, interleaved_out=layout == 1)
    run_both_modes(parts + io + tail(tmp_path), outs + side_outs,
                   str(tmp_path / "report.txt"), monkeypatch, mode=mode)
