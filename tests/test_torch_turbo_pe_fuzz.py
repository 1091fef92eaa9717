"""A seeded fuzz of the paired-end turbo slice: the same argv through
``atropos_tpu`` and through ``atropos_tpu_torch`` on ``cpu`` gives
byte-identical outputs and equal summaries. The draws cover both
aligners, legacy mode, indel costs 1 to 3, error rates,
``--adapter-max-rmp``, ``--insert-match-error-rate``, cuts, quality and N
trimming, length filters, pair filters, two files or interleaved input and
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
    argv = parts + io
    assert_same(run_both(argv + tail(tmp_path), outs), "seed {}: {}".format(seed, argv))
