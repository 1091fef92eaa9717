"""Tests of the port that need the card (marker ``cuda``).

They skip on a machine without one, with the reason; on a machine with an
NVIDIA Hopper card and ``nvcc`` run them with

    python -m pytest tests/test_torch_cuda.py -q

``chip_smoke.py`` makes the same comparisons at full size; these are the
small, quick form for work on the kernels. They import only the port.
"""
import os

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

TRUSEQ = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _batch(seed, B, L, adapter, flags):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = bases[rng.integers(0, 4, (B, L))]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:2] = (0, 1)
    ad = np.frombuffer(adapter.encode(), np.uint8)
    for row in range(2, B, 2):
        take = int(rng.integers(3, len(ad) + 1))
        if flags in (8, 11):  # anchored 5' and front adapters: at the start
            at = 0
        elif flags in (2, 14):  # anchored 3' and back adapters: at the end
            at = max(0, int(lengths[row]) - take)
        else:
            at = int(rng.integers(0, max(1, lengths[row] - take + 1)))
        frag = (ad[-take:] if flags in (8, 11) else ad[:take]).copy()
        if rng.random() < 0.5:
            frag[int(rng.integers(take))] = bases[int(rng.integers(4))]
        reads[row, at : at + take] = frag[: max(0, L - at)]
    return reads, lengths


@pytest.mark.parametrize("kernel_name", ["dp_locate_word32", "dp_locate_wide"])
@pytest.mark.parametrize("flags", [14, 11, 15, 8, 2])
@pytest.mark.parametrize("indel_cost", [1, 100000])
def test_kernel_equals_plain_version(card, kernel_name, flags, indel_cost):
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    kernel = getattr(cuda_kernel, kernel_name)
    aligner = cuda_kernel.CudaAligner(
        TRUSEQ, 0.1, flags, min_overlap=3, indel_cost=indel_cost, device=card
    )
    reads, lengths = _batch(flags * 7 + indel_cost % 5, 512, 96, TRUSEQ, flags)
    reads_T = torch.from_numpy(reads).to(card).T.contiguous()
    lens = torch.from_numpy(lengths).to(card)[None, :].contiguous()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    before = kernel.launches
    got = kernel(*args, **aligner._dp_params())
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    expected = kernel.plain(*args, **aligner._dp_params())
    assert kernel.launches == before + 1, "the plain version launches nothing"
    assert torch.equal(got, expected)
    assert int(expected[0].sum()) > 0


def test_wrapper_raises_instead_of_falling_back(card):
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    aligner = cuda_kernel.CudaAligner(TRUSEQ, 0.1, 14, device=card)
    reads_T = torch.zeros((32, 48), dtype=torch.uint8, device=card)
    lens = torch.zeros((1, 48), dtype=torch.int32, device=card)
    before = cuda_kernel.launch_counts()
    with pytest.raises(ValueError):  # 48 is no multiple of the warp width
        aligner(reads_T, lens)
    with pytest.raises(ValueError):  # tables on another device
        cuda_kernel.dp_locate_word32(
            reads_T[:, :32].contiguous(), lens[:, :32].contiguous(),
            aligner.ref_bytes.cpu(), aligner.thresholds, **aligner._dp_params()
        )
    assert cuda_kernel.launch_counts() == before


def test_trim_on_the_card_equals_trim_on_the_cpu(card, tmp_path):
    from atropos_tpu_torch.__main__ import main
    from atropos_tpu_torch.align import cuda_kernel

    data = os.path.join(
        os.path.dirname(__file__), "conformance", "data", "illumina.fastq.gz"
    )
    outs = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / (device + ".fastq"))
        cuda_kernel.reset_launch_counts()
        rc = main(
            ["trim", "-a", "GCCGAACTTCTTAGACTGCCTTAAGGACGT", "-q", "10", "-m", "20",
             "-se", data, "-o", out, "--quiet", "--no-cache-adapters",
             "--report-file", str(tmp_path / "report.txt")],
            device=device,
        )
        assert rc == 0
        launched = sum(cuda_kernel.launch_counts().values())
        assert (launched > 0) == (device == "cuda")
        with open(out, "rb") as handle:
            outs[device] = handle.read()
    assert outs["cuda"] == outs["cpu"] and outs["cuda"]
