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


#: error rate for each indel cost: 2 and 3 with rates at which k = 6 and 9
#: on TruSeq reach the cost
ERROR_RATE = {1: 0.1, 2: 0.2, 3: 0.3, 100000: 0.1}


@pytest.mark.parametrize("kernel_name", ["dp_locate_word32", "dp_locate_wide"])
@pytest.mark.parametrize("flags", [14, 11, 15, 8, 2])
@pytest.mark.parametrize("indel_cost", [1, 2, 3, 100000])
def test_kernel_equals_plain_version(card, kernel_name, flags, indel_cost):
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    kernel = getattr(cuda_kernel, kernel_name)
    aligner = cuda_kernel.CudaAligner(
        TRUSEQ, ERROR_RATE[indel_cost], flags, min_overlap=3,
        indel_cost=indel_cost, device=card,
    )
    assert aligner.k >= min(indel_cost, 3)
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


@pytest.mark.parametrize("kernel_name,m,e,L,indel_cost", [
    ("dp_locate_wide", 1200, 0.3, 3072, 100000),
    ("dp_locate_word32", 2000, 0.1, 2048, 100000),
    ("dp_locate_word32", 2000, 0.02, 2100, 3),
])
def test_adapter_beyond_shared_memory(card, kernel_name, m, e, L, indel_cost):
    """Adapters whose cell column does not fit shared memory even for one
    warp: the kernel keeps the column in global memory and still equals
    its plain version."""
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    kernel = getattr(cuda_kernel, kernel_name)
    rng = np.random.default_rng(m + L)
    adapter = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)].tobytes().decode()
    aligner = cuda_kernel.CudaAligner(
        adapter, e, 15, min_overlap=3, indel_cost=indel_cost, device=card
    )
    assert aligner.kernel_for(L) is kernel
    assert kernel.block_layout(m) == (cuda_kernel.THREADS_PER_BLOCK, True)
    reads, lengths = _batch(m, 128, L, adapter, 15)
    reads_T = torch.from_numpy(reads).to(card).T.contiguous()
    lens = torch.from_numpy(lengths).to(card)[None, :].contiguous()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    got = kernel(*args, **aligner._dp_params())
    torch.cuda.synchronize()
    expected = kernel.plain(*args, **aligner._dp_params())
    assert torch.equal(got, expected)
    assert int(expected[0].sum()) > 0


def _planes(seed, W, B, alphabet):
    rng = np.random.default_rng(seed)
    syms = np.frombuffer(alphabet, np.uint8)
    ref = syms[rng.integers(0, len(syms), (B, W))]
    query = syms[rng.integers(0, len(syms), (B, W))]
    lengths = rng.integers(0, W + 1, B).astype(np.int32)
    lengths[:2] = (0, W)
    shift = rng.integers(0, W, B)[:, None]
    shifted = np.take_along_axis(ref, (np.arange(W)[None, :] + shift) % W, axis=1)
    query = np.where((rng.random(B) < 0.25)[:, None], shifted, query)
    return ref.T.copy(), query.T.copy(), lengths


@pytest.mark.parametrize("kernel_name,W,alphabet", [
    ("diag_counts_u8", W, b"ACGTN") for W in (33, 64, 100, 150, 255)
] + [
    ("diag_counts_i32", W, alphabet)
    for W in (64, 255, 256, 300, 301)
    for alphabet in (b"ACGTN", b"ACGTNRYKMSWBDHVacgtn")
])
def test_diag_counts_equal_plain_version(card, kernel_name, W, alphabet):
    import torch

    from atropos_tpu_torch.align import insert_kernel

    kernel = getattr(insert_kernel, kernel_name)
    # 1000 pairs: no multiple of the warp width or of the block
    ref, query, lengths = _planes(W * len(alphabet), W, 1000, alphabet)
    args = [torch.from_numpy(x).to(card) for x in (ref, query, lengths)]
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    expected = kernel.plain(*args)
    assert kernel.launches == before + 1, "the plain version launches nothing"
    assert got.dtype == expected.dtype == kernel.out_dtype
    assert torch.equal(got, expected)
    assert int(expected.long().max()) > W // 4


def test_diag_wrappers_raise_instead_of_falling_back(card):
    import torch

    from atropos_tpu_torch.align import insert_kernel

    plane = torch.zeros((256, 64), dtype=torch.uint8, device=card)
    lengths = torch.zeros(64, dtype=torch.int32, device=card)
    before = insert_kernel.launch_counts()
    with pytest.raises(ValueError):  # 256 diagonals do not fit 8-bit counts
        insert_kernel.diag_counts_u8(plane, plane, lengths)
    with pytest.raises(ValueError):  # lengths on another device
        insert_kernel.diag_counts_i32(plane, plane, lengths.cpu())
    with pytest.raises(TypeError):
        insert_kernel.diag_counts_i32(plane.int(), plane.int(), lengths)
    assert insert_kernel.launch_counts() == before


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


@pytest.mark.parametrize("aligner,reads,counts_kernel", [
    ("insert", "paired", "diag_counts_u8"),
    ("insert", "long", "diag_counts_i32"),
    ("adapter", "paired", None),
])
def test_paired_trim_on_the_card_equals_trim_on_the_cpu(
    card, tmp_path, aligner, reads, counts_kernel
):
    from atropos_tpu_torch.__main__ import main
    from atropos_tpu_torch.align import cuda_kernel, insert_kernel

    data = os.path.join(os.path.dirname(__file__), "conformance", "data")
    if reads == "paired":
        inputs = [os.path.join(data, "big.{}.fq".format(i)) for i in (1, 2)]
    else:
        # mates of 300 bases: the matcher's window exceeds 255
        rng = np.random.default_rng(300)
        inputs = []
        inserts = rng.integers(100, 400, 200)
        frags = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (200, 400))]
        comp = bytes.maketrans(b"ACGT", b"TGCA")
        for mate in (1, 2):
            path = str(tmp_path / "long.{}.fastq".format(mate))
            with open(path, "w") as out:
                for i, (n, frag) in enumerate(zip(inserts, frags)):
                    ins = frag[:n].tobytes()
                    if mate == 2:
                        ins = ins.translate(comp)[::-1]
                    ad = (TRUSEQ if mate == 1 else "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")
                    seq = (ins.decode() + ad + "A" * 300)[:300]
                    out.write("@p{}/{}\n{}\n+\n{}\n".format(i, mate, seq, "I" * 300))
            inputs.append(path)
    outs = {}
    for device in ("cuda", "cpu"):
        paths = [str(tmp_path / "{}.{}.fastq".format(device, i)) for i in (1, 2)]
        cuda_kernel.reset_launch_counts()
        insert_kernel.reset_launch_counts()
        rc = main(
            ["trim", "--aligner", aligner, "-a", TRUSEQ,
             "-A", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT", "-q", "10",
             "-pe1", inputs[0], "-pe2", inputs[1], "-o", paths[0], "-p", paths[1],
             "--quiet", "--no-cache-adapters",
             "--report-file", str(tmp_path / "report.txt")],
            device=device,
        )
        assert rc == 0
        counts = dict(cuda_kernel.launch_counts(), **insert_kernel.launch_counts())
        if device == "cuda":
            assert counts["dp_locate_word32"] > 0
            for name in ("diag_counts_u8", "diag_counts_i32"):
                assert (counts[name] > 0) == (name == counts_kernel)
        else:
            assert sum(counts.values()) == 0
        outs[device] = []
        for path in paths:
            with open(path, "rb") as handle:
                outs[device].append(handle.read())
    assert outs["cuda"] == outs["cpu"] and all(outs["cuda"])


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


@pytest.mark.parametrize("L,N", [(104, 16384), (40, 34), (160, 2)])
@pytest.mark.parametrize("symbols", [4, 256])
def test_dtype_probe_kernels_equal_plain_version(card, L, N, symbols):
    import torch

    from atropos_tpu_torch.tools import dtype_probe

    reads = dtype_probe.make_reads(L * N + symbols, L, N, symbols, device=card)
    for kernel in dtype_probe.KERNELS:
        for dyn in (True, False):
            before = kernel.launches
            got = kernel(reads, dyn)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            expected = kernel.plain(reads, dyn)
            assert kernel.launches == before + 1, "the plain version launches nothing"
            assert torch.equal(got, expected)
            assert torch.equal(got, dtype_probe.probe_columns(reads, torch.int32, dyn))
            out, state = kernel(reads, dyn, state=True)
            torch.cuda.synchronize()
            assert torch.equal(out, expected)
            assert torch.equal(state, kernel.plain(reads, dyn, state=True)[1])


def test_dtype_probe_wrappers_raise_instead_of_falling_back(card):
    import torch

    from atropos_tpu_torch.tools import dtype_probe

    reads = torch.zeros((104, 33), dtype=torch.uint8, device=card)
    before = dtype_probe.launch_counts()
    with pytest.raises(ValueError):  # two reads a thread: N must be even
        dtype_probe.dtype_probe_i16x2(reads, True)
    with pytest.raises(TypeError):
        dtype_probe.dtype_probe_i32(reads.int(), True)
    with pytest.raises(ValueError):  # fewer columns than m
        dtype_probe.dtype_probe_i32(reads[:20].contiguous(), True)
    assert dtype_probe.launch_counts() == before


def test_dtype_probe_tool_on_the_card(card):
    from atropos_tpu_torch.tools import dtype_probe

    dtype_probe.reset_launch_counts()
    results = dtype_probe.main(["--shape", "104,2048", "--launches", "2"], device="cuda")
    assert len(results) == 4 and all(r["ms"] > 0 for r in results)
    assert all(r["device"] != "cpu (plain version)" for r in results)
    counts = dtype_probe.launch_counts()
    assert counts["dtype_probe_i32"] > 0 and counts["dtype_probe_i16x2"] > 0


def test_side_files_stats_and_demultiplexing_on_the_card(card, tmp_path):
    """Demultiplexed output, info, rest and wildcard files and ``--stats
    both`` on the card equal the same run on the CPU; the statistics'
    position counts ran on the card."""
    from atropos_tpu_torch.__main__ import main
    from atropos_tpu_torch.commands import stats

    data = os.path.join(
        os.path.dirname(__file__), "conformance", "data", "illumina.fastq.gz"
    )
    outs = {}
    for device in ("cuda", "cpu"):
        folder = tmp_path / device
        folder.mkdir()
        before = dict(stats.DEVICE_STATS_COUNTS)
        rc = main(
            ["trim", "-a", "adapt=GCCGAACTTCTTAGACTGCCTTAAGGACGT",
             "-a", "wild=ACGTNNNACGT", "-q", "10", "--stats", "both",
             "--info-file", str(folder / "info.txt"), "-r", str(folder / "rest.txt"),
             "--wildcard-file", str(folder / "wc.txt"),
             "-se", data, "-o", str(folder / "out.{name}.fastq"), "--quiet",
             "--no-cache-adapters", "--report-file", str(folder / "report.txt")],
            device=device,
        )
        assert rc == 0
        assert stats.DEVICE_STATS_COUNTS[device] > before[device]
        outs[device] = {}
        for name in sorted(os.listdir(str(folder))):
            with open(str(folder / name), "rb") as handle:
                data_bytes = handle.read()
            if name == "report.txt":  # its command line and times differ
                data_bytes = data_bytes[data_bytes.index(b"--------\nTrimming"):]
            outs[device][name] = data_bytes
    assert outs["cuda"] == outs["cpu"]
    assert "out.adapt.fastq" in outs["cuda"] and outs["cuda"]["info.txt"]


def test_overwrite_on_the_card_equals_the_golden(card, tmp_path):
    from atropos_tpu_torch.__main__ import main

    conformance = os.path.join(os.path.dirname(__file__), "conformance")
    outs = [str(tmp_path / "o.{}.fastq".format(i)) for i in (1, 2)]
    rc = main(
        ["trim", "-w", "10,30,10",
         "-pe1", os.path.join(conformance, "data", "lowq.fastq"),
         "-pe2", os.path.join(conformance, "data", "highq.fastq"),
         "-o", outs[0], "-p", outs[1], "--quiet", "--no-cache-adapters",
         "--report-file", str(tmp_path / "report.txt")],
        device="cuda",
    )
    assert rc == 0
    for out, golden in zip(outs, ("lowq.fastq", "highq.fastq")):
        with open(out, "rb") as got, open(
            os.path.join(conformance, "expected", golden), "rb"
        ) as want:
            assert got.read() == want.read()
