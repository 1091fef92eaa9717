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


#: adapter lengths on both sides of each row cap of dp_locate_word32's
#: register column (m + 1 rows of 16, 32, 48, 64), and 64, the first
#: served from shared memory
ROW_CAP_MS = (15, 16, 31, 32, 47, 48, 63, 64)
FLAG_SETS = (14, 11, 15, 8, 2)


@pytest.mark.parametrize("flags", FLAG_SETS)
@pytest.mark.parametrize("m", ROW_CAP_MS)
def test_register_column_equals_plain_version(card, m, flags):
    """Each register instantiation (and the shared-memory one at m = 64)
    against the plain version: every flag set, both compare modes for
    each m, the indel costs 1, 2, 3 and 100000, error rates 0.1 to 0.3
    and L of 32, 160 and 320 in turn."""
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    i = ROW_CAP_MS.index(m) + FLAG_SETS.index(flags)
    indel_cost = (1, 2, 3, 100000)[i % 4]
    e = {1: (0.1, 0.2, 0.3)[i % 3], 2: 0.2, 3: 0.3, 100000: (0.3, 0.1)[i % 2]}[indel_cost]
    L = (32, 160, 320)[(i // 2) % 3]
    if flags in (8, 2) and L < 2 * m:
        L = 160  # an anchored adapter needs reads longer than itself
    wild = bool((ROW_CAP_MS.index(m) + i) % 2)
    rng = np.random.default_rng(m * 16 + flags)
    letters = np.frombuffer(b"ACGTNRY" if wild else b"ACGT", np.uint8)
    adapter = letters[rng.integers(0, len(letters), m)].tobytes().decode()
    kernel = cuda_kernel.dp_locate_word32
    aligner = cuda_kernel.CudaAligner(
        adapter, e, flags, wildcard_ref=wild, min_overlap=3,
        indel_cost=indel_cost, device=card,
    )
    how = kernel.instantiation(m, aligner.k, L)
    if m < 64:
        assert how.kind == "registers" and how.row_cap >= m + 1 > how.row_cap - 16
    else:
        assert how.kind == "shared"
    # planted copies carry a base that each wildcard matches
    planted = adapter.translate(str.maketrans("NRY", "AAC"))
    reads, lengths = _batch(m + flags, 512, L, planted, flags)
    dev = torch.from_numpy(reads).to(card)
    if not aligner._compare_ascii:
        dev = aligner.query_lut[dev.long()]
    reads_T = dev.T.contiguous()
    lens = torch.from_numpy(lengths).to(card)[None, :].contiguous()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    before = kernel.launches
    got = kernel(*args, **aligner._dp_params())
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    expected = kernel.plain(*args, **aligner._dp_params())
    assert torch.equal(got, expected)
    assert int(expected[0].sum()) > 0


#: adapter lengths on both sides of the boundary of dp_locate_wide's strips
#: of 28 rows a lane: m + 1 = 32 R - 1, 32 R and 32 R + 1 (row m the last
#: but one, the last row of lane 31, and itself the last row of all)
STRIP_MS = (894, 895, 896)


@pytest.mark.parametrize("flags", FLAG_SETS)
@pytest.mark.parametrize("m", STRIP_MS)
def test_strips_equal_plain_version(card, m, flags):
    """dp_locate_wide one warp a read against the plain version: every flag
    set, indel costs 1, 2, 3 and 100000 and both compare modes in turn, on
    128 reads of up to 1,856 bases. A 32-bit cell holds these shapes, so a
    call would take one read a thread; the test names the strips."""
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    i = STRIP_MS.index(m) + FLAG_SETS.index(flags)
    indel_cost = (1, 2, 3, 100000)[i % 4]
    e = {1: 0.3, 2: 0.2, 3: 0.3, 100000: (0.3, 0.1)[i % 2]}[indel_cost]
    wild = bool((STRIP_MS.index(m) + i) % 2)
    L = 2 * m + 64
    rng = np.random.default_rng(m * 16 + flags)
    letters = np.frombuffer(b"ACGTNRY" if wild else b"ACGT", np.uint8)
    adapter = letters[rng.integers(0, len(letters), m)].tobytes().decode()
    kernel = cuda_kernel.dp_locate_wide
    aligner = cuda_kernel.CudaAligner(
        adapter, e, flags, wildcard_ref=wild, min_overlap=3,
        indel_cost=indel_cost, device=card,
    )
    # past one warp's shared column: one read a thread works in global memory
    assert kernel.instantiation(m, aligner.k, L).kind == "global"
    assert kernel.holds_strips(m, aligner.k, L)
    how = cuda_kernel.Instantiation("warps", cuda_kernel.STRIP_ROWS, cuda_kernel.STRIP_THREADS)
    planted = adapter.translate(str.maketrans("NRY", "AAC"))
    reads, lengths = _batch(m + flags, 128, L, planted, flags)
    if flags in (8, 2):
        # an anchored adapter matches whole: every fourth read carries it
        whole = np.frombuffer(planted.encode(), np.uint8)
        for row in range(3, 128, 4):
            at = 0 if flags == 8 else int(lengths[row]) - m
            if lengths[row] >= m:
                reads[row, at : at + m] = whole
    dev = torch.from_numpy(reads).to(card)
    if not aligner._compare_ascii:
        dev = aligner.query_lut[dev.long()]
    reads_T = dev.T.contiguous()
    lens = torch.from_numpy(lengths).to(card)[None, :].contiguous()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    before = kernel.launches
    got = kernel.launch(*args, how, **aligner._dp_params())
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    expected = kernel.plain(*args, **aligner._dp_params())
    assert torch.equal(got, expected)
    assert int(expected[0].sum()) > 0


def test_strips_fix_up_crosses_lanes(card):
    """Reads that lack 90 bases of an 880-base adapter, none of which
    matches the read base before the gap: in the column after it rows
    401-490 follow one another by insertions, across lanes 14-17 of the
    strips. The fix-up then takes more than one round in some columns
    (the instrumented launch's counts), and the result equals the plain
    version's."""
    import torch

    from atropos_tpu_torch.align import cuda_kernel

    rng = np.random.default_rng(90)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ad = bases[rng.integers(0, 4, 880)].copy()
    ad[399] = ord("A")
    ad[400:490] = np.frombuffer(b"CGT", np.uint8)[rng.integers(0, 3, 90)]
    adapter = ad.tobytes().decode()
    B, L = 64, 1024
    reads = bases[rng.integers(0, 4, (B, L))].copy()
    gapped = np.frombuffer((adapter[:400] + adapter[490:]).encode(), np.uint8)
    for row in range(B):
        at = 20 + row
        reads[row, at : at + len(gapped)] = gapped[: L - at]
    lengths = np.full(B, L, np.int32)
    kernel = cuda_kernel.dp_locate_wide
    aligner = cuda_kernel.CudaAligner(adapter, 0.3, 14, min_overlap=3, indel_cost=1,
                                      device=card)
    reads_T = torch.from_numpy(reads).to(card).T.contiguous()
    lens = torch.from_numpy(lengths).to(card)[None, :].contiguous()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    # a 32-bit cell holds this shape: the test names the strips
    assert kernel.holds_strips(880, aligner.k, L)
    how = cuda_kernel.Instantiation("warps", cuda_kernel.STRIP_ROWS, cuda_kernel.STRIP_THREADS)
    stats = torch.zeros(3, dtype=torch.int64, device=card)
    got = kernel.launch(*args, how, stats=stats, **aligner._dp_params())
    expected = kernel.plain(*args, **aligner._dp_params())
    assert torch.equal(got, expected)
    assert expected[6].tolist() == [90] * B  # the gap is the cost
    columns, rounds, fix_rows = stats.tolist()
    assert rounds > columns > 0 and fix_rows > 0, stats.tolist()


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
    assert kernel.instantiation(m, aligner.k, L).kind == "global"
    reads, lengths = _batch(m, 128, L, adapter, 15)
    reads_T = torch.from_numpy(reads).to(card).T.contiguous()
    lens = torch.from_numpy(lengths).to(card)[None, :].contiguous()
    args = (reads_T, lens, aligner.ref_bytes, aligner.thresholds)
    got = kernel(*args, **aligner._dp_params())
    torch.cuda.synchronize()
    expected = kernel.plain(*args, **aligner._dp_params())
    assert torch.equal(got, expected)
    assert int(expected[0].sum()) > 0


def _planes(seed, W, B, alphabet, lengths="within"):
    """Lengths in [0, W] or, for ``"wrap"``, in (W, 2W] (2W and W + 1
    among them), where the plain version wraps."""
    rng = np.random.default_rng(seed)
    syms = np.frombuffer(alphabet, np.uint8)
    ref = syms[rng.integers(0, len(syms), (B, W))]
    query = syms[rng.integers(0, len(syms), (B, W))]
    if lengths == "wrap":
        m = rng.integers(W + 1, 2 * W + 1, B).astype(np.int32)
        m[:2] = (2 * W, W + 1)
    else:
        m = rng.integers(0, W + 1, B).astype(np.int32)
        m[:2] = (0, W)
    shift = rng.integers(0, W, B)[:, None]
    shifted = np.take_along_axis(ref, (np.arange(W)[None, :] + shift) % W, axis=1)
    query = np.where((rng.random(B) < 0.25)[:, None], shifted, query)
    return ref.T.copy(), query.T.copy(), m


ALL_BYTES = bytes(range(256))


@pytest.mark.parametrize("kernel_name,W,alphabet,lengths", [
    ("diag_counts_u8", W, b"ACGTN", "within") for W in (33, 64, 100, 150, 255)
] + [
    ("diag_counts_i32", W, alphabet, "within")
    for W in (64, 255, 256, 300, 301)
    for alphabet in (b"ACGTN", b"ACGTNRYKMSWBDHVacgtn")
] + [
    # the bit planes' word edges, every byte value, lengths past W
    ("diag_counts_u8", W, b"ACGTN", "within") for W in (31, 32, 63, 65, 96, 97)
] + [
    ("diag_counts_i32", W, b"ACGTN", "within") for W in (288, 289, 320, 512)
] + [
    ("diag_counts_u8", W, ALL_BYTES, lengths) for W in (1, 32, 97, 160, 255)
    for lengths in ("within", "wrap")
] + [
    # 512: a tile of 16 pairs in one slab; 1500, 3000 and 24000: 16 pairs
    # in slabs (1,000 pairs: staged a byte a thread); at 24000 one pair's
    # whole planes exceed a block's shared memory (above about 21,000)
    ("diag_counts_i32", W, ALL_BYTES, lengths)
    for W in (1, 33, 256, 289, 320, 512, 1500, 3000, 24000)
    for lengths in ("within", "wrap")
])
def test_diag_counts_equal_plain_version(card, kernel_name, W, alphabet, lengths):
    import torch

    from atropos_tpu_torch.align import insert_kernel

    kernel = getattr(insert_kernel, kernel_name)
    # 1000 pairs: no multiple of the warp width or of the block's tile
    ref, query, m = _planes(W * len(alphabet) + (lengths == "wrap"), W, 1000, alphabet, lengths)
    args = [torch.from_numpy(x).to(card) for x in (ref, query, m)]
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


@pytest.mark.parametrize("L,N", [(104, 16384), (40, 34), (160, 2), (104, 1002), (160, 16386)])
@pytest.mark.parametrize("symbols", [4, 256, "equal", "distinct", "alternating"])
def test_dtype_probe_kernels_equal_plain_version(card, L, N, symbols):
    """Random bytes below ``symbols``, or one of ``dtype_probe.PLANES``; N
    of 1,002 and 16,386 reads is no multiple of any block width."""
    import torch

    from atropos_tpu_torch.tools import dtype_probe

    if symbols in dtype_probe.PLANES:
        reads = dtype_probe.make_plane(symbols, L * N, L, N, device=card)
    else:
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
