"""Differential tests of the port's adapter DP (atropos_tpu_torch.align).

The same reads, made from a seed, go through the scalar oracle, the JAX
package's ``BatchAligner`` and ``PallasAligner`` (interpret mode, as
``tests/test_pallas_align.py`` runs it) and through the port's plain
PyTorch DP, reached through the CPU path of both kernel wrappers
(``dp_locate_word32`` / ``dp_locate_wide`` on CPU tensors). The port is fed
the JAX package's own compiled adapter tables. Tolerance 0: every value is
an integer. The CUDA kernels themselves run only on a card, where
``chip_smoke.py`` holds them against the same plain version.
"""
import zlib

import numpy as np
import pytest
import torch

from atropos_tpu.align import oracle
from atropos_tpu.align import pallas_kernel
from atropos_tpu.align.batched import BatchAligner as JaxBatchAligner
from atropos_tpu.align.batched import encode_reads
from atropos_tpu_torch.align import cuda_kernel
from atropos_tpu_torch.align.batched import RESULT_ROWS
from atropos_tpu_torch.align.batched import encode_reads as torch_encode_reads

from .test_batched_align import BACK, FLAG_CASES, FRONT, PREFIX, SUFFIX

# the tensors here are small: one thread per test process is fastest and
# keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

WRAPPERS = {
    "word32": cuda_kernel.dp_locate_word32,
    "wide": cuda_kernel.dp_locate_wide,
}
#: reads that also go through interpret-mode Pallas (it is slow on the CPU)
PALLAS_READS = 24


def seeded(*key):
    """A numpy generator whose seed is a stable function of ``key``."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _bases(rng, count, alphabet="ACGT"):
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), count))


def _random_read(rng, adapter, flags, min_len=5, max_len=120):
    """Read with a planted (mutated) adapter occurrence more than half the
    time, placed where an adapter of this type would sit."""
    n = int(rng.integers(min_len, max_len + 1))
    read = list(_bases(rng, n))
    if rng.random() < 0.6 and n > 8:
        frag = list(adapter)
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(len(frag)))] = _bases(rng, 1)
        if rng.random() < 0.3 and len(frag) > 2:
            del frag[int(rng.integers(len(frag)))]
        if rng.random() < 0.2:
            frag.insert(int(rng.integers(len(frag))), _bases(rng, 1))
        frag = frag[: int(rng.integers(3, len(frag) + 1))]
        if flags in (PREFIX, FRONT):
            pos = 0
        elif flags in (SUFFIX, BACK):
            pos = max(0, n - len(frag))
        else:
            pos = int(rng.integers(max(1, n - len(frag))))
        read[pos : pos + len(frag)] = frag
        read = read[:n]
    return "".join(read)


def _jax_aligner(cls, args):
    return cls(
        args["reference"],
        args["max_error_rate"],
        args["flags"],
        wildcard_ref=args.get("wildcard_ref", False),
        wildcard_query=args.get("wildcard_query", False),
        min_overlap=args.get("min_overlap", 1),
        indel_cost=args.get("indel_cost", 1),
    )


def _port_rows(pallas, reads_u8, lengths, wrapper):
    """[7, B] result of the port's wrapper on CPU tensors, computed from
    the Pallas aligner's own tables."""
    aligner = cuda_kernel.aligner_from_numpy(
        pallas._ref_np,
        pallas._thresholds_np,
        pallas._query_lut_np,
        m=pallas.m,
        k=pallas.k,
        flags=pallas.flags,
        min_overlap=pallas.min_overlap,
        indel_cost=pallas.indel_cost,
        compare_ascii=pallas._compare_ascii,
        device="cpu",
    )
    reads = torch.from_numpy(np.ascontiguousarray(reads_u8))
    if not pallas._compare_ascii:
        reads = aligner.query_lut[reads.long()]
    lens = torch.from_numpy(np.asarray(lengths, np.int32).reshape(1, -1))
    before = wrapper.launches
    out = wrapper(
        reads.T.contiguous(), lens, aligner.ref_bytes, aligner.thresholds,
        **aligner._dp_params(),
    )
    assert wrapper.launches == before, "a CPU call must not count a launch"
    assert out.dtype == torch.int32 and tuple(out.shape) == (8, len(lengths))
    assert int(out[7].abs().sum()) == 0
    return out.numpy()[:7]


def _rows_of(result):
    return np.stack(
        [np.asarray(result[name]).astype(np.int64) for name in RESULT_ROWS]
    )


def _assert_parity(args, reads, label, wrappers=("word32",)):
    scalar = oracle.Aligner(**args)
    pallas = _jax_aligner(pallas_kernel.PallasAligner, args)
    pallas.INTERPRET = True
    arr, lengths = encode_reads(reads)
    assert np.array_equal(arr, torch_encode_reads(reads)[0])
    if arr.shape[1] == 0:
        arr = np.zeros((len(reads), 8), np.uint8)
    jax_rows = _rows_of(_jax_aligner(JaxBatchAligner, args).locate_batch(arr, lengths))
    few = slice(0, PALLAS_READS)
    pallas_rows = _rows_of(pallas.locate_batch(arr[few], lengths[few]))
    for which in wrappers:
        rows = _port_rows(pallas, arr, lengths, WRAPPERS[which])
        for idx, read in enumerate(reads):
            expected = scalar.locate(read)
            got = (
                tuple(int(v) for v in rows[1:, idx]) if rows[0, idx] else None
            )
            assert got == expected, "{}/{}: read {} ({!r}): {} != {}".format(
                label, which, idx, read, got, expected
            )
        assert np.array_equal(rows, jax_rows), label + ": vs BatchAligner"
        assert np.array_equal(rows[:, few], pallas_rows), label + ": vs Pallas"


@pytest.mark.parametrize("name,flags", FLAG_CASES)
@pytest.mark.parametrize("indel_cost", [1, 100000])
def test_torch_parity(name, flags, indel_cost):
    rng = seeded(name, indel_cost, "torch")
    adapter = "TTAGACATATCTCCGTCG"
    reads = ["", "A", adapter, adapter * 2, adapter[:4]]
    reads += [_random_read(rng, adapter, flags) for _ in range(50)]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            min_overlap=3,
            indel_cost=indel_cost,
        ),
        reads,
        "torch/{}/ic{}".format(name, indel_cost),
        wrappers=("word32", "wide"),
    )


@pytest.mark.parametrize("name,flags", FLAG_CASES[:2])
def test_torch_parity_wildcards(name, flags):
    rng = seeded(name, "wc")
    adapter = "ACGTNNNACGTRYK"
    reads = [_random_read(rng, "ACGTACGACGTAGA", flags) for _ in range(30)]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            wildcard_ref=True,
            min_overlap=3,
        ),
        reads,
        "torch-wc/" + name,
    )


@pytest.mark.parametrize("name,flags", FLAG_CASES[:2])
def test_torch_parity_read_wildcards(name, flags):
    rng = seeded(name, "rwc")
    adapter = "ACGTACGACGTAGA"
    reads = [
        _random_read(rng, adapter, flags).replace("G", "N", 1)
        for _ in range(30)
    ]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.15,
            flags=flags,
            wildcard_query=True,
            min_overlap=3,
        ),
        reads,
        "torch-rwc/" + name,
    )


@pytest.mark.parametrize("max_error_rate", [0.0, 0.049, 0.2, 0.34])
@pytest.mark.parametrize("indel_cost", [1, 2, 3])
def test_torch_scan_window_edges(max_error_rate, indel_cost):
    """Reads whose adapter hit carries insertion runs of exactly k, k+1
    and 2k bases: chains at and just past the cutoff of the insertion
    relaxation."""
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"  # m=33 -> k up to 11
    k = int(max_error_rate * len(adapter))
    rng = seeded(max_error_rate, indel_cost)
    reads = []
    for run in {max(1, k), k + 1, 2 * k + 1}:
        for cut in (8, 16, len(adapter)):
            frag = adapter[:cut]
            pos = int(rng.integers(2, max(3, cut - 2) + 1))
            ins = _bases(rng, run)
            prefix = _bases(rng, 20)
            reads.append(prefix + frag[:pos] + ins + frag[pos:])
    reads += [_random_read(rng, adapter, FLAG_CASES[0][1]) for _ in range(30)]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=max_error_rate,
            flags=FLAG_CASES[0][1],
            min_overlap=3,
            indel_cost=indel_cost,
        ),
        reads,
        "torch-window/e{}/ic{}".format(max_error_rate, indel_cost),
    )


def test_torch_literal_n():
    """ASCII mode must treat 'N'=='N' as a match (exact byte compare)."""
    _assert_parity(
        dict(
            reference="NNNNNN",
            max_error_rate=0.2,
            flags=FLAG_CASES[0][1],
            min_overlap=3,
        ),
        ["ACGTNNNNNNACGT", "NNNNNN", "ACGTACGT"],
        "torch-literalN",
        wrappers=("word32", "wide"),
    )


@pytest.mark.parametrize("name,flags", [FLAG_CASES[0], FLAG_CASES[4]])
def test_torch_wide_configuration(name, flags):
    """m = 120, e = 0.1, L = 160: the JAX package's one-word layout does
    not fit (``_fused_layout`` is None) and it runs its two-plane kernel;
    the port's counterpart of that kernel is ``dp_locate_wide``."""
    rng = seeded("wide", name)
    adapter = _bases(rng, 120)
    assert pallas_kernel._fused_layout(120, 12, 160) is None
    reads = [
        _random_read(rng, adapter, flags, min_len=100, max_len=160)
        for _ in range(22)
    ]
    reads += ["", "C", adapter + "ACGTACGT" * 5]
    assert max(len(r) for r in reads) == 160
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            min_overlap=3,
        ),
        reads,
        "torch-wide/" + name,
        wrappers=("wide", "word32"),
    )


@pytest.mark.parametrize("indel_cost", [1, 100000])
def test_torch_long_reads(indel_cost):
    """Reads longer than 255 bases (the flat 7-row bundle regime)."""
    rng = seeded("long", indel_cost)
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    flags = FLAG_CASES[0][1]
    reads = [
        _random_read(rng, adapter, flags, min_len=240, max_len=300)
        for _ in range(20)
    ]
    reads += ["", "G", "ACGT" * 75 + adapter]
    _assert_parity(
        dict(
            reference=adapter,
            max_error_rate=0.1,
            flags=flags,
            min_overlap=3,
            indel_cost=indel_cost,
        ),
        reads,
        "torch-long/ic{}".format(indel_cost),
        wrappers=("word32", "wide"),
    )


@pytest.mark.parametrize("name,flags", FLAG_CASES)
def test_torch_lengths_zero_and_one(name, flags):
    """Batches made only of empty and one-base reads."""
    adapter = "TTAGACATATCTCCGTCG"
    _assert_parity(
        dict(reference=adapter, max_error_rate=0.2, flags=flags, min_overlap=1),
        ["", "T", "", "G", "A", ""],
        "torch-tiny/" + name,
        wrappers=("word32", "wide"),
    )


@pytest.mark.parametrize(
    "m,k,L,fits32,fits64",
    [
        (33, 3, 160, True, True),
        (120, 12, 160, True, True),
        (120, 24, 320, True, True),
        (900, 180, 16384, False, True),
        (4000, 400, 60000, False, True),
    ],
)
def test_torch_cell_layout(m, k, L, fits32, fits64):
    """The port computes its own cell layout: every field holds its range
    and the word is chosen by what fits."""
    assert cuda_kernel.dp_locate_word32.fits(m, k, L) is fits32
    assert cuda_kernel.dp_locate_wide.fits(m, k, L) is fits64
    mat_bits, org_bits = cuda_kernel.cell_layout(m, k, L, 64)
    assert (1 << mat_bits) > m and (1 << org_bits) > L + m
    aligner = cuda_kernel.CudaAligner.from_tables(
        np.zeros(m, np.uint8), np.zeros(m + 1, np.int32),
        np.arange(256, dtype=np.uint8), m=m, k=k, flags=14, min_overlap=3,
        indel_cost=1, compare_ascii=True, device="cpu",
    )
    expected = "dp_locate_word32" if fits32 else "dp_locate_wide"
    assert aligner.kernel_for(L).name == expected


def test_torch_wrapper_rejects_bad_arguments():
    ref = torch.zeros(4, dtype=torch.uint8)
    thr = torch.zeros(5, dtype=torch.int32)
    lens = torch.zeros((1, 8), dtype=torch.int32)
    params = dict(m=4, k=0, flags=14, min_overlap=1, ins_cost=1, del_cost=1,
                  compare_ascii=True)
    good = torch.zeros((8, 8), dtype=torch.uint8)
    cuda_kernel.dp_locate_word32(good, lens, ref, thr, **params)
    with pytest.raises(TypeError):
        cuda_kernel.dp_locate_word32(good.int(), lens, ref, thr, **params)
    with pytest.raises(ValueError):
        cuda_kernel.dp_locate_word32(good.T, lens, ref, thr, **params)
    with pytest.raises(TypeError):
        cuda_kernel.dp_locate_word32(good, lens.long(), ref, thr, **params)
    with pytest.raises(TypeError):
        cuda_kernel.dp_locate_word32(good, lens, ref, thr[:4], **params)
    with pytest.raises(ValueError):
        cuda_kernel.dp_locate_word32.plain(
            torch.zeros((16384, 8), dtype=torch.uint8), lens,
            torch.zeros(900, dtype=torch.uint8),
            torch.zeros(901, dtype=torch.int32),
            **dict(params, m=900, k=180),
        )
