"""The insert matcher of the port against the JAX package.

The port's ``_diagonal_match_counts`` and the plain versions of
``diag_counts_u8`` and ``diag_counts_i32`` (what their wrappers run on CPU
tensors) against ``atropos_tpu``'s ``_diagonal_match_counts`` and its two
Pallas kernels in interpret mode (``PallasPackedInsertMatcher``,
``PallasInsertMatcher``); ``insert_candidate_slots`` and
``BatchInsertMatcher.candidate_arrays`` against theirs, including a
near-poly-A batch whose candidate streams overflow the slots.

All inputs are made from a seed with numpy; tolerance 0 (integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atropos_tpu.align import batched as jax_batched
from atropos_tpu.align import pallas_kernel
from atropos_tpu_torch.align import batched as port_batched
from atropos_tpu_torch.align import insert_kernel

from .test_torch_align import seeded

torch.set_num_threads(1)

ACGTN = b"ACGTN"
MANY = b"ACGTNRYKMSWBDHVacgtn"  # more than the packed kernel's 14 symbols


def planes(rng, W, B, alphabet, match_share=0.25):
    """[W, B] uint8 ref and query planes and [B] int32 lengths in [0, W]:
    in ``match_share`` of the pairs the query is the ref read from a random
    diagonal on, with a few bytes replaced."""
    syms = np.frombuffer(alphabet, np.uint8)
    ref = syms[rng.integers(0, len(syms), (B, W))]
    query = syms[rng.integers(0, len(syms), (B, W))]
    lengths = rng.integers(0, W + 1, B).astype(np.int32)
    lengths[:3] = (0, W, 1)
    shift = rng.integers(0, W, B)[:, None]
    shifted = np.take_along_axis(ref, (np.arange(W)[None, :] + shift) % W, axis=1)
    shifted = np.where(rng.random((B, W)) < 0.05, query, shifted)
    query = np.where((rng.random(B) < match_share)[:, None], shifted, query)
    return np.ascontiguousarray(ref.T), np.ascontiguousarray(query.T), lengths


def jax_counts(ref_T, query_T, lengths):
    return np.array(
        jax_batched._diagonal_match_counts(
            jnp.asarray(ref_T.astype(np.int32)),
            jnp.asarray(query_T.astype(np.int32)),
            jnp.asarray(lengths[None, :]),
        )
    )


@pytest.mark.parametrize("W", [33, 64, 100, 255, 300])
@pytest.mark.parametrize("alphabet", [ACGTN, MANY], ids=["5sym", "20sym"])
def test_diagonal_match_counts_equal_reference(W, alphabet):
    ref_T, query_T, lengths = planes(seeded("diag", W, len(alphabet)), W, 96, alphabet)
    expected = jax_counts(ref_T, query_T, lengths)
    got = port_batched._diagonal_match_counts(
        torch.from_numpy(ref_T), torch.from_numpy(query_T),
        torch.from_numpy(lengths)[None, :],
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), expected)
    assert expected.max() > W // 4


@pytest.mark.parametrize("W", [33, 64, 100, 255])
def test_diag_counts_u8_equals_packed_pallas_kernel(W):
    """The 8-bit wrapper on CPU tensors against the TPU's packed kernel in
    interpret mode, on the alphabet the turbo step gives it."""
    alphabet = b"ACGTNacgtn"
    ref_T, query_T, lengths = planes(seeded("packed", W), W, 256, alphabet)
    matcher = pallas_kernel.PallasPackedInsertMatcher(alphabet)
    matcher.INTERPRET = True
    matcher.BLOCK = 128
    assert matcher.usable(W)
    expected = np.asarray(
        matcher.counts(
            jnp.asarray(ref_T.astype(np.int32)),
            jnp.asarray(query_T.astype(np.int32)),
            jnp.asarray(lengths[None, :]),
        )
    )
    before = insert_kernel.diag_counts_u8.launches
    got = insert_kernel.diag_counts_u8(
        torch.from_numpy(ref_T), torch.from_numpy(query_T), torch.from_numpy(lengths)
    )
    assert insert_kernel.diag_counts_u8.launches == before, "CPU tensors launch nothing"
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy().astype(np.int32), expected)


@pytest.mark.parametrize("W", [33, 64, 100, 255, 300])
def test_diag_counts_i32_equals_pallas_kernel(W):
    """The 32-bit wrapper on CPU tensors against the TPU's unpacked kernel
    in interpret mode, with more symbols than the packed kernel codes."""
    ref_T, query_T, lengths = planes(seeded("unpacked", W), W, 256, MANY)
    matcher = pallas_kernel.PallasInsertMatcher()
    matcher.INTERPRET = True
    matcher.BLOCK = 128
    expected = np.asarray(
        matcher.counts(
            jnp.asarray(ref_T.astype(np.int32)),
            jnp.asarray(query_T.astype(np.int32)),
            jnp.asarray(lengths[None, :]),
        )
    )
    got = insert_kernel.diag_counts_i32(
        torch.from_numpy(ref_T), torch.from_numpy(query_T), torch.from_numpy(lengths)
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), expected)
    assert np.array_equal(
        insert_kernel.diag_counts_i32.plain(
            torch.from_numpy(ref_T), torch.from_numpy(query_T),
            torch.from_numpy(lengths),
        ).numpy(),
        expected,
    )


def test_wrappers_check_their_inputs():
    plane = torch.zeros((256, 40), dtype=torch.uint8)
    lengths = torch.zeros(40, dtype=torch.int32)
    with pytest.raises(ValueError):  # 256 diagonals do not fit 8-bit counts
        insert_kernel.diag_counts_u8(plane, plane, lengths)
    with pytest.raises(TypeError):
        insert_kernel.diag_counts_i32(plane.int(), plane.int(), lengths)
    with pytest.raises(TypeError):
        insert_kernel.diag_counts_i32(plane, plane, lengths.long())
    with pytest.raises(ValueError):
        insert_kernel.diag_counts_i32(plane, plane[:100], lengths)
    with pytest.raises(ValueError):
        insert_kernel.diag_counts_i32(plane.T, plane.T, torch.zeros(256, dtype=torch.int32))


@pytest.mark.parametrize("W,n_symbols,name", [
    (160, 10, "diag_counts_u8"), (255, 14, "diag_counts_u8"),
    (256, 5, "diag_counts_i32"), (160, 15, "diag_counts_i32"),
])
def test_kernel_selection_follows_the_reference_predicate(W, n_symbols, name):
    """Each CUDA kernel serves where its Pallas kernel serves: the packed
    one for windows <= 255 and at most 14 symbols."""
    matcher = pallas_kernel.PallasPackedInsertMatcher(bytes(range(65, 65 + n_symbols)))
    assert matcher.usable(W) == (name == "diag_counts_u8")
    assert insert_kernel.kernel_for(W, n_symbols).name == name


# -- candidate slots and the host reconstruction ------------------------------


def pair_planes(rng, B, W, poly_a=0):
    """[B, W] uint8 ref (reversed complemented mate 2) and query (mate 1)
    planes as the pair step builds them, with per-pair lengths: pairs that
    overlap at a random offset with 3 % substitutions, random pairs, and
    ``poly_a`` near-poly-A pairs first (dozens of admissible diagonals)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    m = rng.integers(0, W + 1, B).astype(np.int32)
    m[:2] = (0, W)
    ref = bases[rng.integers(0, 4, (B, W))]
    query = bases[rng.integers(0, 4, (B, W))]
    shift = rng.integers(0, W // 2 + 1, B)[:, None]
    t = np.arange(W)[None, :]
    overlapping = np.take_along_axis(ref, np.clip(t + shift, 0, W - 1), axis=1)
    overlapping = np.where(rng.random((B, W)) < 0.03, query, overlapping)
    query = np.where((rng.random(B) < 0.5)[:, None], overlapping, query)
    ref[:poly_a] = ord("A")
    query[:poly_a] = ord("A")
    query[np.arange(poly_a), rng.integers(5, W - 5, poly_a)] = ord("C")
    m[:poly_a] = W
    ref[t >= m[:, None]] = 0
    return ref, query, m


def slot_cases():
    return [
        ("err0.1", 0.1, 160, 0), ("err0.2", 0.2, 160, 0),
        ("err0.2-w64", 0.2, 64, 0), ("poly-a", 0.2, 100, 12),
        ("poly-a-err0.1", 0.1, 100, 12),
    ]


@pytest.mark.parametrize(
    "name,err,W,poly_a", slot_cases(), ids=[c[0] for c in slot_cases()]
)
def test_insert_candidate_slots_equal_reference(name, err, W, poly_a):
    ref, query, m = pair_planes(seeded("slots", name), 200, W, poly_a)
    counts = jax_counts(np.ascontiguousarray(ref.T), np.ascontiguousarray(query.T), m)
    min_overlap, max_matches = 1, 100
    exp_slots, exp_meta = jax_batched.insert_candidate_slots(
        jnp.asarray(counts), jnp.asarray(m), jnp.asarray(ref.astype(np.int32)),
        jnp.asarray(query.astype(np.int32)), err, min_overlap, max_matches,
    )
    table = torch.from_numpy(port_batched.insert_step_table(err, 255))
    slots, meta = port_batched.insert_candidate_slots(
        torch.from_numpy(counts), torch.from_numpy(m), torch.from_numpy(ref),
        torch.from_numpy(query), table, min_overlap, max_matches,
    )
    assert np.array_equal(slots.numpy(), np.asarray(exp_slots))
    assert np.array_equal(meta.numpy(), np.asarray(exp_meta))
    overflow = meta.numpy()[0] > port_batched.INSERT_CANDIDATE_SLOTS
    assert overflow[:poly_a].all() if poly_a else not overflow.any()


def test_insert_candidate_slots_from_8bit_counts():
    """The turbo step hands the slots the 8-bit counts of diag_counts_u8."""
    ref, query, m = pair_planes(seeded("slots-u8"), 128, 160, 4)
    counts = jax_counts(np.ascontiguousarray(ref.T), np.ascontiguousarray(query.T), m)
    table = torch.from_numpy(port_batched.insert_step_table(0.2, 255))
    args = (torch.from_numpy(m), torch.from_numpy(ref), torch.from_numpy(query), table, 1, 100)
    wide = port_batched.insert_candidate_slots(torch.from_numpy(counts), *args)
    narrow = port_batched.insert_candidate_slots(
        torch.from_numpy(counts.astype(np.uint8)), *args
    )
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


@pytest.mark.parametrize("err", [0.1, 0.2])
def test_insert_step_table_is_the_float64_floor(err):
    table = port_batched.insert_step_table(err, 255)
    assert table.dtype == np.int32 and table.shape == (256,)
    assert [int(x) for x in table] == [int(np.floor(s * err)) for s in range(256)]
    assert np.array_equal(port_batched.insert_step_table(err, 100), table[:101])


@pytest.mark.parametrize("err,poly_a", [(0.1, 0), (0.2, 0), (0.2, 10)])
def test_candidate_arrays_equal_reference(err, poly_a):
    ref, query, m = pair_planes(seeded("cand", err, poly_a), 150, 120, poly_a)
    counts = jax_counts(np.ascontiguousarray(ref.T), np.ascontiguousarray(query.T), m)
    expected = jax_batched.BatchInsertMatcher(err, 1, max_matches=100).candidate_arrays(
        counts, ref, query, m
    )
    got = port_batched.BatchInsertMatcher(err, 1, max_matches=100).candidate_arrays(
        counts, ref, query, m
    )
    assert sorted(got) == sorted(expected)
    for key in expected:
        assert np.array_equal(got[key], np.asarray(expected[key])), key
    if poly_a:
        assert (got["n_cand"][:poly_a] > port_batched.INSERT_CANDIDATE_SLOTS).all()
