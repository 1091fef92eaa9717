"""CUDA kernels for the batched semi-global adapter DP, and their wrappers.

Counterpart of ``atropos_tpu/align/pallas_kernel.py::PallasAligner``. The
two Pallas DP kernels each have a hand-written Hopper kernel in
``csrc/dp_align.cu`` (see the note at its top for what bounds them and
what the design does about it):

=====================  ==========================================  =========
wrapper                replaces                                    cell word
=====================  ==========================================  =========
``dp_locate_word32``   ``pallas_kernel.py::_dp_kernel_fused``      32 bits
``dp_locate_wide``     ``pallas_kernel.py::_dp_kernel``            64 bits
=====================  ==========================================  =========

Each wrapper picks the kernel's instantiation from the shape
(:meth:`_DpKernel.instantiation`: for ``dp_locate_word32`` the cell column
in registers for adapters of up to 63 bases; for ``dp_locate_wide`` one
warp a read, the column in register strips over its lanes, for adapters of
up to 896 bases whose cell a 32-bit word cannot hold, as on the long path,
where one thread a read ran 32 warps on 32 of the card's 132 SMs; else in
shared memory, else in global memory), checks its arguments, allocates the
``[8, B]`` output (and,
for an adapter whose cell column does not fit shared memory, the
``[m + 1, B]`` global-memory column the kernel then works in),
launches its kernel on PyTorch's current stream without synchronizing,
raises when the launch is refused, and counts its launches in a plain
integer ``launches``. Given CPU tensors — and only then — a wrapper runs
its plain PyTorch version (``dp_locate_word32_plain`` /
``dp_locate_wide_plain``, both :func:`~atropos_tpu_torch.align.batched.
_locate_kernel`); on CUDA tensors it launches the kernel or raises.

:class:`CudaAligner` is the ``nn.Module`` that holds one adapter's compiled
parameters on its device and picks the wrapper: the 32-bit word where the
cell's fields fit it, the 64-bit word otherwise.
"""
import collections
import ctypes

import torch

from atropos_tpu_torch.align import _build
from atropos_tpu_torch.align.batched import BatchAligner, _locate_kernel

#: integer operations of one cell update of ``dp_body`` in csrc/dp_align.cu
#: (one iteration of its row loop, counted in the note at the file's top):
#: the shared- and global-memory instantiations. The register
#: instantiations' count is read from the built kernel's SASS
#: (``cuda_tools/sass_rows.py``)
OPS_PER_CELL = 24

#: integer operations of one band cell of ``dp_body_warp`` (the strips),
#: what the two-plane keyed rule needs, counted from the source: off the
#: insertion chain the diagonal's and the deletion's upper words (2), their
#: minimum with the clamp (1), the diagonal-or-deletion test and its
#: payload's select (2), the match test (1), the match's upper word and
#: payload (2); on the chain the insertion's keyed word and its test (2),
#: its and the winner's stored upper words (2) and the select of each plane
#: (2). The stale row's select and the band's test are bookkeeping, left
#: out; the built kernel's SASS takes some 23.5 instructions a strip row
#: with them (``cuda_tools/sass_rows.py``)
STRIP_OPS_PER_CELL = 14

#: row caps of ``dp_locate_word32``'s register instantiations: an adapter of
#: m bases takes the smallest cap of at least m + 1 rows. One 64-row
#: instantiation for all of them ran 1.4 % slower at the main path's shape
#: and up to 37 % slower where the 16-row one serves (PERF.md)
ROW_CAPS = (16, 32, 48, 64)

#: threads of a block of the register instantiations: of 32, 64 and 128,
#: 128 was fastest at the main path's shape (PERF.md)
REGISTER_THREADS = 128

#: rows a lane holds in ``dp_locate_wide``'s warp instantiation (one warp
#: a read, lane l holding rows 1 + l R .. (l + 1) R): adapters of up to
#: 32 R = 896 bases, the long path's 880 among them; the one size built
#: and measured (PERF.md)
STRIP_ROWS = 28

#: threads of a block of the warp instantiation, one read a warp: of 32, 64
#: and 128, 128 was fastest at the long path's shape (PERF.md)
STRIP_THREADS = 128

#: dynamic shared memory a block may have on sm_90
MAX_SHARED_BYTES = 232448

#: threads of a block of ``dp_body``: 64 gives a batch of 32768 reads 512
#: blocks to spread over the card's 132 SMs; halved (down to one warp) for
#: adapters whose cell column does not fit the shared memory of a wider
#: block, and 64 again once even one warp's columns do not fit and move to
#: global memory
THREADS_PER_BLOCK = 64

#: how a launch runs: ``kind`` "registers", "shared" or "global" (where one
#: thread's cell column lives) or "warps" (one warp a read, the column in
#: register strips over its lanes), ``row_cap`` (rows of a register column,
#: or rows a lane of a strip, else 0) and ``threads`` a block
Instantiation = collections.namedtuple("Instantiation", "kind row_cap threads")

_LIB_NAME = "dp_align"


def _bits(x):
    """Number of bits needed to represent values 0..x."""
    return max(1, int(x).bit_length())


def cell_layout(m, k, L, word_bits):
    """Field widths ``(mat_bits, org_bits)`` of the packed DP cell

        cell = cost << (mat_bits + org_bits) | (origin + m) << mat_bits | matches

    for an adapter of ``m`` bases with ``k`` allowed errors against reads
    of up to ``L`` bases, or None when the fields do not fit ``word_bits``.
    Costs are saturated at ``k + 1`` (a cell above ``k`` is dead for good
    and only that property is ever read), origins range over ``[-m, L]``
    and matches over ``[0, m]``.
    """
    mat_bits = _bits(m)
    org_bits = _bits(L + m)
    if mat_bits + org_bits + _bits(k + 1) > word_bits:
        return None
    return mat_bits, org_bits


def strip_layout(m, k, L):
    """Field widths ``(mat_bits, org_bits)`` of ``dp_locate_wide``'s warp
    instantiation for (m, k, L), or None where it cannot serve them. Its
    cell is two 32-bit planes, cost << 2 | tie key above the payload
    (origin + m) << mat_bits | matches: the payload must fit 32 bits, and
    the final scan's key, matches << 16 | 0xffff - cost, needs matches and
    costs below 2**15 and 2**16."""
    mat_bits = _bits(m)
    org_bits = _bits(L + m)
    if mat_bits + org_bits > 32 or m >= 1 << 15 or k >= 1 << 16:
        return None
    return mat_bits, org_bits


def _lib():
    lib = _build.load(_LIB_NAME)
    if not getattr(lib, "_atropos_bound", False):
        # both take the row cap of their register columns; dp_locate_wide
        # also a pointer to the warp instantiation's counts
        for name, tail in (("dp_locate_word32", 1), ("dp_locate_wide", 2)):
            fn = getattr(lib, name)
            fn.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p] * tail
            )
            fn.restype = ctypes.c_int
        lib._atropos_bound = True
    return lib


def _check_inputs(reads_T, lengths_row, ref_bytes, thresholds, m):
    if reads_T.dim() != 2 or reads_T.dtype != torch.uint8:
        raise TypeError("reads_T must be a [L, B] uint8 tensor")
    if not reads_T.is_contiguous():
        raise ValueError("reads_T must be contiguous ([L, B], B minor)")
    L, B = reads_T.shape
    if lengths_row.dtype != torch.int32 or lengths_row.numel() != B:
        raise TypeError("lengths_row must hold B int32 lengths")
    if not lengths_row.is_contiguous():
        raise ValueError("lengths_row must be contiguous")
    if ref_bytes.dtype != torch.uint8 or tuple(ref_bytes.shape) != (m,):
        raise TypeError("ref_bytes must be a [m] uint8 tensor")
    if thresholds.dtype != torch.int32 or tuple(thresholds.shape) != (m + 1,):
        raise TypeError("thresholds must be a [m + 1] int32 tensor")
    if not (ref_bytes.is_contiguous() and thresholds.is_contiguous()):
        raise ValueError("ref_bytes and thresholds must be contiguous")
    for name, tensor in (
        ("lengths_row", lengths_row),
        ("ref_bytes", ref_bytes),
        ("thresholds", thresholds),
    ):
        if tensor.device != reads_T.device:
            raise ValueError(
                "{} is on {}, reads_T on {}".format(
                    name, tensor.device, reads_T.device
                )
            )
    return L, B


class _DpKernel:
    """Wrapper of one exported DP kernel (see the module docstring)."""

    def __init__(self, name, word_bits, replaces, row_caps=()):
        self.name = name
        self.word_bits = word_bits
        self.replaces = replaces
        self.row_caps = row_caps
        #: kernel launches made through this wrapper
        self.launches = 0

    def fits(self, m, k, L):
        """Whether this kernel's cell word holds the fields of (m, k, L)."""
        return cell_layout(m, k, L, self.word_bits) is not None

    def shared_bytes(self, m, threads):
        return (self.word_bits // 8) * (m + 1) * threads + 4 * (m + 1) + m

    def block_layout(self, m):
        """(threads a block, whether the cell column lives in global
        memory) for an adapter of ``m`` bases: the widest block up to
        ``THREADS_PER_BLOCK`` whose columns fit shared memory, else
        ``THREADS_PER_BLOCK`` threads with the column in global memory."""
        threads = THREADS_PER_BLOCK
        while threads > 32 and self.shared_bytes(m, threads) > MAX_SHARED_BYTES:
            threads //= 2
        if self.shared_bytes(m, threads) > MAX_SHARED_BYTES:
            return THREADS_PER_BLOCK, True
        return threads, False

    def holds_strips(self, m, k, L):
        """Whether the strips (64-bit kernel only) can serve (m, k, L): at
        most 32 ``STRIP_ROWS`` rows and a payload that :func:`strip_layout`
        fits in 32 bits."""
        return (
            self.word_bits == 64 and m <= 32 * STRIP_ROWS
            and strip_layout(m, k, L) is not None
        )

    def instantiation(self, m, k, L):
        """The :data:`Instantiation` that serves (m, k, L): the register
        column of the smallest row cap that holds m + 1 rows, where the
        cell's fields leave three bits to spare (the register body's 2-bit
        tie key and one bit for costs of up to 2k + 2 before its minimum);
        one warp a read in strips, where :meth:`holds_strips` and a 32-bit
        cell cannot hold (m, k, L): every shape :class:`CudaAligner` sends
        the 64-bit kernel. A shape that a 32-bit cell holds reaches it only
        when a caller names this kernel (the card's grid of
        configurations), and there one read a thread serves it as before:
        at adapters of up to 64 bases on 32,768 reads the strips took
        4.3-65x as long (PERF.md). Else :meth:`block_layout`'s shared- or
        global-memory column."""
        if cell_layout(m, k, L, self.word_bits - 3) is not None:
            for cap in self.row_caps:
                if m + 1 <= cap:
                    return Instantiation("registers", cap, REGISTER_THREADS)
        if self.holds_strips(m, k, L) and cell_layout(m, k, L, 32) is None:
            return Instantiation("warps", STRIP_ROWS, STRIP_THREADS)
        threads, global_col = self.block_layout(m)
        return Instantiation("global" if global_col else "shared", 0, threads)

    def plain(self, reads_T, lengths_row, ref_bytes, thresholds, **params):
        """The plain PyTorch version of this kernel, on any device."""
        m = params["m"]
        L, _ = _check_inputs(reads_T, lengths_row, ref_bytes, thresholds, m)
        if not self.fits(m, params["k"], L):
            raise ValueError(
                "{}: the cell of (m={}, k={}, L={}) does not fit {} bits".format(
                    self.name, m, params["k"], L, self.word_bits
                )
            )
        return _locate_kernel(
            reads_T, lengths_row, ref_bytes, thresholds, **params
        )

    def __call__(self, reads_T, lengths_row, ref_bytes, thresholds, *, m, k,
                 flags, min_overlap, ins_cost, del_cost, compare_ascii):
        """``reads_T`` [L, B] uint8, ``lengths_row`` [1, B] int32,
        ``ref_bytes`` [m] uint8, ``thresholds`` [m + 1] int32, on one
        device -> [8, B] int32 (found, start1, stop1, start2, stop2,
        matches, cost, 0). CUDA tensors launch the kernel; CPU tensors
        run the plain version."""
        params = dict(
            m=m, k=k, flags=flags, min_overlap=min_overlap,
            ins_cost=ins_cost, del_cost=del_cost, compare_ascii=compare_ascii,
        )
        if not reads_T.is_cuda:
            return self.plain(
                reads_T, lengths_row, ref_bytes, thresholds, **params
            )
        how = self.instantiation(m, k, reads_T.shape[0])
        return self.launch(
            reads_T, lengths_row, ref_bytes, thresholds, how, **params
        )

    def launch(self, reads_T, lengths_row, ref_bytes, thresholds, how, *, m,
               k, flags, min_overlap, ins_cost, del_cost, compare_ascii,
               stats=None):
        """Launch the :data:`Instantiation` ``how`` on CUDA tensors: what a
        call does once it has picked ``how`` from the shape. A timing tool
        may name another instantiation that holds the shape (a wider row
        cap, another block width, the strips or one read a thread where the
        other serves); the wrapper or the kernel refuses one that does not.
        ``stats``, a [3] int64 tensor on the card, gains the warp
        instantiation's columns, fix-up rounds and fix-up row steps, summed
        over its warps."""
        L, B = _check_inputs(reads_T, lengths_row, ref_bytes, thresholds, m)
        if B % 32:
            raise ValueError(
                "batch width {} is not a multiple of the warp width 32".format(B)
            )
        layout = cell_layout(m, k, L, self.word_bits)
        if layout is None:
            raise ValueError(
                "{}: the cell of (m={}, k={}, L={}) does not fit {} bits".format(
                    self.name, m, k, L, self.word_bits
                )
            )
        if how.kind == "registers" and cell_layout(m, k, L, self.word_bits - 3) is None:
            raise ValueError(
                "{}: the cell of (m={}, k={}, L={}) leaves no three bits to "
                "spare for the register column".format(self.name, m, k, L)
            )
        if how.kind == "warps":
            if how.row_cap != STRIP_ROWS or not self.holds_strips(m, k, L):
                raise ValueError(
                    "{}: strips of {} rows a lane do not hold (m={}, k={}, "
                    "L={})".format(self.name, how.row_cap, m, k, L)
                )
        if stats is not None and (
            how.kind != "warps" or stats.dtype != torch.int64
            or tuple(stats.shape) != (3,) or stats.device != reads_T.device
        ):
            raise ValueError("stats: a [3] int64 tensor, for the strips only")
        out = torch.empty((8, B), dtype=torch.int32, device=reads_T.device)
        col = None
        if how.kind == "global":
            col = torch.empty(
                ((m + 1) * B,),
                dtype=torch.int32 if self.word_bits == 32 else torch.int64,
                device=reads_T.device,
            )
        ints = [L, B, m, k, flags, min_overlap, ins_cost, del_cost,
                int(bool(compare_ascii)), layout[0], layout[1], how.row_cap]
        tail = []
        if self.word_bits == 64:
            tail.append(None if stats is None else stats.data_ptr())
        with torch.cuda.device(reads_T.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = getattr(_lib(), self.name)(
                reads_T.data_ptr(), lengths_row.data_ptr(), out.data_ptr(),
                ref_bytes.data_ptr(), thresholds.data_ptr(),
                None if col is None else col.data_ptr(),
                *ints, how.threads, stream, *tail,
            )
        if rc != 0:
            raise RuntimeError(
                "{}: kernel launch refused (CUDA error {})".format(self.name, rc)
            )
        self.launches += 1
        return out


dp_locate_word32 = _DpKernel(
    "dp_locate_word32", 32,
    "atropos_tpu/align/pallas_kernel.py:177 (_dp_kernel_fused)",
    row_caps=ROW_CAPS,
)
dp_locate_wide = _DpKernel(
    "dp_locate_wide", 64,
    "atropos_tpu/align/pallas_kernel.py:439 (_dp_kernel)",
)
dp_locate_word32_plain = dp_locate_word32.plain
dp_locate_wide_plain = dp_locate_wide.plain

KERNELS = (dp_locate_word32, dp_locate_wide)


def reset_launch_counts():
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts():
    return {kernel.name: kernel.launches for kernel in KERNELS}


class CudaAligner(BatchAligner):
    """CUDA-kernel counterpart of :class:`BatchAligner` (same result
    contract, same bit-exact semantics). ``forward`` goes through
    :data:`dp_locate_word32` when the cell of (m, k, L) fits a 32-bit
    word and through :data:`dp_locate_wide` otherwise."""

    def kernel_for(self, L):
        return dp_locate_word32 if dp_locate_word32.fits(self.m, self.k, L) else dp_locate_wide

    def forward(self, reads_T, lengths_row):
        return self.kernel_for(reads_T.shape[0])(
            reads_T, lengths_row, self.ref_bytes, self.thresholds,
            **self._dp_params(),
        )


def aligner_from_numpy(ref_bytes, thresholds, query_lut, *, m, k, flags,
                       min_overlap, indel_cost, compare_ascii, device):
    """An aligner on ``device`` from one adapter's compiled parameters as
    numpy arrays (the reference bytes as compared, the float64-derived
    threshold table and the 256-entry query translation table): a
    :class:`CudaAligner` for a CUDA device, a :class:`BatchAligner` for
    ``cpu``. Both sides of a comparison can so compute from the same
    tables."""
    cls = CudaAligner if torch.device(device).type == "cuda" else BatchAligner
    return cls.from_tables(
        ref_bytes, thresholds, query_lut, m=m, k=k, flags=flags,
        min_overlap=min_overlap, indel_cost=indel_cost,
        compare_ascii=compare_ascii, device=device,
    )
