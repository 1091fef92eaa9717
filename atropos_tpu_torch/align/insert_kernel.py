"""CUDA kernels for the insert matcher's diagonal match counts, and their
wrappers.

Counterpart of ``atropos_tpu/align/pallas_kernel.py::PallasPackedInsertMatcher``
and ``PallasInsertMatcher``. The two Pallas diagonal-count kernels each have
a hand-written Hopper kernel in ``csrc/diag_counts.cu``, which packs each
pair's windows into bit planes of 32 positions a word and counts a
diagonal's matches a word at a time (see the note at its top for what
bounds them and what the design does about it):

===================  ===========================================  ==========
wrapper              replaces                                     counts
===================  ===========================================  ==========
``diag_counts_u8``   ``pallas_kernel.py::_packed_diag_kernel``    8 bits
``diag_counts_i32``  ``pallas_kernel.py::_diag_counts_kernel``    32 bits
===================  ===========================================  ==========

Each wrapper takes the ref and query byte planes (``[W, B]`` uint8) and the
per-pair lengths (``[B]`` or ``[1, B]`` int32) on one device, checks them,
allocates the ``[W, B]`` counts, launches its kernel on PyTorch's current
stream without synchronizing, raises when the launch is refused, and counts
its launches in a plain integer ``launches``. Given CPU tensors — and only
then — a wrapper runs its plain PyTorch version
(:func:`~atropos_tpu_torch.align.batched._diagonal_match_counts`); on CUDA
tensors it launches the kernel or raises.

:func:`kernel_for` selects between the two as the reference selects between
its Pallas kernels (``_InsertPair._packed_syms``): the 8-bit kernel where
``W <= 255`` and the pair batch's combined alphabet has at most 14 symbols,
the 32-bit kernel otherwise, so each CUDA kernel runs exactly where its
Pallas kernel runs.
"""
import ctypes

import torch

from atropos_tpu_torch.align import _build
from atropos_tpu_torch.align.batched import _diagonal_match_counts

_LIB_NAME = "diag_counts"

#: the packed TPU kernel codes at most 14 symbols (codes 0..13; 14/15 are
#: its sentinels) and counts at most 255 positions (one byte)
PACKED_MAX_SYMBOLS = 14
PACKED_MAX_W = 255

#: operations one 32-position word of one diagonal needs by the kernels'
#: bit-plane rule (``csrc/diag_counts.cu::count_pair``): 8 funnel shifts of
#: the ref planes, 8 LOP3s folding ``query_p ^ ref_p`` into the mismatch
#: word, 1 popcount and 1 add
WORD_OPS = 18
#: operations a diagonal needs beside its words: the mask of the positions
#: past its end, on its last word (the kernels mask every word, a cost of
#: their design, not of the rule). The bound of both kernels counts the
#: words and diagonals the lengths need at these operations each.
DIAGONAL_OPS = 1


def _lib():
    lib = _build.load(_LIB_NAME)
    if not getattr(lib, "_atropos_bound", False):
        argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        for name in ("diag_counts_u8", "diag_counts_i32"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._atropos_bound = True
    return lib


def _check_inputs(refs_T, queries_T, lengths):
    for name, plane in (("refs_T", refs_T), ("queries_T", queries_T)):
        if plane.dim() != 2 or plane.dtype != torch.uint8:
            raise TypeError("{} must be a [W, B] uint8 tensor".format(name))
        if not plane.is_contiguous():
            raise ValueError("{} must be contiguous ([W, B], B minor)".format(name))
    if refs_T.shape != queries_T.shape:
        raise ValueError("refs_T and queries_T differ in shape")
    W, B = queries_T.shape
    if lengths.dtype != torch.int32 or lengths.numel() != B:
        raise TypeError("lengths must hold B int32 lengths")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    for name, tensor in (("queries_T", queries_T), ("lengths", lengths)):
        if tensor.device != refs_T.device:
            raise ValueError(
                "{} is on {}, refs_T on {}".format(name, tensor.device, refs_T.device)
            )
    return W, B


class _DiagKernel:
    """Wrapper of one exported diagonal-count kernel (see the module
    docstring)."""

    def __init__(self, name, out_dtype, max_w, replaces):
        self.name = name
        self.out_dtype = out_dtype
        self.max_w = max_w
        self.replaces = replaces
        #: kernel launches made through this wrapper
        self.launches = 0

    def _check_width(self, W):
        if self.max_w is not None and W > self.max_w:
            raise ValueError(
                "{}: W = {} exceeds {}, the most its counts hold".format(
                    self.name, W, self.max_w
                )
            )

    def plain(self, refs_T, queries_T, lengths):
        """The plain PyTorch version of this kernel, on any device."""
        W, _ = _check_inputs(refs_T, queries_T, lengths)
        self._check_width(W)
        return _diagonal_match_counts(refs_T, queries_T, lengths).to(self.out_dtype)

    def __call__(self, refs_T, queries_T, lengths):
        """``refs_T``/``queries_T`` [W, B] uint8 and ``lengths`` [B] int32
        on one device -> [W, B] counts of this kernel's type. CUDA tensors
        launch the kernel; CPU tensors run the plain version."""
        if not refs_T.is_cuda:
            return self.plain(refs_T, queries_T, lengths)
        W, B = _check_inputs(refs_T, queries_T, lengths)
        self._check_width(W)
        out = torch.empty((W, B), dtype=self.out_dtype, device=refs_T.device)
        with torch.cuda.device(refs_T.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = getattr(_lib(), self.name)(
                refs_T.data_ptr(), queries_T.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), W, B, stream,
            )
        if rc != 0:
            raise RuntimeError(
                "{}: kernel launch refused (CUDA error {})".format(self.name, rc)
            )
        self.launches += 1
        return out


diag_counts_u8 = _DiagKernel(
    "diag_counts_u8", torch.uint8, PACKED_MAX_W,
    "atropos_tpu/align/pallas_kernel.py:933 (_packed_diag_kernel)",
)
diag_counts_i32 = _DiagKernel(
    "diag_counts_i32", torch.int32, None,
    "atropos_tpu/align/pallas_kernel.py:899 (_diag_counts_kernel)",
)

KERNELS = (diag_counts_u8, diag_counts_i32)


def kernel_for(W, n_symbols):
    """The diagonal-count kernel for a batch of window ``W`` whose combined
    alphabet (query bytes and complemented ref bytes) has ``n_symbols``
    symbols: the reference's ``_packed_syms`` predicate."""
    if W <= PACKED_MAX_W and n_symbols <= PACKED_MAX_SYMBOLS:
        return diag_counts_u8
    return diag_counts_i32


def reset_launch_counts():
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts():
    return {kernel.name: kernel.launches for kernel in KERNELS}
