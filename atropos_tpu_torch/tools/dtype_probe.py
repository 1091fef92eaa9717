"""The dtype probe of the DP column body: int16 against int32 cells.

Counterpart of ``tools/perf_dtype_probe.py``, whose Pallas kernel
``body_full`` (``tools/perf_dtype_probe.py:25``) times the column body of
the adapter DP with int32 and with int16 state on a TPU. On Hopper the two
are hand-written CUDA kernels in ``csrc/dtype_probe.cu`` (see the note at
its top for the function, what bounds the kernels and what the design does
about it):

=====================  ==========================================
wrapper                cells
=====================  ==========================================
``dtype_probe_i32``    int32, one thread a read
``dtype_probe_i16x2``  int16, two reads' cells in one 32-bit word
=====================  ==========================================

Each wrapper takes the reads as a ``[L, N]`` uint8 plane and a ``dyn``
flag (the query byte of column j is read byte j - 1, else byte 0), checks
them, allocates the ``[8, N]`` int32 output (and, with ``state=True``,
the whole final ``[2, M1, N]`` state: pack, then pay), launches its
kernel on PyTorch's current stream without synchronizing, raises when the
launch is refused, and counts its launches in a plain integer
``launches``. Given a CPU tensor — and only then — a wrapper runs the
plain version :func:`probe_columns`; on a CUDA tensor it launches the
kernel or raises.

Run as a tool::

    python -m atropos_tpu_torch.tools.dtype_probe [--device cuda|cpu]

It runs the TPU tool's four runs under its names (``int32 full``, ``int16
full``, ``int16 no-dynslice``, ``int32 no-dynslice``) at the TPU tool's
shape (L = 104, N = 16 x 1,024) and again at the single-end main path's
(L = 160, N = 32,768; M1 = 34 is TruSeq's m + 1 at both), and prints the
time of each with the reads and cell updates a second. On ``--device cpu``
it runs the plain version and says so: those are not device times.
"""
import argparse
import ctypes
import time

import numpy as np
import torch

from atropos_tpu_torch import resolve_device
from atropos_tpu_torch.align import _build

_LIB_NAME = "dtype_probe"

#: state rows of the probe: TruSeq's m = 33 plus one
M1 = 34
OUT_ROWS = 8
#: the source of the TPU kernel that both kernels replace
REPLACES = "tools/perf_dtype_probe.py:25 (body_full)"

#: (L, N) shapes the tool runs: the TPU tool's, and the SE main path's
SHAPES = ((104, 16 * 1024), (160, 32768))

#: integer operations of one cell update of the column body: the compare
#: for eq; diag, del and their minimum; the select of pack; the add and
#: select of pay; 5 in each of 3 relaxation passes; the mask and the clamp
OPS_PER_CELL = 24


def probe_columns(reads_u8, dtype, dyn, state=False):
    """The plain PyTorch version of the probe: ``body_full`` of
    ``tools/perf_dtype_probe.py`` step for step, with the state in
    ``dtype`` (``torch.int16`` or ``torch.int32``). ``reads_u8`` [L, N]
    uint8 on any device -> [8, N] int32, and with ``state`` also the final
    [2, M1, N] int32 state (pack, then pay)."""
    L, N = reads_u8.shape
    m = M1 - 1
    reads = reads_u8.to(torch.int32)
    pack = torch.zeros((M1, N), dtype=dtype, device=reads.device)
    pay = torch.zeros((M1, N), dtype=dtype, device=reads.device)
    for j in range(1, L + 1):
        qc = reads[j - 1 : j] if dyn else reads[0:1]
        eq = reads[0:m] == qc
        del_p = pack[1:M1] + 3
        diag = pack[0:m] + 1
        pick = diag <= del_p
        loc = torch.where(pick, diag, del_p)
        elem = torch.where(eq, pack[0:m], loc)
        pay_e = torch.where(eq, pay[0:m] + 1, pay[1:M1])
        pack = torch.cat([pack[0:1], elem])
        pay = torch.cat([pay[0:1], pay_e])
        for _ in range(3):
            cand = pack[0:m] + 2
            tail = pack[1:M1]
            take = (cand < tail) & ~eq
            pack = torch.cat([pack[0:1], torch.where(take, cand, tail)])
            pay = torch.cat([pay[0:1], torch.where(take, pay[0:m], pay[1:M1])])
        pack = (pack & ~127).clamp(max=512)
    out = (pack[:OUT_ROWS] + pay[:OUT_ROWS]).to(torch.int32)
    if state:
        return out, torch.stack([pack, pay]).to(torch.int32)
    return out


def cell_updates(L, N):
    """Cell updates of one probe call: m rows of L columns of N reads."""
    return (M1 - 1) * L * N


def _lib():
    lib = _build.load(_LIB_NAME)
    if not getattr(lib, "_atropos_bound", False):
        for name in ("dtype_probe_i32", "dtype_probe_i16x2"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.dtype_probe_m1.restype = ctypes.c_int
        if lib.dtype_probe_m1() != M1:
            raise RuntimeError("csrc/dtype_probe.cu was built for another M1")
        lib._atropos_bound = True
    return lib


class DtypeProbeKernel:
    """Wrapper of one exported probe kernel (see the module docstring)."""

    def __init__(self, name, plain_dtype, reads_per_thread):
        self.name = name
        self.plain_dtype = plain_dtype
        self.reads_per_thread = reads_per_thread
        self.replaces = REPLACES
        #: kernel launches made through this wrapper
        self.launches = 0

    def _check(self, reads_u8):
        if reads_u8.dim() != 2 or reads_u8.dtype != torch.uint8:
            raise TypeError("reads must be a [L, N] uint8 tensor")
        if not reads_u8.is_contiguous():
            raise ValueError("reads must be contiguous ([L, N], N minor)")
        L, N = reads_u8.shape
        if L < M1 - 1:
            raise ValueError(
                "{}: L = {} is below m = {}: the reads' first m bytes are "
                "the rows compared".format(self.name, L, M1 - 1)
            )
        if N == 0 or N % self.reads_per_thread:
            raise ValueError(
                "{}: N = {} must be a positive multiple of {}".format(
                    self.name, N, self.reads_per_thread
                )
            )
        return L, N

    def plain(self, reads_u8, dyn, state=False):
        """The plain PyTorch version of this kernel, on any device."""
        self._check(reads_u8)
        return probe_columns(reads_u8, self.plain_dtype, dyn, state)

    def __call__(self, reads_u8, dyn, state=False):
        """``reads_u8`` [L, N] uint8 -> [8, N] int32 (and the final
        [2, M1, N] state with ``state``). A CUDA tensor launches the
        kernel; a CPU tensor runs the plain version."""
        if not reads_u8.is_cuda:
            return self.plain(reads_u8, dyn, state)
        L, N = self._check(reads_u8)
        dev = reads_u8.device
        out = torch.empty((OUT_ROWS, N), dtype=torch.int32, device=dev)
        full = torch.empty((2, M1, N), dtype=torch.int32, device=dev) if state else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = getattr(_lib(), self.name)(
                reads_u8.data_ptr(), out.data_ptr(),
                full.data_ptr() if state else None,
                L, N, int(bool(dyn)), 0, stream,
            )
        if rc != 0:
            raise RuntimeError(
                "{}: kernel launch refused (CUDA error {})".format(self.name, rc)
            )
        self.launches += 1
        return (out, full) if state else out


dtype_probe_i32 = DtypeProbeKernel("dtype_probe_i32", torch.int32, 1)
dtype_probe_i16x2 = DtypeProbeKernel("dtype_probe_i16x2", torch.int16, 2)

KERNELS = (dtype_probe_i32, dtype_probe_i16x2)

#: the TPU tool's runs: (name, kernel, dyn)
RUNS = (
    ("int32 full", dtype_probe_i32, True),
    ("int16 full", dtype_probe_i16x2, True),
    ("int16 no-dynslice", dtype_probe_i16x2, False),
    ("int32 no-dynslice", dtype_probe_i32, False),
)


def reset_launch_counts():
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts():
    return {kernel.name: kernel.launches for kernel in KERNELS}


def make_reads(seed, L, N, symbols=4, device="cpu"):
    """A seeded [L, N] uint8 plane of bytes below ``symbols``."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, symbols, (L, N), dtype=np.uint8)
    return torch.from_numpy(reads).to(device)


#: planes of :func:`make_plane` beside the random ones of :func:`make_reads`
PLANES = ("equal", "distinct", "alternating")


def make_plane(kind, seed, L, N, device="cpu"):
    """A seeded [L, N] uint8 plane whose reads each hold one byte value at
    every position (``equal``: every compare of the rule is equal), L <= 256
    distinct values (``distinct``: a compare is equal only where a column's
    query is the row's own byte), or two values in turn (``alternating``:
    every other row equal), each read's values drawn from 0-255."""
    rng = np.random.default_rng(seed)
    pos = np.arange(L)[:, None]
    base = rng.integers(0, 256, (1, N))
    if kind == "equal":
        reads = np.broadcast_to(base, (L, N))
    elif kind == "distinct":
        if L > 256:
            raise ValueError("a read of {} bytes cannot hold distinct bytes".format(L))
        reads = (base + pos) % 256
    elif kind == "alternating":
        other = (base + rng.integers(1, 256, (1, N))) % 256
        reads = np.where(pos % 2 == 0, base, other)
    else:
        raise ValueError("unknown plane {!r}".format(kind))
    return torch.from_numpy(np.ascontiguousarray(reads, dtype=np.uint8)).to(device)


def time_call(fn, device, launches):
    """Milliseconds a call: CUDA events around ``launches`` calls after a
    warm-up on a card; the host clock around one call on the CPU."""
    fn()
    if device.type != "cuda":
        began = time.perf_counter()
        fn()
        return (time.perf_counter() - began) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / launches


def main(argv=None, device=None):
    """Run the probe; returns one dict per run. ``device`` (or
    ``--device``) ``None`` means ``cuda``."""
    parser = argparse.ArgumentParser(
        prog="python -m atropos_tpu_torch.tools.dtype_probe",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument("--device", default=device, choices=("cuda", "cpu"))
    parser.add_argument(
        "--shape", action="append", metavar="L,N",
        help="columns and reads of a run (repeatable; default: "
             + " and ".join("{},{}".format(*s) for s in SHAPES) + ")",
    )
    parser.add_argument("--launches", type=int, default=20,
                        help="calls timed a run on the card")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = (
        [tuple(int(x) for x in s.split(",")) for s in args.shape]
        if args.shape else list(SHAPES)
    )
    on_card = dev.type == "cuda"
    label = torch.cuda.get_device_name(dev) if on_card else "cpu (plain version)"
    results = []
    for L, N in shapes:
        reads = make_reads(args.seed, L, N, device=dev)
        for name, kernel, dyn in RUNS:
            ms = time_call(lambda: kernel(reads, dyn), dev, args.launches)
            result = dict(
                name=name, kernel=kernel.name, dyn=dyn, L=L, N=N, M1=M1,
                ms=ms, reads_per_second=N / ms * 1e3,
                cell_updates_per_second=cell_updates(L, N) / ms * 1e3,
                device=label,
            )
            results.append(result)
            print(
                "%-28s L=%d N=%d  %10.4f ms  (%.2fM reads/s, %.2fG cell "
                "updates/s)  [%s]" % (
                    name, L, N, ms, result["reads_per_second"] / 1e6,
                    result["cell_updates_per_second"] / 1e9, label,
                ),
                flush=True,
            )
    return results


if __name__ == "__main__":
    main()
