"""Turbo trim path: zero-Python-object, latency-hiding streaming trim.

Counterpart of ``atropos_tpu/engine/turbo.py``. For interval-expressible
single-end and paired-end configurations (fixed cuts + quality/NextSeq
trimming + adapter trimming with either aligner + conditional
cuts/N-trimming + length/N filters, action=trim) the entire per-read
pipeline is *interval arithmetic*: each stage only narrows a per-read
keep-window [start, stop). The runners stream FASTQ/FASTA chunks through
the native C parser (:mod:`atropos_tpu_torch.runtime`), run one device
step per batch, resolve the final windows, and assemble output bytes with
the native formatters (separate or interleaved) — no per-read Python
objects anywhere.

Layout:

- :class:`_MateLane` — one mate's stage configuration and device work
  (prepare/submit a batch, resolve its keep-windows + statistics, apply
  post-adapter stages).
- :class:`_InsertPair` — the paired insert-align stage: one fused device
  step for both mates (both fallback DPs + the diagonal insert matcher +
  on-device candidate slots), vectorized candidate selection, overhang
  checks and symmetric duplication on the host.
- :class:`TurboTrimRunner` — the single-end runner: one lane, filters,
  per-destination routing.
- :class:`TurboPairedRunner` — the paired-end runner: two lanes fed by two
  synchronized chunk streams (or one interleaved stream paired by stride),
  vectorized pair filters (``any``/``both`` semantics of the reference's
  PairedWrapper).

The device interaction is pipelined (``DEPTH`` batches in flight):

- **submit**: one bit-packed upload per batch and mate (2-4 bits/base),
  written by the native packer straight into a pinned host buffer and
  copied ``non_blocking`` on a side stream; on the compute stream the step
  unpacks the codes, decodes each adapter's view with a table gather into
  the ``[L, B]`` column-major layout, runs one DP kernel launch per
  adapter (:mod:`atropos_tpu_torch.align.cuda_kernel`) — and for an insert
  pair one diagonal-count kernel launch
  (:mod:`atropos_tpu_torch.align.insert_kernel`) — packs the results
  into an int16 ``bundle`` and copies it into a pinned buffer, followed by
  an event.
- **resolve**: wait for that batch's event only, then all interval
  resolution, validation, statistics (vectorized bincounts) and the
  native formatter run on host while later batches compute on the card.
  A batch's pinned buffers go back to the free list only then.

Quality and NextSeq trimming run on the host-native path (the windows are
computed from the chunk buffer before the upload). Side files (info,
rest, wildcard), ``--stats`` (pre/post statistics collected from the
batch matrices, their position counts on the run's device), ``{name}``
demultiplexing, ``-w`` mate overwrite and the overlap error correction of
``--correct-mismatches`` with the insert aligner (the corrected records'
bytes patched into the native formatter's output) run on the runners as
in ``atropos_tpu``. What the turbo runners decline (``build`` returns
None) runs through the per-record pipeline and its batched engine
(:mod:`atropos_tpu_torch.engine`), as in ``atropos_tpu``; the sharded
mesh and the device quality kernels are not part of this package. Under
more than one rank (:mod:`atropos_tpu_torch.parallel.distributed`) each
runner trims the chunks (single-end) or pair batches (paired-end) whose
index modulo the world size is its rank, into its ``.{rank}`` shard.

Output is byte-identical to ``atropos_tpu``; all summary statistics
(per-adapter histograms, trimmed-bp counters, filter counts) are
accumulated into the same stat objects, so reports are unchanged.
"""
import collections
import logging
import os
import time
from functools import partial

import numpy as np
import torch

from atropos_tpu_torch import resolve_device, runtime
from atropos_tpu_torch.adapters import (
    ANYWHERE,
    FRONT,
    PREFIX,
    SUFFIX,
    Adapter,
)
from atropos_tpu_torch.align import insert_kernel
from atropos_tpu_torch.align.batched import (
    INSERT_CANDIDATE_SLOTS,
    BatchInsertMatcher,
    _diagonal_match_counts,
    _translation_lut,
    insert_candidate_slots,
    insert_step_table,
)
from atropos_tpu_torch.commands.trim.filters import (
    NContentFilter,
    NoFilter,
    PairedWrapper,
    TooLongReadFilter,
    TooShortReadFilter,
    TrimmedFilter,
    UntrimmedFilter,
)
from atropos_tpu_torch.commands.trim.modifiers import (
    AdapterCutter,
    InsertAdapterCutter,
    MinCutter,
    NEndTrimmer,
    NextseqQualityTrimmer,
    OverwriteRead,
    QualityTrimmer,
    ReadPairModifier,
    UnconditionalCutter,
)
from atropos_tpu_torch.commands.trim.writers import (
    InfoFormatter,
    RestFormatter,
    WildcardFormatter,
    add_suffix_to_path,
)
from atropos_tpu_torch.engine import _PrefixSuffixMatcher, make_batch_aligner
from atropos_tpu_torch.io import xopen
from atropos_tpu_torch.io.compression import get_file_opener
from atropos_tpu_torch.io.seqio import (
    FastaFormat,
    FastqFormat,
    FormatError,
    InterleavedFormatter,
    guess_format_from_name,
)
from atropos_tpu_torch.runtime import _i32, _i64, _u8
from atropos_tpu_torch.commands.cli import int_or_str
from atropos_tpu_torch.util import BASE_COMPLEMENTS, truncate_string

_UPPER_LUT = None

#: telemetry of the last :meth:`TurboTrimRunner.run` or
#: :meth:`TurboPairedRunner.run`: reads (pairs), the (index, records) of
#: each chunk (pair batch) this rank owned, batches, wall seconds and where
#: the main thread and its helper threads spent them
LAST_RUN = {}

#: telemetry: pairs whose insert-candidate stream exceeded the bundle's
#: candidate slots and were re-derived from counts recomputed on the host
#: (the reference's own semantics for such pairs, never a replacement of
#: the device kernel for a batch)
SLOT_OVERFLOWS = {"pairs": 0}


def _upper(arr):
    global _UPPER_LUT
    if _UPPER_LUT is None:
        lut = np.arange(256, dtype=np.uint8)
        lut[ord("a") : ord("z") + 1] = np.arange(
            ord("A"), ord("Z") + 1, dtype=np.uint8
        )
        _UPPER_LUT = lut
    return _UPPER_LUT[arr]


_COMP_LUT256 = None


def _complement_lut():
    """Byte-indexed IUPAC complement table (identity for bytes outside
    the map — util.complement semantics, byte for byte)."""
    global _COMP_LUT256
    if _COMP_LUT256 is None:
        lut = np.arange(256, dtype=np.uint8)
        for base, comp in BASE_COMPLEMENTS.items():
            lut[ord(base)] = ord(comp)
        _COMP_LUT256 = lut
    return _COMP_LUT256


def _pack_info(chunk):
    """Bit-packed upload parameters for a chunk's sequences.

    Sequence bytes cross the host-device link packed: chunks whose
    sequence alphabet has <= 4 distinct byte values (plain ACGT data) pack
    4 bases/byte, <= 16 values (ACGTN + lowercase) pack 2 bases/byte.
    Returns (bits, code_lut, symbols) or None for raw upload (>16 distinct
    symbols).
    """
    symbols = chunk.alphabet
    if symbols.size > 16:
        return None
    bits = 2 if symbols.size <= 4 else 4
    code_lut = np.zeros(256, np.uint8)
    code_lut[symbols] = np.arange(symbols.size, dtype=np.uint8)
    return bits, code_lut, symbols


class _Slot:
    """Pinned host staging buffers of one in-flight batch (uploads and
    the bundle fetch), reused once the batch is resolved. On the CPU the
    buffers are ordinary tensors."""

    def __init__(self, pin):
        self._pin = pin
        self._bufs = {}

    def buffer(self, name, shape, dtype):
        """A host tensor of exactly ``shape`` carved from this slot's
        ``name`` buffer, grown when too small."""
        count = int(np.prod(shape))
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < count:
            buf = torch.empty(
                max(count, 1), dtype=dtype, pin_memory=self._pin
            )
            self._bufs[name] = buf
        return buf[:count].view(*shape)


class _Inflight:
    """One submitted batch: the fetched bundle buffer and its event plus
    the host context needed to resolve it (kept alive until resolution)."""

    __slots__ = (
        "bundle", "event", "slot", "chunk", "sub", "batch", "width", "pad_b",
        "keep_start", "keep_stop", "n", "seqs",
        "match_data", "win_start", "win_stop", "qclip", "alt", "ow",
    )

    def __init__(self, **kw):
        self.bundle = None
        self.event = None
        self.slot = None
        self.match_data = None
        self.win_start = None
        self.win_stop = None
        self.qclip = None
        self.alt = None
        self.ow = None
        for key, val in kw.items():
            setattr(self, key, val)


def _open_input(path):
    """Binary chunk stream over the input: plain file, or streaming
    decompression for gz/bz2/xz (system gzip subprocess when available,
    so decompression overlaps compute in its own process)."""
    opener = get_file_opener(path)
    if opener is not None:
        return opener(path, "rb")
    return open(path, "rb")


class _ChunkStream:
    """Incremental native-parsed FASTQ/FASTA chunk iterator over one
    file.

    Replicates the scalar readers' edge handling: tolerates a missing
    final newline, raises on malformed content with the reader's exact
    diagnostics, and carries partial records across chunk boundaries.
    """

    def __init__(self, path, chunk_bytes, fmt="fastq"):
        self._fh = _open_input(path)
        self._carry = b""
        self._eof = False
        self._chunk_bytes = chunk_bytes
        self._fmt = fmt
        self._lines_done = 0
        #: seconds spent reading and parsing (on whichever thread calls)
        self.seconds = 0.0

    def next_chunk(self):
        """The next parsed chunk with >= 1 record, or None at end."""
        began = time.perf_counter()
        try:
            if self._fmt == "fasta":
                return self._next_fasta()
            return self._next_fastq()
        finally:
            self.seconds += time.perf_counter() - began

    def _next_fastq(self):
        while True:
            if self._eof and not self._carry:
                return None
            data = b"" if self._eof else self._fh.read(self._chunk_bytes)
            if not data:
                self._eof = True
            buf = self._carry + data
            if not buf:
                return None
            if self._eof and not buf.endswith(b"\n"):
                # tolerate a missing final newline (the scalar reader does)
                buf += b"\n"
            chunk = runtime.parse_chunk(buf)
            if chunk.n == 0 and self._eof:
                self._carry = b""
                if buf.strip():
                    raise RuntimeError("trailing garbage in FASTQ input")
                return None
            self._carry = buf[chunk.consumed :] if not self._eof else b""
            if chunk.n:
                return chunk

    def _next_fasta(self):
        while True:
            if self._eof and not self._carry:
                return None
            data = b"" if self._eof else self._fh.read(self._chunk_bytes)
            if not data:
                self._eof = True
            buf = self._carry + data
            if not buf:
                return None
            try:
                chunk = runtime.parse_fasta_chunk(buf, final=self._eof)
            except runtime.FastaParseError as err:
                # FastaReader's diagnostic, byte for byte (absolute line
                # number tracked across chunks)
                offset = err.offset
                lineno = self._lines_done + buf[:offset].count(b"\n") + 1
                nl_pos = buf.find(b"\n", offset)
                line = buf[offset : nl_pos if nl_pos >= 0 else len(buf)]
                raise FormatError(
                    "At line {0}: Expected '>' at beginning of FASTA "
                    "record, but got {1!r}.".format(
                        lineno,
                        truncate_string(line.decode("latin-1").strip()),
                    )
                )
            if chunk.n == 0 and self._eof:
                self._carry = b""
                return None
            self._lines_done += buf[: chunk.consumed].count(b"\n")
            self._carry = buf[chunk.consumed :] if not self._eof else b""
            if chunk.n:
                return chunk

    def close(self):
        self._fh.close()


class _PrefetchStream:
    """Background read+parse for a _ChunkStream: a producer thread keeps
    up to ``depth`` parsed chunks ready, so the native parse (which
    releases the GIL) overlaps the main thread's gather/submit/resolve
    work. This is the host-side analog of the device pipeline window:
    the parse phase would otherwise serialize with everything else on the
    main thread."""

    def __init__(self, stream, depth=2):
        import queue
        import threading

        self._stream = stream
        self._q = queue.Queue(maxsize=max(1, depth))
        self._exc = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._closed:
                chunk = self._stream.next_chunk()
                self._q.put(chunk)
                if chunk is None:
                    return
        except BaseException as exc:
            if not self._closed:
                self._exc = exc
            self._q.put(None)

    def next_chunk(self):
        item = self._q.get()
        if item is None:
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            # keep yielding None for any further calls
            self._q.put(None)
        return item

    def close(self):
        import queue

        self._closed = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
        self._stream.close()


LaneTables = collections.namedtuple(
    "LaneTables", "view_luts aligner_view insert_view"
)


def lane_tables_from_numpy(view_luts, aligner_view, insert_view=None):
    """A lane's decode state from numpy arrays: ``view_luts`` is a
    sequence of 256-entry uint8 byte -> view-byte tables (uppercasing and
    the per-adapter wildcard translation collapsed into one lookup),
    ``aligner_view[i]`` the index of the table device aligner ``i`` reads
    through, and ``insert_view`` (insert-align lanes only) the index of the
    table the diagonal matcher's byte plane is decoded with: the identity
    for mate 1, the complement for mate 2. :meth:`_MateLane.load_tables`
    installs the result, so two implementations can decode from the very
    same tables."""
    luts = np.ascontiguousarray(
        np.stack([np.asarray(lut) for lut in view_luts]).astype(np.uint8)
    )
    if luts.ndim != 2 or luts.shape[1] != 256:
        raise ValueError("view_luts must be [n_views, 256]")
    views = tuple(int(v) for v in aligner_view)
    if insert_view is not None:
        insert_view = int(insert_view)
    if any(
        v < 0 or v >= luts.shape[0]
        for v in views + ((insert_view,) if insert_view is not None else ())
    ):
        raise ValueError("a view index points past the tables")
    return LaneTables(luts, views, insert_view)


class _MateLane:
    """One mate's stage configuration and device work.

    ``submit`` turns a (chunk, sub) record range into an in-flight device
    batch; ``resolve_windows`` waits for the batch's bundle and produces
    the final per-read keep-windows plus matched flags, accumulating every
    modifier statistic exactly as the scalar pipeline would.
    """

    def __init__(self, *, cut_front, cut_back, quality, nextseq, cutter,
                 cutter_mod, insert_adapter=None, insert_role=None,
                 post_mods=(), device=None):
        self.device = resolve_device(device)
        self.cut_front = cut_front
        self.cut_back = cut_back
        self.quality = quality
        self.nextseq = nextseq
        self.cutter = cutter
        self.cutter_mod = cutter_mod
        self.insert_role = insert_role
        self.post_mods = list(post_mods)
        if cutter:
            self.adapters = cutter.adapters
        elif insert_adapter is not None:
            # insert mode: the mate's 3' adapter drives the FALLBACK
            # independent match (InsertAdapterCutter semantics); the pair
            # resolver decides whether/how its result applies
            self.adapters = [insert_adapter]
        else:
            self.adapters = []

        # anchored no-indel adapters match via the vectorized host
        # comparator (compare_prefixes semantics — O(B*m) byte ops, not
        # worth a device round trip); everything else gets a DP aligner.
        # self._aligners holds only the device aligners, in adapter
        # order; self._matchers maps adapter index -> host matcher.
        self._aligners = []
        self._matchers = {}
        luts = []
        for idx, adapter in enumerate(self.adapters):
            if not adapter.indels and adapter.where in (PREFIX, SUFFIX):
                self._matchers[idx] = _PrefixSuffixMatcher(adapter)
                continue
            self._aligners.append(make_batch_aligner(adapter, self.device))
            # wildcard translation table (None = raw ASCII compare)
            if adapter.adapter_wildcards or adapter.read_wildcards:
                luts.append(
                    _translation_lut(
                        adapter.adapter_wildcards,
                        adapter.read_wildcards,
                        for_query=True,
                    )
                )
            else:
                luts.append(None)
        self._needs_quals = quality is not None or nextseq is not None
        # device views: per-adapter wildcard translation and uppercasing
        # collapse into one byte -> view-byte table per distinct view; for
        # a bit-packed upload its rows at the chunk's symbols are the
        # code -> byte decode table applied on the device, so no
        # translated matrix ever crosses the link
        view_luts = []

        def add_view(lut256):
            for view_idx, existing in enumerate(view_luts):
                if np.array_equal(existing, lut256):
                    return view_idx
            view_luts.append(lut256)
            return len(view_luts) - 1

        # insert mode: mate 1 feeds the diagonal matcher its raw window
        # bytes (identity view); mate 2 feeds COMPLEMENTED bytes — the
        # reverse-complement's complement step is just another decode
        # table, the reversal is a device gather in the pair step
        insert_view = None
        if insert_role == 1:
            insert_view = add_view(np.arange(256, dtype=np.uint8))
        elif insert_role == 2:
            insert_view = add_view(_complement_lut())
        upper_lut = _upper(np.arange(256, dtype=np.uint8))
        aligner_view = [
            add_view(upper_lut if lut is None else lut[upper_lut])
            for lut in luts
        ]
        if not view_luts:
            view_luts.append(upper_lut)
        self.load_tables(
            lane_tables_from_numpy(view_luts, aligner_view, insert_view)
        )

        self._free_slots = []
        self._upload_stream = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda"
            else None
        )
        #: seconds the host waited for bundles (device wait), spent on
        #: host batch preparation, and spent enqueueing device work
        self.wait_seconds = 0.0
        self.prepare_seconds = 0.0
        self.dispatch_seconds = 0.0
        #: batches that went through the device step
        self.device_batches = 0

    def load_tables(self, tables):
        """Install :class:`LaneTables`: the host copies the packer reads
        and the device copy the raw (> 16 symbols) upload decodes with."""
        if len(tables.aligner_view) != len(self._aligners):
            raise ValueError("one view index per device aligner is needed")
        if (tables.insert_view is None) != (self.insert_role is None):
            raise ValueError("an insert view is needed exactly for insert lanes")
        self._view_luts = [lut for lut in tables.view_luts]
        self._aligner_view = list(tables.aligner_view)
        self._insert_view = tables.insert_view
        self._view_luts_dev = torch.from_numpy(tables.view_luts.copy()).to(
            self.device
        )

    @classmethod
    def from_modifier_list(cls, mods, insert_adapter=None, insert_role=None,
                           device=None):
        """Build a lane from one mate's ordered modifier list, or a
        decline-reason string when a stage is unsupported or out of the
        default C -> G -> Q -> A order. ``insert_adapter``/``insert_role``
        configure the lane as one mate of an insert-align pair."""
        cut_front = cut_back = 0
        quality = None
        nextseq = None
        cutter = None
        cutter_mod = None
        post = []
        for mod in mods:
            if type(mod) in (MinCutter, NEndTrimmer):
                # post-adapter fixed stages, applied by apply_post
                post.append(mod)
            elif isinstance(mod, UnconditionalCutter):
                cut_front, cut_back = mod.front_length, mod.back_length
                cutter_mod = mod
            elif isinstance(mod, QualityTrimmer):
                quality = mod
            elif isinstance(mod, NextseqQualityTrimmer):
                nextseq = mod
            elif isinstance(mod, AdapterCutter):
                cutter = mod
            else:
                return "unsupported modifier %s" % type(mod).__name__
        order = [type(mod) for mod in mods]
        # presence is keyed on the modifier INSTANCE: a zero-length
        # UnconditionalCutter (e.g. the read2 slot when only -u was given)
        # is a legitimate no-op stage, not an order violation
        expected = [
            t
            for t, present in (
                (UnconditionalCutter, cutter_mod),
                (NextseqQualityTrimmer, nextseq),
                (QualityTrimmer, quality),
                (AdapterCutter, cutter),
            )
            if present is not None
        ] + [type(mod) for mod in post]
        if order != expected:
            return "non-default op order"
        for adapter in (cutter.adapters if cutter else []):
            if type(adapter) is not Adapter:
                return "non-plain adapter"
        if insert_adapter is not None and cutter is not None:
            return "adapter cutter alongside insert cutter"
        return cls(
            cut_front=cut_front,
            cut_back=cut_back,
            quality=quality,
            nextseq=nextseq,
            cutter=cutter,
            cutter_mod=cutter_mod,
            insert_adapter=insert_adapter,
            insert_role=insert_role,
            post_mods=post,
            device=device,
        )

    # -- device step ----------------------------------------------------------

    def res_rows(self, width):
        """Bundle rows per device-aligner result: 3 when every field
        fits the packed layout (coords <= 255, cost <= 63 when found),
        else the flat 7. Static per compiled step; the resolver derives
        the same predicate from (width, adapter params)."""
        if width > 255:
            return 7
        for idx, adapter in enumerate(self.adapters):
            if idx in self._matchers:
                continue
            m = len(adapter.sequence)
            if m > 255 or int(adapter.max_error_rate * m) > 63:
                return 7
        return 3

    @staticmethod
    def _pack_res_rows(out7):
        """[7, B] aligner result -> [3, B] packed rows (int16-safe):
        rowA = start1 | stop1<<8 (biased), rowB = start2 | stop2<<8
        (biased), rowC = found | matches<<1 | cost<<9 (<= 32767).
        Unfound lanes may carry out-of-field costs — clipped here; every
        consumer is gated on ``found``."""
        row_a = (out7[1] | (out7[2] << 8)) - 32768
        row_b = (out7[3] | (out7[4] << 8)) - 32768
        row_c = (
            (out7[0] & 1)
            | (out7[5].clamp(0, 255) << 1)
            | (out7[6].clamp(0, 63) << 9)
        )
        return torch.stack([row_a, row_b, row_c])

    @staticmethod
    def _unpack_res_rows(rows3):
        """Host inverse of :meth:`_pack_res_rows` -> result dict arrays."""
        row_a = rows3[0] + 32768
        row_b = rows3[1] + 32768
        row_c = rows3[2]
        return dict(
            found=(row_c & 1).astype(bool),
            start1=row_a & 0xFF,
            stop1=row_a >> 8,
            start2=row_b & 0xFF,
            stop2=row_b >> 8,
            matches=(row_c >> 1) & 0xFF,
            cost=row_c >> 9,
        )

    @staticmethod
    def _finish_bundle(rows, win_len):
        """Concatenate bundle rows and narrow to int16 for the D2H fetch
        (every observable value fits: coordinates/matches are bounded by
        the batch width, costs by k when found — unfound costs may exceed
        the range but are never read)."""
        if not rows:
            rows = [win_len[None, :]]
        bundle = torch.cat(rows, dim=0)
        return bundle.clamp(-32768, 32767).to(torch.int16)

    def _core(self, width, bits, main, win16, tables, need_plane=False):
        """Per-batch device compute, composable into a single-mate step or
        the fused insert pair step: unpack the 2/4-bit codes of ``main``
        ([B, width * bits / 8] uint8; raw bytes when ``bits`` is 0),
        decode each aligner's view with a gather from ``tables``
        ([n_views, n_codes] uint8) into the [L, B] column-major layout
        (neighbouring threads of the DP kernel then read neighbouring
        bytes), and run one DP per adapter. Returns the per-aligner result
        rows, the int32 window lengths and, when ``need_plane``, the mate's
        diagonal-matcher byte plane ([B, width] uint8: identity for mate 1,
        complemented for mate 2)."""
        if bits == 2:
            parts = [(main >> shift) & 3 for shift in (0, 2, 4, 6)]
            codes = torch.stack(parts, dim=-1).reshape(main.shape[0], width)
        elif bits == 4:
            codes = torch.stack([main & 15, main >> 4], dim=-1).reshape(
                main.shape[0], width
            )
        else:
            codes = main
        codes = codes.long()
        codes_T = codes.T  # [L, B] gather indices
        win_len = win16.to(torch.int32)
        win_row = win_len[None, :].contiguous()

        reads_T = {}
        rows = []
        pack3 = self.res_rows(width) == 3
        for aligner, view_idx in zip(self._aligners, self._aligner_view):
            if view_idx not in reads_T:
                reads_T[view_idx] = tables[view_idx][codes_T].contiguous()
            out7 = aligner(reads_T[view_idx], win_row)[:7]
            rows.append(self._pack_res_rows(out7) if pack3 else out7)
        plane = tables[self._insert_view][codes] if need_plane else None
        return rows, win_len, plane

    def _step(self, width, bits, main, win16, tables):
        """The single-read device step for one batch: :meth:`_core`, one
        int16 bundle out.

        Bundle rows per device aligner: 3 packed rows or the flat 7
        (found, start1, stop1, start2, stop2, matches, cost), by
        :meth:`res_rows`."""
        rows, win_len, _ = self._core(width, bits, main, win16, tables)
        return self._finish_bundle(rows, win_len)

    # -- submit: host prep + async device dispatch ----------------------------

    @staticmethod
    def _pad_batch(batch):
        """Device batch width: a multiple of the warp width (32), which is
        all the DP kernels ask for."""
        return max(32, -(-batch // 32) * 32)

    def _decode_tables(self, symbols, n_codes):
        """[n_views, n_codes] uint8 code->ASCII decode tables for this
        chunk's symbol set (one row per device view)."""
        tables = np.zeros((len(self._view_luts), n_codes), np.uint8)
        for view_idx, lut in enumerate(self._view_luts):
            tables[view_idx, : symbols.size] = lut[symbols]
        return tables

    def _take_slot(self):
        if self._free_slots:
            return self._free_slots.pop()
        return _Slot(pin=self.device.type == "cuda")

    @staticmethod
    def _patch_rows(mat, overrides, key, keep_start, width):
        """Overwrite gathered matrix rows with replacement content (mate
        overwrite): row ``rows[i]`` becomes ``overrides[key][i]`` shifted
        to the row's gather origin ``keep_start[row]``."""
        src = overrides[key]
        new_n = overrides["n"]
        for r_i, row in enumerate(overrides["rows"]):
            ks = int(keep_start[row])
            take = min(width, max(0, int(new_n[r_i]) - ks))
            mat[row, :take] = src[r_i, ks : ks + take]
            mat[row, take:] = 0
        return mat

    def prepare(self, chunk, sub, overrides=None):
        """Host-side batch prep: fixed cuts, the native host quality
        windows, the host window gather, the pack decision, and the
        staging of the device arguments in the batch's slot. Returns
        (token, args | None, bits) where args = (main, win16, tables |
        None) are host tensors that feed :meth:`_step` once uploaded
        (``tables`` None: raw upload, decoded with the lane's own
        256-entry views).

        ``overrides`` (mate overwrite, ``-w``) replaces whole reads
        before any stage sees them: dict(rows, n, seq, qual) with full
        replacement content per affected row. Such a batch goes up raw
        (the replacement bytes are host-side, not in the chunk buffer)."""
        n = chunk.seq_len[sub].astype(np.int32)
        if overrides is not None:
            n[overrides["rows"]] = overrides["n"]
        batch = n.shape[0]
        keep_start = np.zeros(batch, np.int32)
        keep_stop = n.copy()

        # C: fixed cuts (Sequence.clip semantics; no-op for empty reads)
        if self.cut_front or self.cut_back:
            nonempty = n > 0
            new_start = np.minimum(self.cut_front, n)
            new_stop = np.maximum(new_start, n + self.cut_back)
            keep_start = np.where(nonempty, new_start, keep_start)
            keep_stop = np.where(nonempty, new_stop, keep_stop)
            # Trimmer.clip counts the REQUESTED front+back bases, even
            # when the read is shorter (reference Sequence.clip semantics)
            self.cutter_mod.trimmed_bases += int(
                (self.cut_front - self.cut_back) * nonempty.sum()
            )

        width = int(n.max()) if batch else 0
        width = max(8, -(-width // 32) * 32)
        pad_b = self._pad_batch(batch)
        # post-cut window, kept for post-stage provenance accounting
        cut_start = keep_start.copy()
        cut_stop = keep_stop.copy()

        # host-side window matrix at the fixed-cut offset (feeds the
        # anchored matchers, adapter statistics and N-counting; never
        # uploaded when packing is active)
        seqs = self._gather(chunk, sub, chunk.seq_off, keep_start, width, pad_b)
        if overrides is not None:
            self._patch_rows(seqs, overrides, "seq", keep_start, width)
        win_len = keep_stop - keep_start
        qclip = None

        if self._needs_quals:
            # native host quality path: windows + stats computed here,
            # nothing quality-related crosses the link
            g_stop, q_start, q_stop = self._native_quality(
                chunk, sub, keep_start, win_len, overrides
            )
            wl = keep_stop - keep_start
            if self.nextseq is not None:
                nz = wl > 0
                new_stop = keep_start + g_stop
                self.nextseq.trimmed_bases += int(
                    (keep_stop - new_stop)[nz].sum()
                )
                keep_stop = np.where(nz, new_stop, keep_stop)
                wl = keep_stop - keep_start
            if self.quality is not None:
                nz = wl > 0
                origin = keep_start
                self.quality.trimmed_bases += int(
                    (wl - (q_stop - q_start))[nz].sum()
                )
                keep_start = np.where(nz, origin + q_start, keep_start)
                keep_stop = np.where(nz, origin + q_stop, keep_stop)
            win_len = keep_stop - keep_start
            if np.any(keep_start != cut_start):
                seqs = self._gather(
                    chunk, sub, chunk.seq_off, keep_start, width, pad_b
                )
                if overrides is not None:
                    self._patch_rows(
                        seqs, overrides, "seq", keep_start, width
                    )
            qclip = (keep_start - cut_start, cut_stop - keep_stop)

        tok = _Inflight(
            chunk=chunk,
            sub=sub,
            batch=batch,
            width=width,
            pad_b=pad_b,
            keep_start=keep_start,
            keep_stop=keep_stop,
            qclip=qclip,
            n=n,
            seqs=seqs,
        )
        if not self._aligners:
            return tok, None, 0

        slot = tok.slot = self._take_slot()
        win16 = slot.buffer("win", (pad_b,), torch.int16)
        win_np = win16.numpy()
        win_np[:batch] = win_len
        win_np[batch:] = 0
        pack = _pack_info(chunk) if overrides is None else None
        if pack is not None:
            bits, code_lut, symbols = pack
            main = slot.buffer(
                "main", (pad_b, width * bits // 8), torch.uint8
            )
            self._gather_packed(
                chunk, sub, keep_start, width, code_lut, bits, main.numpy()
            )
            tables = slot.buffer(
                "tables", (len(self._view_luts), 1 << bits), torch.uint8
            )
            tables.numpy()[...] = self._decode_tables(symbols, 1 << bits)
        else:
            # raw upload (> 16 distinct symbols, or overwritten rows): the
            # window bytes cross the link as they are and the lane's
            # 256-entry views decode
            bits = 0
            main = slot.buffer("main", (pad_b, width), torch.uint8)
            main.numpy()[...] = seqs
            tables = None
        return tok, (main, win16, tables), bits

    def submit(self, chunk, sub, overrides=None):
        """Prepare the batch, upload it and run the device step; nothing
        here waits for the device. On a CUDA device the upload goes
        ``non_blocking`` from the slot's pinned buffers on the side
        stream, the step runs on the current stream behind it, and the
        bundle is copied into the slot's pinned fetch buffer followed by
        the token's event."""
        began = time.perf_counter()
        tok, args, bits = self.prepare(chunk, sub, overrides=overrides)
        prepared = time.perf_counter()
        self.prepare_seconds += prepared - began
        if args is not None:
            self.device_batches += 1
            self._dispatch(tok, args, bits)
            self.dispatch_seconds += time.perf_counter() - prepared
        return tok

    def _dispatch(self, tok, args, bits):
        """Upload one prepared batch and enqueue its device step."""
        if self.device.type != "cuda":
            main, win16, tables = args
            tok.bundle = self._step(
                tok.width, bits, main, win16,
                self._view_luts_dev if tables is None else tables,
            )
            return
        with torch.cuda.device(self.device):
            main, win16, tables = self._upload(args)
            bundle = self._step(
                tok.width, bits, main, win16,
                self._view_luts_dev if tables is None else tables,
            )
            tok.bundle, tok.event = self._enqueue_fetch(tok.slot, bundle)

    def _upload(self, args):
        """Copy one batch's host arguments from the slot's pinned buffers
        to the card ``non_blocking`` on the side stream; the current
        stream waits for them (call under ``torch.cuda.device``)."""
        compute = torch.cuda.current_stream()
        with torch.cuda.stream(self._upload_stream):
            dev_args = [
                None if arg is None
                else arg.to(self.device, non_blocking=True)
                for arg in args
            ]
            uploaded = torch.cuda.Event()
            uploaded.record(self._upload_stream)
        compute.wait_event(uploaded)
        for arg in dev_args:
            if arg is not None:
                arg.record_stream(compute)
        return dev_args

    @staticmethod
    def _enqueue_fetch(slot, bundle):
        """Copy a device bundle into the slot's pinned fetch buffer on the
        current stream; returns (host buffer, event after the copy)."""
        fetch = slot.buffer("bundle", tuple(bundle.shape), torch.int16)
        fetch.copy_(bundle, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream())
        return fetch, event

    def _fetch_bundle(self, tok):
        """The batch's bundle as an int32 array, once its event has
        passed; the slot goes back to the free list."""
        if tok.event is not None:
            began = time.perf_counter()
            tok.event.synchronize()
            self.wait_seconds += time.perf_counter() - began
        arr = tok.bundle.numpy().astype(np.int32)
        tok.bundle = None
        if tok.slot is not None:
            self._free_slots.append(tok.slot)
            tok.slot = None
        return arr

    # -- resolve: one fetch + host logic --------------------------------------

    def resolve_windows(self, tok):
        """Wait for the batch's bundle and produce (keep_start, keep_stop,
        matched) for the batch, accumulating all modifier statistics.
        ``tok.bundle`` may be None (no device work: no DP aligners) — the
        host-side anchored matchers still run then."""
        arr = None
        if tok.bundle is not None:
            arr = self._fetch_bundle(tok)[:, : tok.batch]
        batch = tok.batch
        keep_start = tok.keep_start
        keep_stop = tok.keep_stop
        rpa = self.res_rows(tok.width)  # bundle rows per aligner result

        # quality windows and their stats were already applied at submit
        # (host-native path); tok.keep_start/stop are final
        win_len = keep_stop - keep_start
        # the pre-adapter window: side files (info/rest/wildcard) slice
        # their fields from the read state AT MATCH TIME
        tok.win_start = keep_start
        tok.win_stop = keep_stop

        # A: adapter matching + trim
        matched = np.zeros(batch, bool)
        if self.adapters:
            best = None
            best_idx = None
            dev_i = 0
            upper = None
            for adapter_idx in range(len(self.adapters)):
                if adapter_idx in self._matchers:
                    # anchored no-indel: vectorized host comparator, plus
                    # the overlap/error-rate gate the DP kernel enforces
                    # in-kernel (Adapter.match_to semantics)
                    if upper is None:
                        upper = _upper(tok.seqs[:batch])
                    res = self._matchers[adapter_idx].locate_batch(
                        upper, win_len
                    )
                    res = {key: np.asarray(val) for key, val in res.items()}
                    adapter = self.adapters[adapter_idx]
                    size = res["stop1"] - res["start1"]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        rate_ok = np.where(
                            size > 0, res["cost"] / np.maximum(size, 1), 1.0
                        ) <= adapter.max_error_rate
                    res["found"] = (
                        res["found"]
                        & (size >= adapter.min_overlap)
                        & rate_ok
                    )
                else:
                    rows = arr[rpa * dev_i : rpa * dev_i + rpa]
                    dev_i += 1
                    if rpa == 3:
                        res = self._unpack_res_rows(rows)
                    else:
                        res = dict(
                            found=rows[0].astype(bool),
                            start1=rows[1],
                            stop1=rows[2],
                            start2=rows[3],
                            stop2=rows[4],
                            matches=rows[5],
                            cost=rows[6],
                        )
                res["found"] = res["found"] & (win_len > 0)
                res = self._validate(adapter_idx, res)
                if best is None:
                    best = res
                    best_idx = np.where(res["found"], adapter_idx, -1)
                else:
                    better = res["found"] & (
                        (~best["found"]) | (res["matches"] > best["matches"])
                    )
                    for key in res:
                        best[key] = np.where(better, res[key], best[key])
                    best_idx = np.where(better, adapter_idx, best_idx)

            matched = best["found"]
            # resolve trims per adapter type
            front_match = self._front_flags(best, best_idx)
            tok.match_data = dict(
                matched=matched,
                best_idx=best_idx,
                astart=best["start1"],
                astop=best["stop1"],
                rstart=best["start2"],
                rstop=best["stop2"],
                errors=best["cost"],
                front=front_match,
            )
            new_start = np.where(
                matched & front_match, keep_start + best["stop2"], keep_start
            )
            new_stop = np.where(
                matched & ~front_match, keep_start + best["start2"], keep_stop
            )
            self._accumulate_adapter_stats(
                best, best_idx, matched, front_match, win_len, tok.seqs
            )
            keep_start = new_start
            keep_stop = np.maximum(keep_start, new_stop)
            self.cutter.with_adapters += int(matched.sum())

        return keep_start, keep_stop, matched

    def criterion_hits(self, ftype, wrapper, tok, keep_start, keep_stop,
                       matched):
        """Vectorized single-read criterion over the batch (the pair/SE
        wrapping happens in the runner)."""
        final_len = keep_stop - keep_start
        if ftype is TooShortReadFilter:
            return final_len < wrapper.filter.minimum_length
        if ftype is TooLongReadFilter:
            return final_len > wrapper.filter.maximum_length
        if ftype is NContentFilter:
            ncount = self._count_n(tok, keep_start, keep_stop)
            fil = wrapper.filter
            if fil.is_proportion:
                with np.errstate(divide="ignore", invalid="ignore"):
                    frac = np.where(final_len > 0, ncount / final_len, 0)
                return frac > fil.cutoff
            return ncount > fil.cutoff
        if ftype is TrimmedFilter:
            return matched
        if ftype is UntrimmedFilter:
            return ~matched
        raise AssertionError(ftype)  # pragma: no cover - excluded at build

    def apply_post(self, tok, keep_start, keep_stop, matched):
        """Vectorized post-adapter fixed stages (NEndTrimmer / MinCutter)
        with the reference's provenance bookkeeping: ``Sequence.clipped``
        lanes (pre/post adapter per end, requested amounts for clip()
        and actual amounts for subseq()) and MatchInfo.rsize_total
        credits (ref ``modifiers.py:592-650,766-784``)."""
        if not self.post_mods:
            return keep_start, keep_stop
        batch = tok.batch
        clip = np.zeros((4, batch), np.int64)
        # C-stage fixed cuts record their REQUESTED amounts for nonempty
        # reads (pre-match lanes 0/1, Trimmer.clip semantics)
        if self.cut_front or self.cut_back:
            nonempty = tok.n > 0
            clip[0, nonempty] += self.cut_front
            clip[1, nonempty] += -self.cut_back
        # quality stages record their ACTUAL amounts (subseq semantics)
        if tok.qclip is not None:
            clip[0] += tok.qclip[0]
            clip[1] += tok.qclip[1]
        md = tok.match_data
        # adapter credits via MatchInfo.rsize_total: front match -> rstop,
        # back match -> window_len - rstart
        rsize_front = np.zeros(batch, np.int64)
        rsize_back = np.zeros(batch, np.int64)
        is_front = np.zeros(batch, bool)
        if md is not None:
            window_len = tok.win_stop - tok.win_start
            is_front = md["front"] & matched
            back_m = matched & ~md["front"]
            rsize_front[is_front] = md["rstop"][is_front]
            rsize_back[back_m] = (window_len - md["rstart"])[back_m]

        pre = ~matched  # clipped lane selector: 0/1 pre-match, 2/3 post
        cur_start = keep_start.astype(np.int64)
        cur_stop = keep_stop.astype(np.int64)

        def bump_clip(front_amt, back_amt):
            clip[0] += np.where(pre, front_amt, 0)
            clip[2] += np.where(~pre, front_amt, 0)
            clip[1] += np.where(pre, back_amt, 0)
            clip[3] += np.where(~pre, back_amt, 0)

        for mod in self.post_mods:
            wl = cur_stop - cur_start
            alive = wl > 0
            if type(mod) is NEndTrimmer:
                heads, tails = self._end_n_runs(tok, cur_start, cur_stop)
                heads = np.where(alive, heads, 0)
                tails = np.where(alive, tails, 0)
                mod.trimmed_bases += int((heads + tails).sum())
                bump_clip(heads, tails)
                tail_start = wl - tails  # subseq end index (pre-clamp)
                new_start = cur_start + np.minimum(heads, wl)
                new_stop = cur_start + np.clip(tail_start, 0, wl)
                cur_start = new_start
                cur_stop = np.maximum(new_stop, new_start)
            else:  # MinCutter
                if mod.only_trimmed:
                    side_front = is_front
                    side_back = matched & ~is_front
                else:
                    side_front = side_back = np.ones(batch, bool)
                if mod.count_trimmed:
                    credit_front = clip[0] + clip[2] + rsize_front
                    credit_back = clip[1] + clip[3] + rsize_back
                else:
                    credit_front = np.where(matched, clip[2], clip[0])
                    credit_back = np.where(matched, clip[3], clip[1])
                front_amt = np.where(
                    side_front,
                    np.maximum(mod.front_length - credit_front, 0),
                    0,
                )
                back_amt = np.where(
                    side_back,
                    np.minimum(credit_back + mod.back_length, 0),
                    0,
                )
                active = alive & ((front_amt > 0) | (back_amt < 0))
                front_amt = np.where(active, front_amt, 0)
                back_amt = np.where(active, -back_amt, 0)  # now positive
                mod.trimmed_bases += int((front_amt + back_amt).sum())
                bump_clip(front_amt, back_amt)
                new_start = cur_start + np.minimum(front_amt, wl)
                new_stop = cur_stop - np.minimum(back_amt, wl)
                cur_start = new_start
                cur_stop = np.maximum(new_stop, new_start)
        return cur_start.astype(np.int32), cur_stop.astype(np.int32)

    def _end_n_runs(self, tok, cur_start, cur_stop):
        """Per-read lengths of the leading and trailing 'N' runs inside
        the current windows (regex ^N+/N+$ semantics: an all-N read
        reports BOTH runs at full length)."""
        batch = tok.batch
        base = tok.keep_start
        a = (cur_start - base)[:, None]
        b = (cur_stop - base)[:, None]
        idx = np.arange(tok.width, dtype=np.int64)[None, :]
        in_win = (idx >= a) & (idx < b)
        not_n = in_win & (tok.seqs[:batch] != ord("N"))
        has = not_n.any(axis=1)
        wl = (b - a)[:, 0]
        first = np.where(has, not_n.argmax(axis=1), b[:, 0])
        heads = first - a[:, 0]
        last = np.where(
            has, tok.width - 1 - not_n[:, ::-1].argmax(axis=1), a[:, 0] - 1
        )
        tails = b[:, 0] - 1 - last
        return np.where(has, heads, wl), np.where(has, tails, wl)

    # -- helpers ------------------------------------------------------------

    def _native_quality(self, chunk, sub, keep_start, win_len, overrides=None):
        """Relative (g_stop, q_start, q_stop) window arrays for this
        lane's NextSeq/quality stages, computed by the native host
        kernel straight from the chunk buffer (scalar spec
        ``commands/trim/qualtrim.py``); mate-overwritten rows are
        recomputed from their replacement content."""
        batch = win_len.shape[0]
        extra = keep_start.astype(np.int64)
        qual_offs = np.ascontiguousarray(chunk.qual_off[sub] + extra, np.int64)
        seq_offs = np.ascontiguousarray(chunk.seq_off[sub] + extra, np.int64)
        wl = np.ascontiguousarray(win_len, np.int32)
        g_stop = np.empty(batch, np.int32)
        q_start = np.empty(batch, np.int32)
        q_stop = np.empty(batch, np.int32)
        nextseq_cut = self.nextseq.cutoff if self.nextseq is not None else -1
        stage = self.quality if self.quality is not None else self.nextseq
        base = stage.base
        has_q = 1 if self.quality is not None else 0
        cf = self.quality.cutoff_front if has_q else 0
        cb = self.quality.cutoff_back if has_q else 0
        runtime.lib().quality_trim_windows(
            _u8(chunk.buf), _i64(seq_offs), _i64(qual_offs), _i32(wl),
            batch, base, nextseq_cut, has_q, cf, cb,
            _i32(g_stop), _i32(q_start), _i32(q_stop),
        )
        if overrides is not None:
            self._override_quality(
                overrides, keep_start, win_len, g_stop, q_start, q_stop,
                nextseq_cut, has_q, cf, cb, base,
            )
        return g_stop, q_start, q_stop

    @staticmethod
    def _override_quality(overrides, keep_start, win_len, g_stop, q_start,
                          q_stop, nextseq_cut, has_q, cf, cb, base):
        """Recompute the quality windows of mate-overwritten rows from
        their replacement content (the native kernel read the chunk
        buffer; these rows' bytes live in the overrides arrays)."""
        for r_i, row in enumerate(overrides["rows"]):
            start_w = int(keep_start[row])
            length = int(win_len[row])
            if length <= 0:
                g_stop[row] = 0
                q_start[row] = 0
                q_stop[row] = 0
                continue
            quals = overrides["qual"][r_i, start_w : start_w + length]
            seqs = overrides["seq"][r_i, start_w : start_w + length]
            if nextseq_cut >= 0:
                acc = best = 0
                maxi = length
                for j in range(length - 1, -1, -1):
                    qv = int(quals[j]) - base
                    if seqs[j] == ord("G"):
                        qv = nextseq_cut - 1
                    acc += nextseq_cut - qv
                    if acc < 0:
                        break
                    if acc > best:
                        best = acc
                        maxi = j
                g_stop[row] = maxi
                length = maxi
            else:
                g_stop[row] = length
            if not has_q:
                q_start[row] = 0
                q_stop[row] = length
                continue
            start, stop = 0, length
            acc = best = 0
            for j in range(length):
                acc += cf - (int(quals[j]) - base)
                if acc < 0:
                    break
                if acc > best:
                    best = acc
                    start = j + 1
            acc = best = 0
            for j in range(length - 1, -1, -1):
                acc += cb - (int(quals[j]) - base)
                if acc < 0:
                    break
                if acc > best:
                    best = acc
                    stop = j
            if start >= stop:
                start, stop = 0, 0
            q_start[row] = start
            q_stop[row] = stop

    def _gather(self, chunk, sub, offs, extra_off, width, pad_b=None):
        offs_sub = np.ascontiguousarray(
            offs[sub] + extra_off.astype(np.int64), dtype=np.int64
        )
        lens_sub = np.ascontiguousarray(
            (chunk.seq_len[sub] - extra_off).astype(np.int32)
        )
        rows = pad_b if pad_b is not None else offs_sub.shape[0]
        out = np.zeros((rows, width), dtype=np.uint8)
        runtime.lib().gather_padded(
            _u8(chunk.buf), _i64(offs_sub), _i32(lens_sub),
            offs_sub.shape[0], width, _u8(out),
        )
        return out

    def _gather_packed(self, chunk, sub, extra_off, width, code_lut, bits,
                       out):
        """Bit-packed gather of the (window-offset) sequences into ``out``
        ([pad_b, width*bits/8] uint8, a view of the pinned upload buffer;
        codes little-endian within each byte)."""
        offs_sub = np.ascontiguousarray(
            chunk.seq_off[sub] + extra_off.astype(np.int64), dtype=np.int64
        )
        lens_sub = np.ascontiguousarray(
            (chunk.seq_len[sub] - extra_off).astype(np.int32)
        )
        out[...] = 0
        runtime.lib().gather_packed(
            _u8(chunk.buf), _i64(offs_sub), _i32(lens_sub),
            offs_sub.shape[0], width, _u8(code_lut), bits, _u8(out),
        )

    def _validate(self, adapter_idx, res):
        """Apply the max_rmp gate (other constraints enforced in-kernel)."""
        adapter = self.adapters[adapter_idx]
        if adapter.max_rmp is None:
            return res
        found = res["found"]
        size = res["stop1"] - res["start1"]
        ok = found.copy()
        # vectorized over unique (matches, size) pairs
        rows = np.nonzero(found)[0]
        if rows.size:
            keys = res["matches"][rows].astype(np.int64) * 100000 + size[rows]
            for key in np.unique(keys):
                mat, sz = divmod(int(key), 100000)
                prob = adapter.match_probability(mat, sz)
                if prob > adapter.max_rmp:
                    ok[rows[keys == key]] = False
        res["found"] = ok
        return res

    def _front_flags(self, best, best_idx):
        """Per-read front/back decision, matching Adapter._front_flag and
        Match._guess_is_front for 'anywhere' adapters."""
        batch = best_idx.shape[0]
        front = np.zeros(batch, bool)
        for idx, adapter in enumerate(self.adapters):
            mask = best_idx == idx
            if not mask.any():
                continue
            if adapter.where in (FRONT, PREFIX):
                front |= mask
            elif adapter.where == ANYWHERE:
                front |= mask & (best["start2"] == 0)
        return front

    @staticmethod
    def _bump_histograms(lengths_dict, errors_nested, lens, errs):
        """Vectorized CountingDict/NestedDict accumulation: one bincount
        over packed (length, errors) keys instead of a per-read loop."""
        keys = lens.astype(np.int64) * 4096 + errs.astype(np.int64)
        uniq, counts = np.unique(keys, return_counts=True)
        for key, cnt in zip(uniq, counts):
            ln, er = divmod(int(key), 4096)
            lengths_dict[ln] += int(cnt)
            errors_nested[ln][er] += int(cnt)

    def _accumulate_adapter_stats(
        self, best, best_idx, matched, front_match, win_len, seqs
    ):
        """Update per-adapter CountingDict/NestedDict stats exactly as
        Adapter._trimmed_front/_trimmed_back do (vectorized)."""
        for idx, adapter in enumerate(self.adapters):
            mask = matched & (best_idx == idx)
            if not mask.any():
                continue
            fmask = mask & front_match
            bmask = mask & ~front_match
            if fmask.any():
                self._bump_histograms(
                    adapter.lengths_front,
                    adapter.errors_front,
                    best["stop2"][fmask],
                    best["cost"][fmask],
                )
            if bmask.any():
                rstart = best["start2"][bmask]
                removed = (win_len[bmask] - rstart).astype(np.int64)
                self._bump_histograms(
                    adapter.lengths_back,
                    adapter.errors_back,
                    removed,
                    best["cost"][bmask],
                )
                rows = np.nonzero(bmask)[0]
                prev = np.where(
                    rstart > 0,
                    seqs[rows, np.maximum(rstart - 1, 0)],
                    0,
                )
                for byte, cnt in zip(*np.unique(prev, return_counts=True)):
                    base = chr(int(byte))
                    if base not in "ACGT":
                        base = ""
                    adapter.adjacent_bases[base] += int(cnt)

    def _count_n(self, tok, keep_start, keep_stop):
        """Per-read 'N'/'n' counts inside the final windows, read from
        the host matrix (which carries any correction-stage edits, like
        the scalar NContentFilter seeing the corrected read)."""
        base = tok.keep_start
        lo = (keep_start - base)[:, None]
        hi = (keep_stop - base)[:, None]
        idx = np.arange(tok.width, dtype=np.int32)[None, :]
        in_win = (idx >= lo) & (idx < hi)
        seqs = tok.seqs[: tok.batch]
        is_n = (seqs == ord("N")) | (seqs == ord("n"))
        return (is_n & in_win).sum(axis=1)


InsertTables = collections.namedtuple(
    "InsertTables", "step_table complement ref_lut ad1_t ad2_t"
)


def insert_tables_from_numpy(step_table, complement, ref_lut, ad1_t, ad2_t):
    """An insert pair's tables from numpy arrays: ``step_table`` the
    ``floor(s * err)`` thresholds for s in [0, 255] computed in float64
    (:func:`~atropos_tpu_torch.align.batched.insert_step_table`), the
    256-entry byte ``complement`` table that decodes mate 2's matcher
    plane, and the overhang comparator's tables (``ref_lut`` the 256-entry
    translation of the read bytes, ``ad1_t``/``ad2_t`` the translated
    adapter bytes). :meth:`_InsertPair.load_tables` installs the result,
    so two implementations can compute from the very same numbers."""
    step = np.ascontiguousarray(step_table, np.int32)
    if step.ndim != 1 or step.shape[0] < 256:
        raise ValueError("step_table must hold s = 0..255")
    luts = [np.ascontiguousarray(lut, np.uint8) for lut in (complement, ref_lut)]
    if any(lut.shape != (256,) for lut in luts):
        raise ValueError("complement and ref_lut must be 256-entry tables")
    return InsertTables(
        step, luts[0], luts[1],
        np.ascontiguousarray(ad1_t, np.uint8),
        np.ascontiguousarray(ad2_t, np.uint8),
    )


class _PairInflight:
    """One in-flight insert-align pair batch: two prepared mate tokens
    plus the fused step's bundle (a pinned host buffer on the card's path)
    and its event."""

    __slots__ = ("tok1", "tok2", "bundle", "event")

    def __init__(self, tok1, tok2):
        self.tok1 = tok1
        self.tok2 = tok2
        self.bundle = None
        self.event = None


class _InsertPair:
    """Turbo implementation of the insert-align paired stage: the
    device+host twin of ``InsertAdapterCutter`` over whole batches
    (counterpart of ``atropos_tpu/engine/turbo.py::_InsertPair``).

    Device side (one fused step per batch): both mates' decode and
    fallback-adapter DP kernels, then the diagonal matcher over
    (rc(read2-window), read1-window) truncated to the per-pair min window —
    exactly the scalar ``InsertAligner.match_insert`` setup. The reverse
    complement is a complement decode table plus one device gather, so
    nothing extra crosses the link. The counts come from
    ``diag_counts_u8`` where the reference runs its packed Pallas kernel
    (window <= 255, <= 14 symbols) and from ``diag_counts_i32`` elsewhere;
    for windows <= 255 the candidate stream is reconstructed on the device
    (:func:`~atropos_tpu_torch.align.batched.insert_candidate_slots`, torch
    ops) and only its fixed slots cross back, else the whole counts plane.

    Host side (vectorized, no per-pair Python): closed-form candidate
    reconstruction for slot-overflow pairs (:data:`SLOT_OVERFLOWS`) and the
    counts-plane path, random-match-probability filtering,
    probability-ordered candidate selection with both overhang-adapter
    checks, fallback independent matches, symmetric-match duplication,
    the overlap error correction of ``--correct-mismatches``
    (:meth:`_correct`, written back into the batch's host matrices and
    patched into the output by :meth:`_build_alt`) and per-mate trims +
    statistics.
    """

    def __init__(self, lane1, lane2, cutter):
        self.lane1 = lane1
        self.lane2 = lane2
        self.cutter = cutter
        aligner = cutter.aligner
        self.aligner = aligner
        self.matcher = BatchInsertMatcher(
            aligner.max_insert_mismatch_frac,
            aligner.min_insert_overlap,
            max_matches=100,
        )
        # overhang comparator translation: compare_prefixes(ref=overhang,
        # query=adapter) with the reference's argument order
        aw = aligner.adapter_wildcards
        rw = aligner.read_wildcards
        self._cmp_ascii = not (aw or rw)
        query_lut = _translation_lut(aw, rw, for_query=True)
        self._ad1 = np.frombuffer(aligner.adapter1.encode("ascii"), np.uint8)
        self._ad2 = np.frombuffer(aligner.adapter2.encode("ascii"), np.uint8)
        self.load_tables(
            insert_tables_from_numpy(
                insert_step_table(self.matcher.max_error_rate, 255),
                _complement_lut(),
                _translation_lut(aw, rw, for_query=False),
                query_lut[self._ad1],
                query_lut[self._ad2],
            )
        )
        #: pair batches through the fused step, and the host seconds spent
        #: preparing both mates, enqueueing and waiting for the card
        self.device_batches = 0
        self.prepare_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.wait_seconds = 0.0

    def load_tables(self, tables):
        """Install :class:`InsertTables` (the step table goes to the
        lanes' device)."""
        self._complement = tables.complement
        self._ref_lut = tables.ref_lut
        self._ad1_t = tables.ad1_t
        self._ad2_t = tables.ad2_t
        self._step_table = torch.from_numpy(tables.step_table.copy()).to(
            self.lane1.device
        )

    # -- submit ---------------------------------------------------------------

    def _n_symbols(self, chunk1, chunk2):
        """The size of the diagonal matcher's combined alphabet (query =
        mate 1 bytes, ref = complemented mate 2 bytes): with the window, it
        picks the counts kernel (:func:`insert_kernel.kernel_for`)."""
        return len(
            set(int(x) for x in chunk1.alphabet)
            | set(int(self._complement[x]) for x in chunk2.alphabet)
        )

    def submit(self, chunk1, sub1, chunk2, sub2):
        """Prepare both mates, upload them and enqueue the fused step;
        nothing here waits for the device."""
        began = time.perf_counter()
        tok1, args1, bits1 = self.lane1.prepare(chunk1, sub1)
        tok2, args2, bits2 = self.lane2.prepare(chunk2, sub2)
        prepared = time.perf_counter()
        self.prepare_seconds += prepared - began
        if args1 is None or args2 is None or tok1.pad_b != tok2.pad_b:
            raise AssertionError("both insert lanes carry one device aligner")
        w_ins = min(tok1.width, tok2.width)
        kernel = insert_kernel.kernel_for(
            w_ins, self._n_symbols(chunk1, chunk2)
        )
        ptok = _PairInflight(tok1, tok2)
        self.device_batches += 1
        lane1 = self.lane1
        luts1 = lane1._view_luts_dev
        luts2 = self.lane2._view_luts_dev
        if lane1.device.type != "cuda":
            ptok.bundle = self._step(
                tok1, bits1, args1, luts1, tok2, bits2, args2, luts2, kernel
            )
        else:
            with torch.cuda.device(lane1.device):
                dev1 = lane1._upload(args1)
                dev2 = self.lane2._upload(args2)
                bundle = self._step(
                    tok1, bits1, dev1, luts1, tok2, bits2, dev2, luts2, kernel
                )
                ptok.bundle, ptok.event = lane1._enqueue_fetch(
                    tok1.slot, bundle
                )
        self.dispatch_seconds += time.perf_counter() - prepared
        return ptok

    def _planes(self, tok1, bits1, args1, luts1, tok2, bits2, args2, luts2):
        """The device work of the pair step before the counts: both lanes'
        :meth:`_MateLane._core`, the per-pair ``m_col = min(win1, win2)``
        zeroed below the insert-overlap floor and the reversal gather of
        mate 2's complemented plane. Returns (result rows of both lanes,
        mate 1's window lengths, ``m_col`` [B] int32, ``ref_plane`` and
        ``query_plane`` [B, w_ins] uint8)."""
        w1, w2 = tok1.width, tok2.width
        main1, win1_16, tables1 = args1
        main2, win2_16, tables2 = args2
        rows1, win1, plane1 = self.lane1._core(
            w1, bits1, main1, win1_16, luts1 if tables1 is None else tables1,
            need_plane=True,
        )
        rows2, win2, plane2 = self.lane2._core(
            w2, bits2, main2, win2_16, luts2 if tables2 is None else tables2,
            need_plane=True,
        )
        w_ins = min(w1, w2)
        # per-pair truncated length; ineligible pairs (below the
        # insert-overlap floor) are zeroed so no candidates emerge
        m_col = torch.minimum(win1, win2)
        m_col = torch.where(
            m_col >= self.cutter.min_insert_len, m_col, torch.zeros_like(m_col)
        )
        # reversal of the complemented mate 2 window = one gather
        t = torch.arange(w_ins, device=m_col.device)
        idx = (m_col.long()[:, None] - 1 - t[None, :]).clamp(0, w2 - 1)
        ref_plane = plane2.gather(1, idx)  # [B, w_ins]
        query_plane = plane1[:, :w_ins]
        return rows1 + rows2, win1, m_col, ref_plane, query_plane

    def _step(self, tok1, bits1, args1, luts1, tok2, bits2, args2, luts2,
              kernel):
        """The fused pair step: :meth:`_planes`, the diagonal counts, then
        the candidate slots (window <= 255) or the counts plane; one int16
        bundle out."""
        rows, win1, m_col, ref_plane, query_plane = self._planes(
            tok1, bits1, args1, luts1, tok2, bits2, args2, luts2
        )
        w_ins = query_plane.shape[1]
        counts = kernel(
            ref_plane.T.contiguous(), query_plane.T.contiguous(), m_col
        )
        if w_ins <= insert_kernel.PACKED_MAX_W:
            # on-device candidate reconstruction: only the fixed-size
            # candidate stream crosses the link, not the counts plane
            slots, meta = insert_candidate_slots(
                counts, m_col, ref_plane, query_plane, self._step_table,
                self.matcher.min_overlap, self.matcher.max_matches,
            )
            rows += [slots, meta]
        else:
            rows.append(counts.to(torch.int32))
        return _MateLane._finish_bundle(rows, win1)

    # -- resolve --------------------------------------------------------------

    def _fetch(self, ptok):
        """The pair's bundle as an int32 array, once its event has passed;
        both mates' slots go back to their lanes' free lists."""
        if ptok.event is not None:
            began = time.perf_counter()
            ptok.event.synchronize()
            self.wait_seconds += time.perf_counter() - began
        arr = ptok.bundle.numpy().astype(np.int32)
        ptok.bundle = None
        for lane, tok in ((self.lane1, ptok.tok1), (self.lane2, ptok.tok2)):
            if tok.slot is not None:
                lane._free_slots.append(tok.slot)
                tok.slot = None
        return arr

    def resolve(self, ptok):
        """Wait for the fused bundle; produce final per-mate windows +
        matched flags, accumulating every InsertAdapterCutter statistic
        exactly as the scalar pipeline would."""
        tok1, tok2 = ptok.tok1, ptok.tok2
        batch = tok1.batch
        arr = self._fetch(ptok)[:, :batch]
        lane1, lane2 = self.lane1, self.lane2

        rpa1 = lane1.res_rows(tok1.width)
        rpa2 = lane2.res_rows(tok2.width)
        cursor = rpa1 + rpa2
        # the quality windows were applied at submit (host-native path)
        ks1, kp1 = tok1.keep_start, tok1.keep_stop
        ks2, kp2 = tok2.keep_start, tok2.keep_stop
        w_ins = min(tok1.width, tok2.width)
        if w_ins <= insert_kernel.PACKED_MAX_W:
            n_slots = INSERT_CANDIDATE_SLOTS
            vals = arr[cursor : cursor + n_slots] + 32768
            meta = arr[cursor + n_slots : cursor + n_slots + 3]
            has_final = meta[1] >= 512
            cd = dict(
                kind="slots",
                s=(vals & 0xFF) - 1,
                cnt=vals >> 8,
                n_cand=meta[0],
                final_ok=has_final,
                final_s=meta[1] - np.where(has_final, 512, 0),
                final_cnt=meta[2],
            )
        else:
            cd = dict(kind="counts", counts=arr[cursor : cursor + w_ins])

        wl1 = kp1 - ks1
        wl2 = kp2 - ks2
        res1 = self._mate_res(lane1, arr[0:rpa1], wl1)
        res2 = self._mate_res(lane2, arr[rpa1 : rpa1 + rpa2], wl2)

        sel = self._select(cd, tok1, tok2, wl1, wl2)
        m1, m2, info = self._combine(sel, res1, res2, wl1, wl2)
        len1_eff, len2_eff = wl1, wl2
        corr1 = corr2 = None
        if self.cutter.mismatch_action is not None:
            len1_eff, len2_eff, corr1, corr2 = self._correct(
                tok1, tok2, wl1, wl2, sel, info
            )
        for tok, mate, ks, len_eff in (
            (tok1, m1, ks1, len1_eff), (tok2, m2, ks2, len2_eff),
        ):
            tok.win_start = ks
            tok.win_stop = (ks + len_eff).astype(np.int32)
            tok.match_data = dict(
                matched=mate["present"],
                best_idx=np.where(mate["present"], 0, -1),
                astart=mate["astart"],
                astop=mate["astop"],
                rstart=mate["rstart"],
                rstop=mate["rstop"],
                errors=mate["errors"],
                front=np.zeros(tok.batch, bool),
            )
        kp1 = self._apply_mate(lane1, tok1, m1, ks1, len1_eff, 0)
        kp2 = self._apply_mate(lane2, tok2, m2, ks2, len2_eff, 1)
        if corr1 is not None:
            tok1.alt = self._build_alt(corr1, ks1, kp1)
        if corr2 is not None:
            tok2.alt = self._build_alt(corr2, ks2, kp2)
        return ks1, kp1, m1["present"], ks2, kp2, m2["present"]

    @staticmethod
    def _mate_res(lane, rows, wl):
        """The mate's fallback adapter result with match_to validation
        (in-kernel overlap/error gates + the host max_rmp gate)."""
        if rows.shape[0] == 3:
            res = _MateLane._unpack_res_rows(rows)
        else:
            res = dict(
                found=rows[0].astype(bool),
                start1=rows[1],
                stop1=rows[2],
                start2=rows[3],
                stop2=rows[4],
                matches=rows[5],
                cost=rows[6],
            )
        res["found"] = res["found"] & (wl > 0)
        return lane._validate(0, res)

    def _rmp_bulk(self, matches, size, base_probs=None):
        """Vectorized RandomMatchProbability over unique (matches, size)
        pairs — the same cached float64 scalar evaluator, so the decisions
        are the reference's bit for bit."""
        out = np.empty(matches.shape[0], np.float64)
        prob_fn = self.aligner.match_probability
        kwargs = base_probs or {}
        keys = matches * (1 << 20) + size
        for key in np.unique(keys):
            kmatches, ksize = divmod(int(key), 1 << 20)
            out[keys == key] = prob_fn(kmatches, ksize, **kwargs)
        return out

    def _overhang(self, tok, rows_b, starts, lens, ad_raw, ad_t):
        """Vectorized compare_prefixes of each pair's adapter overhang
        (window bytes from ``starts``, ``lens`` long) vs the adapter."""
        count = rows_b.shape[0]
        cap = int(lens.max()) if count else 0
        if cap == 0:
            zeros = np.zeros(count, np.int64)
            return zeros, zeros
        tt = np.arange(cap, dtype=np.int64)[None, :]
        gidx = np.clip(starts[:, None] + tt, 0, tok.width - 1)
        sub = tok.seqs[: tok.batch][rows_b]
        window = np.take_along_axis(sub, gidx, axis=1)
        valid = tt < lens[:, None]
        if self._cmp_ascii:
            eq = window == ad_raw[None, :cap]
        else:
            eq = (self._ref_lut[window] & ad_t[None, :cap]) != 0
        matches = (eq & valid).sum(axis=1).astype(np.int64)
        return lens - matches, matches

    def _host_planes(self, tok1, tok2, m_eff, w_ins):
        """Host byte planes equal to the device matcher's inputs (ref =
        reversed complemented mate 2 window, query = mate 1)."""
        batch = tok1.batch
        comp2 = self._complement[tok2.seqs[:batch]]
        t = np.arange(w_ins)
        idx = np.clip(m_eff[:, None] - 1 - t[None, :], 0, tok2.width - 1)
        refs = np.take_along_axis(comp2[:, : tok2.width], idx, axis=1)
        refs = np.where(t[None, :] < m_eff[:, None], refs, 0).astype(np.uint8)
        query = np.ascontiguousarray(tok1.seqs[:batch, :w_ins])
        return refs, query

    def _assemble_candidates(self, cd, tok1, tok2, m_eff, w_ins):
        """The per-pair candidate stream as flat arrays (s, pair,
        stream-rank, match count, is_final), from either the device slots
        (overflow pairs recomputed on the host) or a full counts plane."""
        if cd["kind"] == "counts":
            counts = cd["counts"]
            refs, query = self._host_planes(tok1, tok2, m_eff, w_ins)
            arrs = self.matcher.candidate_arrays(counts, refs, query, m_eff)
            ss, bs = np.nonzero(arrs["cand"])
            fb = np.nonzero(arrs["final_ok"])[0]
            fs = arrs["final_s"][fb]
            s_list = [ss, fs]
            b_list = [bs, fb]
            r_list = [arrs["rank"][ss, bs], arrs["n_cand"][fb]]
            mt_list = [counts[ss, bs], counts[fs, fb]]
            fin_list = [np.zeros(ss.size, bool), np.ones(fb.size, bool)]
        else:
            n_slots = cd["s"].shape[0]
            overflow = cd["n_cand"] > n_slots
            present = (cd["s"] >= 0) & ~overflow[None, :]
            cs, bs = np.nonzero(present)
            f_mask = cd["final_ok"] & ~overflow
            fb = np.nonzero(f_mask)[0]
            s_list = [cd["s"][cs, bs], cd["final_s"][fb]]
            b_list = [bs, fb]
            r_list = [cs, cd["n_cand"][fb]]
            mt_list = [cd["cnt"][cs, bs], cd["final_cnt"][fb]]
            fin_list = [np.zeros(cs.size, bool), np.ones(fb.size, bool)]
            orows = np.nonzero(overflow)[0]
            if orows.size:
                SLOT_OVERFLOWS["pairs"] += int(orows.size)
                refs, query = self._host_planes(tok1, tok2, m_eff, w_ins)
                refs_o = refs[orows]
                query_o = query[orows]
                m_o = m_eff[orows]
                # the plain diagonal counts, on the host (m_eff <= w_ins,
                # so its rotation never wraps)
                counts_o = _diagonal_match_counts(
                    torch.from_numpy(refs_o.T), torch.from_numpy(query_o.T),
                    torch.from_numpy(m_o),
                ).numpy()
                arrs = self.matcher.candidate_arrays(
                    counts_o, refs_o, query_o, m_o
                )
                ss2, bs2 = np.nonzero(arrs["cand"])
                fb2 = np.nonzero(arrs["final_ok"])[0]
                fs2 = arrs["final_s"][fb2]
                s_list += [ss2, fs2]
                b_list += [orows[bs2], orows[fb2]]
                r_list += [arrs["rank"][ss2, bs2], arrs["n_cand"][fb2]]
                mt_list += [counts_o[ss2, bs2], counts_o[fs2, fb2]]
                fin_list += [
                    np.zeros(ss2.size, bool), np.ones(fb2.size, bool),
                ]
        s_all = np.concatenate(s_list).astype(np.int64)
        b_all = np.concatenate(b_list).astype(np.int64)
        rank_all = np.concatenate(r_list).astype(np.int64)
        mt = np.concatenate(mt_list).astype(np.int64)
        is_final = np.concatenate(fin_list)
        return s_all, b_all, rank_all, mt, is_final

    def _select(self, cd, tok1, tok2, wl1, wl2):
        """Per-pair insert-candidate selection: RMP filter, sort by
        probability (stream order on ties), first candidate surviving
        the overhang-adapter checks wins (``match_insert`` semantics)."""
        batch = tok1.batch
        aligner = self.aligner
        w_ins = min(tok1.width, tok2.width)
        out = dict(
            has=np.zeros(batch, bool),
            only=np.zeros(batch, bool),
            ims=np.zeros(batch, np.int64),
            mm=np.zeros(batch, np.int64),
            alen1=np.zeros(batch, np.int64),
            alen2=np.zeros(batch, np.int64),
            # selected-candidate geometry for overlap error correction
            cost=np.zeros(batch, np.int64),
            r1e=np.zeros(batch, np.int64),
            r2e=np.zeros(batch, np.int64),
        )
        m = np.minimum(wl1, wl2).astype(np.int64)
        out["eligible"] = eligible = m >= self.cutter.min_insert_len
        m_eff = np.where(eligible, m, 0)
        if not m_eff.any():
            return out

        s_all, b_all, rank_all, mt, is_final = self._assemble_candidates(
            cd, tok1, tok2, m_eff, w_ins
        )
        if s_all.size == 0:
            return out
        m_all = m_eff[b_all]
        qstop = np.where(is_final, m_all, m_all - s_all)
        offset = np.minimum(s_all, m_all - qstop)
        ims = m_all - offset
        prob = self._rmp_bulk(mt, ims, aligner.base_probs)
        keep = prob <= aligner.insert_max_rmp
        if not keep.any():
            return out
        s_all, b_all, rank_all, offset, ims, prob, qstop, mt = (
            a[keep]
            for a in (s_all, b_all, rank_all, offset, ims, prob, qstop, mt)
        )

        # _match evaluation per candidate (align/__init__.py:240-284)
        only = offset < aligner.min_adapter_overlap
        alen1 = np.minimum(offset, aligner.adapter1_len)
        alen2 = np.minimum(offset, aligner.adapter2_len)
        e1, mt1 = self._overhang(tok1, b_all, ims, alen1, self._ad1, self._ad1_t)
        e2, mt2 = self._overhang(tok2, b_all, ims, alen2, self._ad2, self._ad2_t)
        frac = aligner.max_adapter_mismatch_frac
        fail = (e1 > np.round(alen1 * frac)) & (e2 > np.round(alen2 * frac))
        check = np.minimum(alen1, alen2) > aligner.adapter_check_cutoff
        if check.any():
            p1 = self._rmp_bulk(mt1, alen1)
            p2 = self._rmp_bulk(mt2, alen2)
            fail |= check & ((p1 * p2) > aligner.adapter_max_rmp)
        ok = only | ~fail
        if not ok.any():
            return out

        # first surviving candidate per pair in (prob, stream) order
        order = np.lexsort((rank_all, prob, b_all))
        b_sorted = b_all[order]
        ok_pos = np.nonzero(ok[order])[0]
        first = np.full(batch, -1, np.int64)
        first[b_sorted[ok_pos[::-1]]] = ok_pos[::-1]
        has = first >= 0
        rowsel = order[first[has]]
        out["has"] = has
        out["only"][has] = only[rowsel]
        out["ims"][has] = ims[rowsel]
        out["mm"][has] = np.minimum(e1, e2)[rowsel]
        out["alen1"][has] = alen1[rowsel]
        out["alen2"][has] = alen2[rowsel]
        # selected insert_match geometry for the correction stage:
        # r1 overlap = [0, querystop), r2 overlap = [0, m - s); cost is
        # the candidate's mismatch count over the truncated overlap
        out["cost"][has] = ims[rowsel] - mt[rowsel]
        out["r1e"][has] = qstop[rowsel]
        out["r2e"][has] = m_eff[b_all[rowsel]] - s_all[rowsel]
        return out

    def _combine(self, sel, res1, res2, wl1, wl2):
        """Selection + fallback + symmetric duplication -> per-mate match
        field arrays plus correction-frame info
        (InsertAdapterCutter.__call__ flow)."""
        batch = wl1.shape[0]
        has = sel["has"]
        ipass = has & ~sel["only"]
        info = dict(
            frame=np.zeros(batch, bool),
            frame_rstart=np.zeros(batch, np.int64),
        )

        def blank():
            zero = np.zeros(batch, np.int64)
            return dict(
                present=np.zeros(batch, bool),
                rstart=zero.copy(),
                rstop=zero.copy(),
                astart=zero.copy(),
                astop=zero.copy(),
                errors=zero.copy(),
            )

        m1, m2 = blank(), blank()
        # insert-path matches (_create_match, modifiers.py:274-278)
        for mate, alen_key, wl in ((m1, "alen1", wl1), (m2, "alen2", wl2)):
            ims = sel["ims"]
            alen_eff = np.minimum(sel[alen_key], wl - ims)
            errors = np.minimum(alen_eff, sel["mm"])
            if ipass.any():
                # Match invariants (align Match.__init__), scalar parity
                if (alen_eff[ipass] <= 0).any():
                    raise ValueError("Match length must be >= 0")
                if ((alen_eff - errors)[ipass] <= 0).any():
                    raise ValueError(
                        "A Match requires at least one matching position."
                    )
            mate["present"] = ipass.copy()
            mate["rstart"] = np.where(ipass, ims, 0)
            mate["rstop"] = np.where(ipass, wl, 0)
            mate["astop"] = np.where(ipass, alen_eff, 0)
            mate["errors"] = np.where(ipass, errors, 0)

        # fallback independent matches for pairs without an insert result
        fallback = (~has) & sel["eligible"]
        for mate, res in ((m1, res1), (m2, res2)):
            fpres = fallback & res["found"]
            mate["present"] |= fpres
            for field, src in (
                ("rstart", "start2"), ("rstop", "stop2"),
                ("astart", "start1"), ("astop", "stop1"),
                ("errors", "cost"),
            ):
                mate[field] = np.where(fpres, res[src], mate[field])
        if self.cutter.mismatch_action:
            # both independent matches at the same read position imply an
            # overlap frame for error correction (modifiers.py:266-273)
            both = fallback & res1["found"] & res2["found"]
            agree = both & (res1["start2"] == res2["start2"])
            info["frame"] |= agree
            info["frame_rstart"] = np.where(
                agree, res1["start2"], info["frame_rstart"]
            )

        # symmetric duplication (_mirror_match, modifiers.py:228-238)
        if self.cutter.symmetric:
            mir12 = m1["present"] & ~m2["present"]
            mir21 = m2["present"] & ~m1["present"]
            for src, dst, wl_dst, mir in (
                (m1, m2, wl2, mir12), (m2, m1, wl1, mir21),
            ):
                ok = mir & (src["rstart"] <= wl_dst)
                shrink = ok & (src["rstop"] < wl_dst)
                dst["present"] |= ok
                dst["rstart"] = np.where(ok, src["rstart"], dst["rstart"])
                dst["rstop"] = np.where(
                    ok, np.where(shrink, wl_dst, src["rstop"]), dst["rstop"]
                )
                dst["astart"] = np.where(ok, src["astart"], dst["astart"])
                dst["astop"] = np.where(
                    ok,
                    np.where(
                        shrink,
                        src["astop"] - (wl_dst - src["rstop"]),
                        src["astop"],
                    ),
                    dst["astop"],
                )
                dst["errors"] = np.where(ok, src["errors"], dst["errors"])
                if self.cutter.mismatch_action:
                    # mirror-created pairs gain the overlap frame too
                    # (modifiers.py:280-282) when no insert frame exists
                    frame_new = ok & ~has & ~info["frame"]
                    info["frame"] |= frame_new
                    info["frame_rstart"] = np.where(
                        frame_new, m1["rstart"], info["frame_rstart"]
                    )
        return m1, m2, info

    def _apply_mate(self, lane, tok, mate, ks, wl, mate_idx):
        """_trim_mate per mate: trim window + adapter statistics
        (modifiers.py:292-314; Adapter._trimmed_back). ``wl`` is the
        mate's current length, which the correction's read-1 truncation
        quirk may have shortened."""
        present = mate["present"]
        self.cutter.with_adapters[mate_idx] += int(present.sum())
        trim = present & (mate["rstart"] < wl)
        if trim.any():
            adapter = lane.adapters[0]
            rstart = mate["rstart"][trim]
            removed = (wl[trim] - rstart).astype(np.int64)
            lane._bump_histograms(
                adapter.lengths_back, adapter.errors_back,
                removed, mate["errors"][trim],
            )
            rows = np.nonzero(trim)[0]
            prev = np.where(
                rstart > 0,
                tok.seqs[rows, np.maximum(rstart - 1, 0)],
                0,
            )
            for byte, cnt in zip(*np.unique(prev, return_counts=True)):
                base = chr(int(byte))
                if base not in "ACGT":
                    base = ""
                adapter.adjacent_bases[base] += int(cnt)
        return np.where(trim, ks + mate["rstart"], ks + wl).astype(np.int32)

    # -- overlap error correction (--correct-mismatches) ----------------------

    def _correct(self, tok1, tok2, wl1, wl2, sel, info):
        """Vectorized ErrorCorrectorMixin.correct_errors over the batch
        (truncate_seqs=True semantics; ref ``modifiers.py:201-357``,
        scalar twin ``modifiers/paired.py:40-191``). Corrected bytes are
        written back into the toks' host matrices (so neighbor stats and
        N-content filtering see them); per-mate (quals, changed) come
        back for alt-buffer output assembly. Returns
        (len1_eff, len2_eff, corr1 | None, corr2 | None) — len1_eff
        carries the reference's read1 tail-loss quirk."""
        batch = tok1.batch
        action = self.cutter.mismatch_action
        len_eff = np.minimum(wl1, wl2)

        # correction frames: selected insert match with mismatches, the
        # equal-rstart fallback frame, or the symmetric-mirror frame
        do = sel["has"] & (sel["cost"] > 0)
        frame = info["frame"]
        r1e = np.where(frame, info["frame_rstart"],
                       np.where(do, sel["r1e"], 0))
        r2s = np.where(frame, len_eff - wl2, 0)
        r2e = np.where(frame, info["frame_rstart"] - (wl2 - len_eff),
                       np.where(do, sel["r2e"], 0))
        do = do | frame
        span = np.where(do, np.minimum(r1e, r2e - r2s), 0)
        span = np.maximum(span, 0)
        cap = int(span.max()) if batch else 0
        if cap == 0:
            return wl1, wl2, None, None

        seq1 = tok1.seqs[:batch]
        seq2 = tok2.seqs[:batch]
        lane1, lane2 = self.lane1, self.lane2
        has_quals = bool(
            tok1.chunk.qual_len[tok1.sub].size
            and tok1.chunk.qual_len[tok1.sub].max(initial=0) > 0
            and tok2.chunk.qual_len[tok2.sub].max(initial=0) > 0
        )
        q1 = q2 = None
        if has_quals:
            q1 = lane1._gather(
                tok1.chunk, tok1.sub, tok1.chunk.qual_off,
                tok1.keep_start, tok1.width,
            )
            q2 = lane2._gather(
                tok2.chunk, tok2.sub, tok2.chunk.qual_off,
                tok2.keep_start, tok2.width,
            )
        elif action in ("liberal", "conservative"):
            raise ValueError(
                "Cannot perform quality-based error correction on reads "
                "lacking quality information"
            )

        k = np.arange(cap, dtype=np.int64)[None, :]
        valid = k < span[:, None]
        rows = np.arange(batch)[:, None]
        pos1 = np.broadcast_to(k, (batch, cap))
        pos2 = r2e[:, None] - 1 - k
        # scalar negative-index wrap on the (possibly truncated) mate2
        pos2 = np.where(pos2 < 0, pos2 + len_eff[:, None], pos2)
        pos1c = np.clip(pos1, 0, tok1.width - 1)
        pos2c = np.clip(pos2, 0, tok2.width - 1)
        comp = _complement_lut()
        b1 = seq1[rows, pos1c].copy()
        b2raw = seq2[rows, pos2c].copy()
        b2 = comp[b2raw]
        mismatch = valid & (b1 != b2)
        n_byte = np.uint8(ord("N"))

        def scatter(matrix, pos, mask, values):
            # masked flat scatter: rows beyond their span carry wrapped
            # positions that DUPLICATE real ones — an unmasked fancy
            # assignment would let those no-op writes land after (and
            # clobber) genuine corrections
            hit = np.nonzero(mask)
            matrix[hit[0], pos[hit]] = values[hit]

        if action == "N":
            scatter(seq1, pos1c, mismatch, np.broadcast_to(n_byte, b1.shape))
            scatter(seq2, pos2c, mismatch, np.broadcast_to(n_byte, b1.shape))
            changed1 = mismatch.sum(axis=1)
            changed2 = changed1.copy()
        else:
            q1v = q1[rows, pos1c].astype(np.int32)
            q2v = q2[rows, pos2c].astype(np.int32)
            fix1 = mismatch & (b1 == n_byte)
            fix2 = mismatch & ~fix1 & (b2 == n_byte)
            rest = mismatch & ~fix1 & ~fix2
            qdiff = q1v - q2v
            take1 = rest & (qdiff >= self.cutter.r1r2_min_qual_difference)
            take2 = rest & (qdiff <= self.cutter.r2r1_min_qual_difference)
            fix2 = fix2 | take1
            fix1 = fix1 | take2
            scatter(seq1, pos1c, fix1, b2)
            scatter(seq2, pos2c, fix2, comp[b1])
            scatter(q1, pos1c, fix1, q2v.astype(np.uint8))
            scatter(q2, pos2c, fix2, q1v.astype(np.uint8))
            changed1 = fix1.sum(axis=1)
            changed2 = fix2.sum(axis=1)
            if action == "liberal":
                deferred = rest & ~take1 & ~take2
                def_rows = deferred.any(axis=1)
                if def_rows.any():
                    # tie-break by mean overlap-window quality, computed
                    # AFTER the per-base fixes (reference evaluation order)
                    idx1w = np.arange(tok1.width, dtype=np.int64)[None, :]
                    w1 = idx1w < r1e[:, None]
                    sum1 = (q1[:batch].astype(np.int64) * w1).sum(axis=1)
                    start2 = np.where(r2s < 0, len_eff + r2s, r2s)
                    start2 = np.maximum(start2, 0)
                    stop2 = np.clip(r2e, 0, len_eff)
                    idx2w = np.arange(tok2.width, dtype=np.int64)[None, :]
                    w2 = (idx2w >= start2[:, None]) & (idx2w < stop2[:, None])
                    sum2 = (q2[:batch].astype(np.int64) * w2).sum(axis=1)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        mean1 = sum1 / np.maximum(r1e, 1)
                        mean2 = sum2 / np.maximum(stop2 - start2, 1)
                    gap = mean1 - mean2
                    ovr2 = deferred & (gap > 1)[:, None]
                    ovr1 = deferred & (gap < -1)[:, None]
                    if ovr2.any():
                        # the reference writes the ORIGINAL captured
                        # bases, not the post-fix state (paired.py:150-153)
                        scatter(seq2, pos2c, ovr2, comp[b1])
                        scatter(q2, pos2c, ovr2, q1v.astype(np.uint8))
                        changed2 = changed2 + ovr2.sum(axis=1)
                    if ovr1.any():
                        scatter(seq1, pos1c, ovr1, b2)
                        scatter(q1, pos1c, ovr1, q2v.astype(np.uint8))
                        changed1 = changed1 + ovr1.sum(axis=1)

        r1_changed = changed1 > 0
        r2_changed = changed2 > 0
        any_changed = r1_changed | r2_changed
        self.cutter.corrected_pairs += int(any_changed.sum())
        self.cutter.corrected_bp[0] += int(changed1.sum())
        self.cutter.corrected_bp[1] += int(changed2.sum())
        # truncate_seqs quirk: a CHANGED read1 longer than read2 loses
        # its tail (only the read2 truncation keeps it; paired.py:74-87)
        len1_eff = np.where(r1_changed & (wl1 > wl2), wl2, wl1)
        corr1 = (tok1, q1, r1_changed) if r1_changed.any() else None
        corr2 = (tok2, q2, r2_changed) if r2_changed.any() else None
        return len1_eff, wl2, corr1, corr2

    @staticmethod
    def _build_alt(corr, ks, kp):
        """Patch-buffer output data for the corrected records: the final
        (post-trim) seq/qual windows of every changed record, densely
        packed ([seqs...][quals...]); -1 offsets mean 'unchanged, use the
        chunk buffer'. The layout is :func:`_format_records`' ``alt``."""
        tok, quals, changed = corr
        if not changed.any():
            return None
        batch = tok.batch
        final_len = (kp - ks).astype(np.int64)
        seq_beg = np.full(batch, -1, np.int64)
        seq_end = np.full(batch, -1, np.int64)
        qual_beg = np.full(batch, -1, np.int64)
        rows = np.nonzero(changed)[0]
        lens = final_len[rows]
        offs = np.cumsum(lens) - lens
        total = int(lens.sum())
        seq_beg[rows] = offs
        seq_end[rows] = offs + lens
        qual_beg[rows] = offs + total
        buf = np.empty(2 * total, np.uint8)
        # vectorized ranges-copy out of the row-major matrices
        width = tok.width
        flat_pos = (
            np.repeat(rows * width, lens)
            + (np.arange(total) - np.repeat(offs, lens))
        )
        buf[:total] = tok.seqs[:batch].reshape(-1)[flat_pos]
        buf[total:] = (
            quals[:batch].reshape(-1)[flat_pos]
            if quals is not None
            else 0
        )
        # the records keep their own name and plus lines
        return (
            buf, seq_beg, seq_end, qual_beg,
            np.full(batch, -1, np.int64), np.zeros(batch, np.int32),
            np.full(batch, -1, np.int64), np.zeros(batch, np.int32),
        )


def _gather_name_bytes(chunk, sub, width):
    offs = np.ascontiguousarray(chunk.name_off[sub], np.int64)
    lens = np.ascontiguousarray(chunk.name_len[sub], np.int32)
    out = np.zeros((offs.shape[0], width), np.uint8)
    runtime.lib().gather_padded(
        _u8(chunk.buf), _i64(offs), _i32(lens),
        offs.shape[0], width, _u8(out),
    )
    return out, lens


def validate_pair_names(chunk1, sub1, chunk2, sub2, interleaved=False):
    """Vectorized twin of ``seqio.sequence_names_match`` over whole
    record ranges: first whitespace-delimited token, ignoring a trailing
    1/2 mate digit; raises the scalar reader's FormatError on the first
    improperly-paired record."""
    width = int(
        max(
            chunk1.name_len[sub1].max(initial=1),
            chunk2.name_len[sub2].max(initial=1),
        )
    )
    a1, len1 = _gather_name_bytes(chunk1, sub1, width)
    a2, len2 = _gather_name_bytes(chunk2, sub2, width)
    idx = np.arange(width, dtype=np.int32)[None, :]

    def token_len(arr, lens):
        ws = ((arr == 32) | (arr == 9)) & (idx < lens[:, None])
        has = ws.any(axis=1)
        first = np.where(has, ws.argmax(axis=1), lens)
        return first.astype(np.int32)

    t1 = token_len(a1, len1)
    t2 = token_len(a2, len2)
    diff = a1 != a2
    has_diff = diff.any(axis=1)
    mismatch_at = np.where(has_diff, diff.argmax(axis=1), width)
    ok_full = (t1 == t2) & (mismatch_at >= t1)
    last1 = a1[np.arange(a1.shape[0]), np.maximum(t1 - 1, 0)]
    last2 = a2[np.arange(a2.shape[0]), np.maximum(t2 - 1, 0)]
    both_12 = (
        (t1 > 0) & (t2 > 0)
        & ((last1 == ord("1")) | (last1 == ord("2")))
        & ((last2 == ord("1")) | (last2 == ord("2")))
    )
    ok_strip = both_12 & (t1 == t2) & (mismatch_at >= t1 - 1)
    bad = ~(ok_full | ok_strip)
    if bad.any():
        row = int(np.nonzero(bad)[0][0])
        name1 = a1[row, : len1[row]].tobytes().decode("latin-1")
        name2 = a2[row, : len2[row]].tobytes().decode("latin-1")
        if interleaved:
            raise FormatError(
                "Reads are improperly paired. Name {0!r} (first) does "
                "not match {1!r} (second).".format(name1, name2)
            )
        raise FormatError(
            "Reads are improperly paired. Read name '{0}' in file 1 "
            "does not match '{1}' in file 2.".format(name1, name2)
        )


def _record_byte_lengths(chunk, sub, keep_start, keep_stop, keep, fmt,
                         alt=None):
    """Per-record output byte length for the KEPT records, matching the
    native formatters' layout exactly (alt-patched records use the
    patch-window lengths)."""
    name_len = chunk.name_len[sub][keep].astype(np.int64)
    klen = np.maximum(keep_stop - keep_start, 0)[keep].astype(np.int64)
    plus_len = chunk.plus_len[sub][keep].astype(np.int64)
    if alt is not None:
        _, alt_sb, alt_se, _, alt_nb, alt_nl, _, alt_pl = alt
        patched = alt_sb[keep] >= 0
        klen = np.where(patched, (alt_se - alt_sb)[keep], klen)
        renamed = alt_nb[keep] >= 0
        name_len = np.where(renamed, alt_nl[keep], name_len)
        plus_len = np.where(renamed, alt_pl[keep], plus_len)
    if fmt == "fasta":
        return 2 + name_len + klen + 1
    return 4 + name_len + 2 * klen + plus_len + 2


def _interleave_records(parts1, parts2):
    """Merge two formatted byte streams record-alternately: (bytes,
    per-record lengths) per mate in, interleaved bytes out (one ranges
    gather, no per-record Python)."""
    (b1, l1), (b2, l2) = parts1, parts2
    count = l1.shape[0]
    if count == 0:
        return b""
    src = np.frombuffer(b1 + b2, np.uint8)
    starts = np.empty(2 * count, np.int64)
    starts[0::2] = np.cumsum(l1) - l1
    starts[1::2] = len(b1) + np.cumsum(l2) - l2
    sizes = np.empty(2 * count, np.int64)
    sizes[0::2] = l1
    sizes[1::2] = l2
    total = int(sizes.sum())
    pos = np.repeat(np.cumsum(sizes) - sizes, sizes)
    idx = np.arange(total, dtype=np.int64) - pos + np.repeat(starts, sizes)
    return src[idx].tobytes()


def _format_records(chunk, sub, keep_start, keep_stop, keep, fmt="fastq",
                    alt=None):
    """Native formatter: trimmed FASTQ/FASTA bytes for the kept records.
    ``alt`` = (buf, seq_beg, seq_end, qual_beg, name_beg, name_len,
    plus_beg, plus_len) supplies replacement bytes for records whose
    content changed (mate overwrite swaps in the partner's whole record;
    -1 in seq_beg and name_beg marks the records that keep their own)."""
    name_off = np.ascontiguousarray(chunk.name_off[sub])
    name_len = np.ascontiguousarray(chunk.name_len[sub])
    seq_off = np.ascontiguousarray(chunk.seq_off[sub])
    ks = np.ascontiguousarray(keep_start, np.int32)
    kp = np.ascontiguousarray(keep_stop, np.int32)
    kmask = np.ascontiguousarray(keep.astype(np.uint8))
    kept_bp = int(np.maximum(kp - ks, 0)[keep].sum())
    if alt is not None:
        kept_bp += int(np.maximum(alt[2] - alt[1], 0)[keep].sum())
    if fmt == "fasta":
        cap = int(name_len.sum()) + kept_bp + name_off.shape[0] * 4 + 16
        out = np.empty(cap, dtype=np.uint8)
        written = runtime.lib().fasta_format_trimmed(
            _u8(chunk.buf),
            _i64(name_off), _i32(name_len), _i64(seq_off),
            _i32(ks), _i32(kp), _u8(kmask),
            name_off.shape[0],
            _u8(out), cap,
        )
    else:
        plus_off = np.ascontiguousarray(chunk.plus_off[sub])
        plus_len = np.ascontiguousarray(chunk.plus_len[sub])
        qual_off = np.ascontiguousarray(chunk.qual_off[sub])
        cap = int(
            name_len.sum() + plus_len.sum() + 2 * kept_bp
            + name_off.shape[0] * 8 + 16
        )
        if alt is None:
            alt_args = (None,) * 8
        else:
            cap += int(alt[5][keep].sum() + alt[7][keep].sum())
            alt_args = (
                _u8(alt[0]),
                _i64(np.ascontiguousarray(alt[1], np.int64)),
                _i64(np.ascontiguousarray(alt[2], np.int64)),
                _i64(np.ascontiguousarray(alt[3], np.int64)),
                _i64(np.ascontiguousarray(alt[4], np.int64)),
                _i32(np.ascontiguousarray(alt[5], np.int32)),
                _i64(np.ascontiguousarray(alt[6], np.int64)),
                _i32(np.ascontiguousarray(alt[7], np.int32)),
            )
        out = np.empty(cap, dtype=np.uint8)
        written = runtime.lib().fastq_format_trimmed(
            _u8(chunk.buf),
            _i64(name_off), _i32(name_len),
            _i64(seq_off),
            _i64(plus_off), _i32(plus_len),
            _i64(qual_off),
            _i32(ks), _i32(kp), _u8(kmask),
            name_off.shape[0],
            _u8(out), cap,
            *alt_args,
        )
    if written < 0:
        raise RuntimeError("format capacity exceeded")
    return out[:written].tobytes()


class _AsyncWriter:
    """Single background writer thread: output bytes are enqueued in
    resolution order (one queue, one thread — per-file byte order is
    preserved) so disk/compression time overlaps device compute and
    link transfer. ``data`` may be a zero-arg callable producing the
    bytes — the native formatter then ALSO runs on this thread,
    overlapping record assembly with the main thread's window
    resolution. Errors surface on the next enqueue or close."""

    def __init__(self):
        import queue
        import threading

        self._q = queue.Queue(maxsize=8)
        self._exc = None
        #: seconds this thread spent producing (formatting) and writing
        self.format_seconds = 0.0
        self.write_seconds = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is None:
                handle, data = item
                try:
                    began = time.perf_counter()
                    if callable(data):
                        data = data()
                    formatted = time.perf_counter()
                    handle.write(data)
                    self.format_seconds += formatted - began
                    self.write_seconds += time.perf_counter() - formatted
                except BaseException as exc:  # propagate to the producer
                    self._exc = exc

    def write(self, handle, data):
        if self._exc is not None:
            raise self._exc
        self._q.put((handle, data))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            raise self._exc



class _TurboRunnerBase:
    """Shared runner plumbing: eligibility helpers, output opening."""

    CHUNK_BYTES = 64 * 1024 * 1024
    MAX_BATCH = 32768
    DEPTH = 3
    PREFETCH = 2

    @staticmethod
    def _decline(reason):
        """``build`` returns None for such a configuration: the trim
        command then runs it through the per-record pipeline and its
        batched engine."""
        logging.getLogger().info("turbo path declined: %s", reason)
        return None

    @staticmethod
    def _unwrap_handler(record_handler):
        """(inner RecordHandler, stats wrapper | None), or a decline-reason
        string. ``--stats`` runs through turbo: pre/post ReadStatistics
        collect straight from the gathered matrices (only per-tile
        statistics, which need per-record name parsing, decline)."""
        from atropos_tpu_torch.commands.trim.pipeline import (
            StatsRecordHandlerWrapper,
        )

        if not isinstance(record_handler, StatsRecordHandlerWrapper):
            return record_handler, None
        for kw_name in ("pre_kwargs", "post_kwargs"):
            kwargs = getattr(record_handler, kw_name, None)
            if kwargs and kwargs.get("tiles"):
                return "per-tile statistics"
        return record_handler.record_handler, record_handler

    @classmethod
    def _check_common(cls, command_runner, record_handler):
        """Shared eligibility gates; returns a decline reason or None."""
        options = command_runner.options
        if options.colorspace:
            return "colorspace input"
        if options.action != "trim" or options.times != 1:
            return "action!=trim or times>1"
        if options.merged_output:
            return "merged output"
        if options.subsample:
            return "subsample"
        for ftype in record_handler.filters.filters:
            if ftype not in (
                TooShortReadFilter,
                TooLongReadFilter,
                NContentFilter,
                TrimmedFilter,
                UntrimmedFilter,
            ):
                return "unsupported filter %s" % ftype.__name__
        return None

    @staticmethod
    def _stream_format(path, explicit=None):
        """The chunk-stream format ('fastq' or 'fasta') for a path, or
        None when the path is unusable (stdin/stdout, a demultiplex
        template, or an unrecognized extension). ``explicit`` carries the
        CLI ``--format`` override for inputs."""
        if not path or not isinstance(path, str) or path == "-":
            return None
        if "{name}" in path:
            return None
        fmt = explicit or guess_format_from_name(path)
        return fmt if fmt in ("fastq", "fasta") else None

    @classmethod
    def _collect_output_formats(cls, formatters, allow_interleaved=False):
        """{path: format} for every destination formatter (main output
        plus untrimmed / too-short / too-long files), or a decline-reason
        string. The format comes from the formatter the trim stack
        already holds (so extension-less paths like /dev/null work
        exactly like the scalar writers). Also rejects one path serving
        different mate roles (per-batch grouped writes could not reproduce
        the scalar byte interleaving then); interleaved formatters (both
        mates, one file, record-alternating) are tracked by role 3."""
        fmts = {}
        role_of = {}
        for formatter in formatters.seq_formatters.values():
            fmt_obj = formatter.seq_format
            if type(fmt_obj) is FastqFormat:
                fmt = "fastq"
            elif (
                type(fmt_obj) is FastaFormat
                and fmt_obj.text_wrapper is None
            ):
                fmt = "fasta"
            else:
                return "unsupported output format"
            if isinstance(formatter, InterleavedFormatter):
                if not allow_interleaved:
                    return "interleaved output"
                roles = [(formatter.file1, 3)]
            else:
                roles = [(formatter.file1, 1)]
                file2 = getattr(formatter, "file2", None)
                if file2 is not None:
                    roles.append((file2, 2))
            for path, role in roles:
                if not path or not isinstance(path, str) or path == "-":
                    return "stdout/non-path output"
                fmts[path] = fmt
                if path != os.devnull and (
                    role_of.setdefault(path, role) != role
                ):
                    return "one path used for both mates"
        return fmts

    def _fmt_of(self, path):
        """Output format for a destination path (lazily resolved for
        demultiplex expansions)."""
        fmt = self._out_fmts.get(path)
        if fmt is None:
            fmt = self._stream_format(path)
            self._out_fmts[path] = fmt
        return fmt

    def _open_output(self, path):
        """Binary output handle (bytes from the native formatter go
        straight through — no text-codec round trip). Honors the Writers
        shard suffix (multi-process ranks) and registers with the
        container so close/force-create bookkeeping stays unified."""
        handle = self.writers.writers.get(path)
        if handle is None:
            physical = (
                add_suffix_to_path(path, self.writers.suffix)
                if self.writers.suffix
                else path
            )
            handle = xopen(physical, "wb")
            self.writers.writers[path] = handle
        return handle

    def _update_counts(self, total_records, bp_counts):
        summary = self.command_runner.summary
        if total_records:
            summary.update(
                record_counts={0: total_records},
                total_record_count=total_records,
                bp_counts={0: list(bp_counts)},
                total_bp_counts=tuple(bp_counts),
                sum_total_bp_count=sum(bp_counts),
            )
        else:
            # empty input: match the scalar batcher, which never emits a
            # batch and leaves the count structures empty
            summary.update(
                record_counts={},
                total_record_count=0,
                bp_counts={},
                total_bp_counts=(),
                sum_total_bp_count=0,
            )
        handler = self.stats if self.stats is not None else self.record_handler
        summary.update(handler.summarize())

    # -- side files (info/rest/wildcard) --------------------------------------

    def _emit_side_files(self, mates):
        """Write the configured side files (``--info-file``/``-r``/
        ``--wildcard-file``) for one batch: per-record rows assembled
        from the chunk buffer + stashed match data, byte-identical to
        the formatters of ``commands/trim/writers.py``. Per-record Python
        here is fine — side-file configs are inspection runs and the main
        trim path stays fully vectorized."""
        side = self.record_handler.formatters.info_formatters
        if not side:
            return
        views = [self._side_view(lane, tok) for lane, tok in mates]
        batch = mates[0][1].batch
        rows_of = {
            InfoFormatter: self._info_rows,
            RestFormatter: self._rest_rows,
            WildcardFormatter: self._wildcard_rows,
        }
        for formatter in side:
            builder = rows_of[type(formatter)]
            delim = formatter.delim
            lines = []
            for i in range(batch):
                for view in views:
                    for fields in builder(view, i):
                        lines.append(
                            delim.join(str(f) for f in fields) + "\n"
                        )
            if lines:
                self._writer.write(
                    self._open_output(formatter.path),
                    "".join(lines).encode("latin-1"),
                )

    @staticmethod
    def _side_view(lane, tok):
        """Per-record strings for side-file assembly: full header names
        plus the pre-adapter window's sequence/quality slices (the read
        state AT MATCH TIME, which MatchInfo snapshots)."""
        chunk, sub = tok.chunk, tok.sub
        batch = tok.batch
        buf = chunk.buf
        name_off = chunk.name_off[sub]
        name_len = chunk.name_len[sub]
        seq_off = chunk.seq_off[sub]
        qual_off = chunk.qual_off[sub]
        qual_len = chunk.qual_len[sub]
        ws = tok.win_start if tok.win_start is not None else tok.keep_start
        wp = tok.win_stop if tok.win_stop is not None else tok.keep_stop

        def text(off, start, stop):
            return bytes(buf[off + start : off + stop]).decode("latin-1")

        names = [
            text(name_off[i], 0, name_len[i]) for i in range(batch)
        ]
        seqs = [
            text(seq_off[i], ws[i], wp[i]) for i in range(batch)
        ]
        quals = [
            text(qual_off[i], ws[i], wp[i]) if qual_len[i] else ""
            for i in range(batch)
        ]
        return dict(
            names=names, seqs=seqs, quals=quals,
            md=tok.match_data, adapters=lane.adapters,
        )

    @staticmethod
    def _info_rows(view, i):
        md = view["md"]
        if md is not None and md["matched"][i]:
            seq = view["seqs"][i]
            qual = view["quals"][i]
            rstart = int(md["rstart"][i])
            rstop = int(md["rstop"][i])
            adapter = view["adapters"][int(md["best_idx"][i])]
            yield (
                view["names"][i], int(md["errors"][i]), rstart, rstop,
                seq[:rstart], seq[rstart:rstop], seq[rstop:],
                adapter.name,
                qual[:rstart], qual[rstart:rstop], qual[rstop:],
            )
        else:
            yield (view["names"][i], -1, view["seqs"][i], view["quals"][i])

    @staticmethod
    def _rest_rows(view, i):
        md = view["md"]
        if md is not None and md["matched"][i]:
            seq = view["seqs"][i]
            if md["front"][i]:
                rest = seq[: int(md["rstart"][i])]
            else:
                rest = seq[int(md["rstop"][i]) :]
            if rest:
                yield (rest, view["names"][i])

    @staticmethod
    def _wildcard_rows(view, i):
        md = view["md"]
        if md is not None and md["matched"][i]:
            seq = view["seqs"][i]
            adapter = view["adapters"][int(md["best_idx"][i])]
            astart = int(md["astart"][i])
            rstart = int(md["rstart"][i])
            length = int(md["astop"][i]) - astart
            wildcards = "".join(
                seq[rstart + j]
                for j in range(length)
                if adapter.sequence[astart + j] == "N"
                and rstart + j < len(seq)
            )
            yield (wildcards, view["names"][i])

    # -- --stats collection (pre/post ReadStatistics from matrices) -----------

    @staticmethod
    def _stats_obj(table, stats_class, kwargs):
        if 0 not in table:
            table[0] = stats_class(**kwargs)
        return table[0]

    @staticmethod
    def _stats_parts(obj, n_mates):
        return [obj] if n_mates == 1 else [obj.read1, obj.read2]

    def _collect_turbo_stats(self, mates, dest_masks):
        """Feed pre/post ReadStatistics straight from gathered matrices.

        ``mates``: one (lane, tok, final_start, final_stop) per mate.
        ``dest_masks``: [(filter type, row mask)] in routing order,
        including the kept rows under NoFilter — exactly the scalar
        wrapper's per-destination post tables.
        """
        stats = self.stats
        if stats.pre is not None:
            obj = self._stats_obj(
                stats.pre, stats.read_statistics_class, stats.pre_kwargs
            )
            for part, (lane, tok, _, _) in zip(
                self._stats_parts(obj, len(mates)), mates
            ):
                zero = np.zeros(tok.batch, np.int32)
                seqs = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.seq_off, zero, tok.width
                )
                quals = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.qual_off, zero, tok.width
                )
                part.collect_matrices(seqs, quals, tok.n)
        if stats.post is not None:
            gathered = []
            for lane, tok, start, stop in mates:
                seqs = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.seq_off, start, tok.width
                )
                quals = lane._gather(
                    tok.chunk, tok.sub, tok.chunk.qual_off, start, tok.width
                )
                gathered.append((seqs, quals, stop - start))
            for ftype, mask in dest_masks:
                if not mask.any():
                    continue
                table = stats.post.setdefault(ftype, {})
                obj = self._stats_obj(
                    table, stats.read_statistics_class, stats.post_kwargs
                )
                for part, (seqs, quals, lens) in zip(
                    self._stats_parts(obj, len(mates)), gathered
                ):
                    part.collect_matrices(
                        seqs[mask], quals[mask], lens[mask]
                    )


class TurboTrimRunner(_TurboRunnerBase):
    """Streaming interval-based trim for eligible single-end configs."""

    @classmethod
    def build(cls, command_runner, record_handler, writers, device=None):
        """Return a runner for a turbo-eligible configuration, None for
        every other."""
        options = command_runner.options
        if options.paired or options.interleaved_input:
            raise ValueError("paired input goes to TurboPairedRunner")
        unwrapped = cls._unwrap_handler(record_handler)
        if isinstance(unwrapped, str):
            return cls._decline(unwrapped)
        inner, stats = unwrapped
        reason = cls._check_common(command_runner, inner)
        if reason:
            return cls._decline(reason)
        input1 = options.input1
        if not input1 or not isinstance(input1, str):
            return cls._decline("non-path input")
        if options.input2:
            # a FASTA + quality file pair (-sq) is read per record
            return cls._decline("paired input")
        in_fmt = cls._stream_format(input1, options.format)
        if in_fmt is None:
            return cls._decline("unsupported input format")
        output = options.output
        if output and isinstance(output, str) and "{name}" in output:
            # demultiplexing: every {name} expansion must be a plain
            # stream path (routing happens per-adapter in the resolver)
            if cls._stream_format(output.replace("{name}", "x")) is None:
                return cls._decline("unsupported demultiplex template")
        out_fmts = cls._collect_output_formats(inner.formatters)
        if isinstance(out_fmts, str):
            return cls._decline(out_fmts)

        mods = [
            entry[0] if isinstance(entry, list) else entry
            for entry in inner.modifiers.modifiers
        ]
        lane = _MateLane.from_modifier_list(mods, device=device)
        if isinstance(lane, str):
            return cls._decline(lane)
        if in_fmt == "fasta":
            if lane._needs_quals:
                return cls._decline("quality stage without qualities")
            if stats is not None:
                return cls._decline("--stats on quality-less input")
        return cls(command_runner, inner, writers, lane, stats, in_fmt,
                   out_fmts)

    def __init__(self, command_runner, record_handler, writers, lane,
                 stats=None, in_fmt="fastq", out_fmts=None):
        self.command_runner = command_runner
        self.options = command_runner.options
        self.record_handler = record_handler
        self.writers = writers
        self.lane = lane
        self.stats = stats
        self._in_fmt = in_fmt
        self._out_fmts = dict(out_fmts or {})

    # -- main loop ------------------------------------------------------------

    def run(self):
        options = self.options
        logging.getLogger().info(
            "Running turbo device trim pipeline on %s", self.lane.device
        )
        began = time.perf_counter()
        out = self._open_output(options.output)

        total_records = 0
        total_bp = 0
        batches = 0
        inflight = collections.deque()
        # multi-process sharding: chunk boundaries are deterministic (same
        # file, same chunking), so round-robin chunk ownership partitions
        # the records exactly once across ranks
        shard_rank = getattr(self.command_runner, "shard_rank", 0)
        shard_count = getattr(self.command_runner, "shard_count", 1)
        chunk_index = 0
        owned = []  # (chunk index, records) of the chunks this rank trims
        # --max-reads caps the GLOBAL record stream (scalar batcher
        # semantics: the first N records of the input)
        quota = int_or_str(options.max_reads) or None
        seen = 0
        source = _ChunkStream(options.input1, self.CHUNK_BYTES, self._in_fmt)
        stream = _PrefetchStream(source, self.PREFETCH)
        self._writer = _AsyncWriter()
        self._resolve_seconds = 0.0
        chunk_wait = 0.0
        try:
            while True:
                waited = time.perf_counter()
                chunk = stream.next_chunk()
                chunk_wait += time.perf_counter() - waited
                if chunk is None:
                    break
                avail = chunk.n
                if quota is not None:
                    avail = min(avail, quota - seen)
                    if avail <= 0:
                        break
                seen += avail
                if chunk_index % shard_count == shard_rank:
                    owned.append((chunk_index, avail))
                    total_records += avail
                    total_bp += int(chunk.seq_len[:avail].sum())
                    for start in range(0, avail, self.MAX_BATCH):
                        sub = slice(start, min(start + self.MAX_BATCH, avail))
                        inflight.append(self.lane.submit(chunk, sub))
                        batches += 1
                        while len(inflight) >= self.DEPTH:
                            self._resolve(inflight.popleft())
                chunk_index += 1
        finally:
            stream.close()
        while inflight:
            self._resolve(inflight.popleft())
        self._writer.close()

        self._update_counts(total_records, (total_bp, 0))
        out.flush()
        self.writers.close()
        LAST_RUN.clear()
        LAST_RUN.update(
            device=str(self.lane.device),
            reads=total_records,
            owned=owned,
            batches=batches,
            device_batches=self.lane.device_batches,
            device_aligners=len(self.lane._aligners),
            wall_seconds=time.perf_counter() - began,
            parse_seconds=source.seconds,
            chunk_wait_seconds=chunk_wait,
            prepare_seconds=self.lane.prepare_seconds,
            dispatch_seconds=self.lane.dispatch_seconds,
            device_wait_seconds=self.lane.wait_seconds,
            resolve_seconds=self._resolve_seconds - self.lane.wait_seconds,
            format_seconds=self._writer.format_seconds,
            write_seconds=self._writer.write_seconds,
        )
        return 0

    # -- resolve: windows -> filters -> formatter -----------------------------

    def _resolve(self, tok):
        began = time.perf_counter()
        try:
            self._resolve_batch(tok)
        finally:
            self._resolve_seconds += time.perf_counter() - began

    def _resolve_batch(self, tok):
        keep_start, keep_stop, matched = self.lane.resolve_windows(tok)
        keep_start, keep_stop = self.lane.apply_post(
            tok, keep_start, keep_stop, matched
        )
        final_len = keep_stop - keep_start

        # filters, in registration order (first match wins)
        dest_none = np.ones(tok.batch, bool)
        dest_masks = []
        for ftype, wrapper in self.record_handler.filters.filters.items():
            hit = dest_none & self.lane.criterion_hits(
                ftype, wrapper, tok, keep_start, keep_stop, matched
            )
            wrapper.filtered += int(hit.sum())
            dest_none &= ~hit
            dest_masks.append((ftype, hit))

        keep = dest_none
        if self.stats is not None:
            self._collect_turbo_stats(
                [(self.lane, tok, keep_start, keep_stop)],
                dest_masks + [(NoFilter, keep)],
            )
        # per-destination routing: each dest with a formatter writes its
        # rows to that formatter's file (several dests may share a file —
        # the union mask preserves the scalar per-record byte order);
        # dests without a formatter are discarded
        formatters = self.record_handler.formatters
        path_masks = {}

        def route(formatter, mask, count):
            formatter.written += count
            formatter.read1_bp += int(final_len[mask].sum())
            if count:
                prev = path_masks.get(formatter.file1)
                path_masks[formatter.file1] = (
                    mask if prev is None else (prev | mask)
                )

        for ftype, mask in dest_masks + [(NoFilter, keep)]:
            if formatters.multiplexed and ftype is NoFilter:
                # demultiplex: kept matched reads route to the {name}
                # expansion of their adapter; unmatched fall through to
                # the NoFilter ('unknown') formatter below
                best_idx = tok.match_data["best_idx"]
                mux = mask & matched
                for adapter_idx, adapter in enumerate(self.lane.adapters):
                    sub_mask = mux & (best_idx == adapter_idx)
                    count = int(sub_mask.sum())
                    if count:
                        route(
                            formatters.get_mux_formatter(adapter.name),
                            sub_mask, count,
                        )
                mask = mask & ~matched
            formatter = formatters.seq_formatters.get(ftype)
            count = int(mask.sum())
            if formatter is None:
                formatters.discarded += count
                continue
            route(formatter, mask, count)
        for path, mask in path_masks.items():
            self._writer.write(
                self._open_output(path),
                partial(
                    _format_records,
                    tok.chunk, tok.sub, keep_start, keep_stop, mask,
                    fmt=self._fmt_of(path),
                ),
            )
        self._emit_side_files([(self.lane, tok)])


class TurboPairedRunner(_TurboRunnerBase):
    """Streaming interval-based trim for eligible paired-end configs:
    two :class:`_MateLane`s fed by two synchronized chunk streams (or one
    interleaved stream), vectorized pair filters, two outputs or one
    interleaved output.

    Covers BOTH aligners: independent per-mate adapter matching (each
    lane its own device step), and insert-align (``--aligner insert``)
    via :class:`_InsertPair` (one fused device step per pair batch).
    """

    @classmethod
    def build(cls, command_runner, record_handler, writers, device=None):
        """Return a runner for a turbo-eligible paired configuration,
        None for every other."""
        options = command_runner.options
        if not options.paired:
            raise ValueError("single-end input goes to TurboTrimRunner")
        unwrapped = cls._unwrap_handler(record_handler)
        if isinstance(unwrapped, str):
            return cls._decline(unwrapped)
        record_handler, stats = unwrapped
        reason = cls._check_common(command_runner, record_handler)
        if reason:
            return cls._decline(reason)
        if options.interleaved_input:
            if not isinstance(options.interleaved_input, str):
                return cls._decline("non-path interleaved input")
            in_fmt1 = in_fmt2 = cls._stream_format(
                options.interleaved_input, options.format
            )
            if in_fmt1 is None:
                return cls._decline("unsupported interleaved input format")
        else:
            input1, input2 = options.input1, options.input2
            if (
                not input1 or not input2
                or not isinstance(input1, str) or not isinstance(input2, str)
            ):
                return cls._decline("non-path paired input")
            in_fmt1 = cls._stream_format(input1, options.format)
            in_fmt2 = cls._stream_format(input2, options.format)
            if in_fmt1 is None or in_fmt2 is None:
                return cls._decline("unsupported paired input format")
        out_fmts = cls._collect_output_formats(
            record_handler.formatters, allow_interleaved=True
        )
        if isinstance(out_fmts, str):
            return cls._decline(out_fmts)

        mods1, mods2 = [], []
        insert_cutter = None
        overwrite = None
        for pos, entry in enumerate(record_handler.modifiers.modifiers):
            if isinstance(entry, InsertAdapterCutter):
                if insert_cutter is not None:
                    return cls._decline("multiple insert cutters")
                insert_cutter = entry
                continue
            if isinstance(entry, OverwriteRead):
                # -w: whole-read replacement by the partner's reverse
                # complement. Two supported chain positions: FIRST
                # (op-order 'WCGQA' — a vectorized pre-pass patches the
                # lanes' inputs) and LAST (the default 'CGQAW' — a
                # resolve-time swap on the trimmed windows).
                if overwrite is not None:
                    return cls._decline("multiple overwrite stages")
                overwrite = entry
                overwrite_pos = pos
                continue
            if isinstance(entry, ReadPairModifier):
                return cls._decline("pair modifier %s" % type(entry).__name__)
            if entry[0] is not None:
                mods1.append(entry[0])
            if entry[1] is not None:
                mods2.append(entry[1])
        overwrite_mode = None
        if overwrite is not None:
            n_entries = len(record_handler.modifiers.modifiers)
            if overwrite_pos == 0:
                overwrite_mode = "pre"
            elif overwrite_pos == n_entries - 1:
                overwrite_mode = "post"
            else:
                return cls._decline("overwrite mid-chain")
            if insert_cutter is not None:
                return cls._decline("overwrite with insert aligner")
            if stats is not None:
                return cls._decline("--stats with overwrite")
            if record_handler.formatters.info_formatters:
                return cls._decline("side files with overwrite")
            if "fasta" in (in_fmt1, in_fmt2):
                return cls._decline("overwrite without qualities")
        insert_pair = None
        if insert_cutter is not None:
            lane1 = _MateLane.from_modifier_list(
                mods1, insert_adapter=insert_cutter.adapter1, insert_role=1,
                device=device,
            )
            if isinstance(lane1, str):
                return cls._decline(lane1)
            lane2 = _MateLane.from_modifier_list(
                mods2, insert_adapter=insert_cutter.adapter2, insert_role=2,
                device=device,
            )
            if isinstance(lane2, str):
                return cls._decline(lane2)
            insert_pair = _InsertPair(lane1, lane2, insert_cutter)
        else:
            lane1 = _MateLane.from_modifier_list(mods1, device=device)
            if isinstance(lane1, str):
                return cls._decline(lane1)
            lane2 = _MateLane.from_modifier_list(mods2, device=device)
            if isinstance(lane2, str):
                return cls._decline(lane2)
        if "fasta" in (in_fmt1, in_fmt2):
            if lane1._needs_quals or lane2._needs_quals:
                return cls._decline("quality stage without qualities")
            if stats is not None:
                return cls._decline("--stats on quality-less input")
        if insert_pair is not None and insert_cutter.mismatch_action:
            # correction rewrites record bytes: paths that snapshot them
            # from the chunk buffer cannot be served from intervals
            if "fasta" in (in_fmt1, in_fmt2):
                return cls._decline("insert correction without qualities")
            if stats is not None:
                return cls._decline("--stats with insert correction")
            if record_handler.formatters.info_formatters:
                return cls._decline("side files with insert correction")
        return cls(
            command_runner, record_handler, writers, lane1, lane2, stats,
            insert_pair, (in_fmt1, in_fmt2), out_fmts, overwrite,
            overwrite_mode,
        )

    def __init__(self, command_runner, record_handler, writers, lane1, lane2,
                 stats=None, insert_pair=None, in_fmts=("fastq", "fastq"),
                 out_fmts=None, overwrite=None, overwrite_mode=None):
        self.command_runner = command_runner
        self.options = command_runner.options
        self.record_handler = record_handler
        self.writers = writers
        self.lane1 = lane1
        self.lane2 = lane2
        self.stats = stats
        self.insert_pair = insert_pair
        self.overwrite = overwrite
        self._ow_mode = overwrite_mode
        self._in_fmts = in_fmts
        self._out_fmts = dict(out_fmts or {})

    # -- main loop ------------------------------------------------------------

    def run(self):
        options = self.options
        logging.getLogger().info(
            "Running turbo paired device trim pipeline on %s", self.lane1.device
        )
        began = time.perf_counter()
        if options.interleaved_output:
            self._open_output(options.interleaved_output)
        else:
            self._open_output(options.output)
            self._open_output(options.paired_output)

        self._total_pairs = 0
        self._bp = [0, 0]
        self._batches = 0
        self._inflight = collections.deque()
        self._shard_rank = getattr(self.command_runner, "shard_rank", 0)
        self._shard_count = getattr(self.command_runner, "shard_count", 1)
        self._batch_index = 0
        self._owned = []  # (batch index, pairs) of the batches this rank trims
        self._writer = _AsyncWriter()
        self._resolve_seconds = 0.0
        self._chunk_wait = 0.0
        self._streams = []
        self._overwritten = 0
        overflows = SLOT_OVERFLOWS["pairs"]
        quota = int_or_str(options.max_reads) or None
        if options.interleaved_input:
            self._pump_interleaved(quota)
        else:
            self._pump_two_files(quota)
        while self._inflight:
            self._resolve_item(self._inflight.popleft())
        self._writer.close()

        self._update_counts(self._total_pairs, tuple(self._bp))
        self.writers.close()
        lanes = (self.lane1, self.lane2)
        insert = self.insert_pair
        if insert is not None:
            prepare = insert.prepare_seconds
            dispatch = insert.dispatch_seconds
            wait = insert.wait_seconds
            device_batches = insert.device_batches
        else:
            prepare = sum(lane.prepare_seconds for lane in lanes)
            dispatch = sum(lane.dispatch_seconds for lane in lanes)
            wait = sum(lane.wait_seconds for lane in lanes)
            device_batches = sum(lane.device_batches for lane in lanes)
        LAST_RUN.clear()
        LAST_RUN.update(
            device=str(self.lane1.device),
            pairs=self._total_pairs,
            owned=self._owned,
            batches=self._batches,
            aligner="insert" if insert is not None else "adapter",
            device_batches=device_batches,
            device_aligners=sum(len(lane._aligners) for lane in lanes),
            slot_overflow_pairs=SLOT_OVERFLOWS["pairs"] - overflows,
            overwritten_pairs=self._overwritten,
            wall_seconds=time.perf_counter() - began,
            parse_seconds=sum(stream.seconds for stream in self._streams),
            chunk_wait_seconds=self._chunk_wait,
            prepare_seconds=prepare,
            dispatch_seconds=dispatch,
            device_wait_seconds=wait,
            resolve_seconds=self._resolve_seconds - wait,
            format_seconds=self._writer.format_seconds,
            write_seconds=self._writer.write_seconds,
        )
        return 0

    def _open_stream(self, path, fmt):
        source = _ChunkStream(path, self.CHUNK_BYTES, fmt)
        self._streams.append(source)
        return _PrefetchStream(source, self.PREFETCH)

    def _next_chunk(self, stream):
        waited = time.perf_counter()
        chunk = stream.next_chunk()
        self._chunk_wait += time.perf_counter() - waited
        return chunk

    def _submit_pair(self, chunk1, sub1, chunk2, sub2):
        """Submit one pair batch if this rank owns it; drain the pipeline
        window."""
        owned = self._batch_index % self._shard_count == self._shard_rank
        self._batch_index += 1
        if not owned:
            return
        lens1 = chunk1.seq_len[sub1]
        self._owned.append((self._batch_index - 1, lens1.shape[0]))
        self._total_pairs += lens1.shape[0]
        self._bp[0] += int(lens1.sum())
        self._bp[1] += int(chunk2.seq_len[sub2].sum())
        self._batches += 1
        if self.insert_pair is not None:
            self._inflight.append(
                self.insert_pair.submit(chunk1, sub1, chunk2, sub2)
            )
        else:
            ov1 = ov2 = None
            if self.overwrite is not None and self._ow_mode == "pre":
                ov1, ov2 = self._compute_overwrite(
                    chunk1, sub1, chunk2, sub2
                )
            tok1 = self.lane1.submit(chunk1, sub1, overrides=ov1)
            tok2 = self.lane2.submit(chunk2, sub2, overrides=ov2)
            tok1.ow = ov1
            tok2.ow = ov2
            self._inflight.append((tok1, tok2))
        while len(self._inflight) >= self.DEPTH:
            self._resolve_item(self._inflight.popleft())

    def _pump_two_files(self, quota):
        options = self.options
        s1 = self._open_stream(options.input1, self._in_fmts[0])
        s2 = self._open_stream(options.input2, self._in_fmts[1])
        seen_pairs = 0
        cur1 = cur2 = None
        pos1 = pos2 = 0
        try:
            while True:
                if quota is not None and seen_pairs >= quota:
                    break
                if cur1 is None or pos1 == cur1.n:
                    cur1 = self._next_chunk(s1)
                    pos1 = 0
                if cur2 is None or pos2 == cur2.n:
                    cur2 = self._next_chunk(s2)
                    pos2 = 0
                if cur1 is None or cur2 is None:
                    if (cur1 is None) != (cur2 is None):
                        more, less = (2, 1) if cur1 is None else (1, 2)
                        raise FormatError(
                            "Reads are improperly paired. There are more "
                            "reads in file {0} than in file {1}.".format(
                                more, less
                            )
                        )
                    break
                take = min(cur1.n - pos1, cur2.n - pos2, self.MAX_BATCH)
                if quota is not None:
                    take = min(take, quota - seen_pairs)
                seen_pairs += take
                sub1 = slice(pos1, pos1 + take)
                sub2 = slice(pos2, pos2 + take)
                pos1 += take
                pos2 += take
                self._submit_pair(cur1, sub1, cur2, sub2)
        finally:
            s1.close()
            s2.close()

    def _pump_interleaved(self, quota):
        """Single-stream pairing: even records are mate 1, odd mate 2
        (strided subs within a chunk; a chunk-boundary odd tail pairs as
        a one-pair batch with the next chunk's first record)."""
        stream = self._open_stream(
            self.options.interleaved_input, self._in_fmts[0]
        )
        seen_pairs = 0
        leftover = None  # (chunk, record index) awaiting its partner
        try:
            while True:
                if quota is not None and seen_pairs >= quota:
                    return
                chunk = self._next_chunk(stream)
                if chunk is None:
                    break
                pos = 0
                if leftover is not None:
                    prev_chunk, prev_idx = leftover
                    leftover = None
                    self._submit_pair(prev_chunk, [prev_idx], chunk, [0])
                    seen_pairs += 1
                    pos = 1
                while chunk.n - pos >= 2:
                    if quota is not None and seen_pairs >= quota:
                        return
                    take = (chunk.n - pos) // 2
                    take = min(take, self.MAX_BATCH)
                    if quota is not None:
                        take = min(take, quota - seen_pairs)
                    sub1 = slice(pos, pos + 2 * take, 2)
                    sub2 = slice(pos + 1, pos + 1 + 2 * take, 2)
                    self._submit_pair(chunk, sub1, chunk, sub2)
                    seen_pairs += take
                    pos += 2 * take
                if chunk.n - pos == 1:
                    leftover = (chunk, pos)
            if leftover is not None:
                raise FormatError(
                    "Interleaved input file incomplete: Last record has no "
                    "partner."
                )
        finally:
            stream.close()

    # -- -w: mate overwrite --------------------------------------------------

    def _window_mean(self, chunk, sub, keep_start=None):
        """Mean quality of each read's first ``window_size`` bases from
        ``keep_start`` on (the read's start when None)."""
        ow = self.overwrite
        win = ow.window_size
        offs = chunk.qual_off[sub].astype(np.int64)
        lens = chunk.qual_len[sub].astype(np.int32)
        if keep_start is not None:
            offs = offs + keep_start.astype(np.int64)
            lens = lens - keep_start.astype(np.int32)
        offs = np.ascontiguousarray(offs, np.int64)
        lens = np.ascontiguousarray(lens, np.int32)
        out = np.zeros((offs.shape[0], win), np.uint8)
        runtime.lib().gather_padded(
            _u8(chunk.buf), _i64(offs), _i32(lens), offs.shape[0], win, _u8(out),
        )
        return (out.astype(np.int64).sum(axis=1) - win * ow.base) / win

    def _overwrite_masks(self, eligible, score1, score2):
        """(ow1, ow2): the pairs whose mate 1 (mate 2) is replaced."""
        ow = self.overwrite
        worse, better = ow.worse_read_min_quality, ow.better_read_min_quality
        ow1 = eligible & (score1 < worse) & (score2 >= better)
        ow2 = eligible & ~ow1 & (score2 < worse) & (score1 >= better)
        return ow1, ow2

    def _compute_overwrite(self, chunk1, sub1, chunk2, sub2):
        """Vectorized OverwriteRead (``-w``) pre-pass (reference
        ``modifiers.py:511-563``): per pair, the mean quality of the
        first W bases decides whether one mate is replaced by the
        reverse complement of the other. Returns per-mate lane overrides
        (None = no replacements on that side)."""
        win = self.overwrite.window_size
        len1 = chunk1.seq_len[sub1].astype(np.int64)
        len2 = chunk2.seq_len[sub2].astype(np.int64)
        eligible = (len1 >= win) & (len2 >= win)
        if not eligible.any():
            return None, None
        ow1, ow2 = self._overwrite_masks(
            eligible,
            self._window_mean(chunk1, sub1),
            self._window_mean(chunk2, sub2),
        )

        def overrides(mask, src_chunk, src_sub, src_len):
            rows = np.nonzero(mask)[0]
            if rows.size == 0:
                return None
            abs_idx = np.arange(src_chunk.n)[src_sub][rows]
            lens = src_len[rows].astype(np.int32)
            wmax = max(1, int(lens.max()))
            offs_s = np.ascontiguousarray(src_chunk.seq_off[abs_idx], np.int64)
            offs_q = np.ascontiguousarray(src_chunk.qual_off[abs_idx], np.int64)
            lens_c = np.ascontiguousarray(lens, np.int32)
            seq = np.zeros((rows.size, wmax), np.uint8)
            qual = np.zeros((rows.size, wmax), np.uint8)
            runtime.lib().gather_padded(
                _u8(src_chunk.buf), _i64(offs_s), _i32(lens_c),
                rows.size, wmax, _u8(seq),
            )
            runtime.lib().gather_padded(
                _u8(src_chunk.buf), _i64(offs_q), _i32(lens_c),
                rows.size, wmax, _u8(qual),
            )
            comp = _complement_lut()[seq]
            for i in range(rows.size):
                length = int(lens[i])
                seq[i, :length] = comp[i, :length][::-1]
                qual[i, :length] = qual[i, :length][::-1].copy()
            return dict(
                rows=rows, n=lens, seq=seq, qual=qual,
                src_chunk=src_chunk, abs_idx=abs_idx,
            )

        return (
            overrides(ow1, chunk2, sub2, len2),
            overrides(ow2, chunk1, sub1, len1),
        )

    @staticmethod
    def _alt_arrays(batch, rows, src_chunk, abs_idx, seg):
        """An empty alt layout for ``rows`` of a batch: the buffer sized
        for each row's ``seg`` bases of sequence and quality plus the
        source record's name and plus lines, and per-row offsets (-1 for
        rows that keep their own record)."""
        nlens = src_chunk.name_len[abs_idx].astype(np.int64)
        plens = src_chunk.plus_len[abs_idx].astype(np.int64)
        buf = np.empty(int(2 * seg.sum() + nlens.sum() + plens.sum()), np.uint8)
        offsets = [np.full(batch, -1, np.int64) for _ in range(5)]
        lengths = [np.zeros(batch, np.int32) for _ in range(2)]
        return buf, offsets, lengths, nlens, plens

    @classmethod
    def _fill_alt(cls, tok, rows, src_chunk, abs_idx, segments):
        """Set ``tok.alt``: for row ``rows[i]`` the sequence and quality
        bytes ``segments[i]`` = (seq, qual) and the name and plus line of
        source record ``abs_idx[i]`` of ``src_chunk``."""
        seg = np.array([len(seq) for seq, _ in segments], np.int64)
        buf, (sb, se, qb, nb, pb), (nl, pl), nlens, plens = cls._alt_arrays(
            tok.batch, rows, src_chunk, abs_idx, seg
        )
        w = 0
        for i, row in enumerate(rows):
            seq, qual = segments[i]
            length = len(seq)
            sb[row] = w
            se[row] = w + length
            buf[w : w + length] = seq
            w += length
            qb[row] = w
            buf[w : w + length] = qual
            w += length
            n_len, n_off = int(nlens[i]), int(src_chunk.name_off[abs_idx[i]])
            nb[row] = w
            nl[row] = n_len
            buf[w : w + n_len] = src_chunk.buf[n_off : n_off + n_len]
            w += n_len
            p_len, p_off = int(plens[i]), int(src_chunk.plus_off[abs_idx[i]])
            pb[row] = w
            pl[row] = p_len
            buf[w : w + p_len] = src_chunk.buf[p_off : p_off + p_len]
            w += p_len
        tok.alt = (buf, sb, se, qb, nb, nl, pb, pl)

    def _build_overwrite_alt(self, tok, keep_start, keep_stop):
        """Output patch data for the records the pre-pass overwrote: the
        final (post-trim) replacement seq/qual windows plus the partner's
        name/plus header bytes."""
        ov = tok.ow
        if ov is None:
            return
        segments = []
        for i, row in enumerate(ov["rows"]):
            a = int(keep_start[row])
            length = max(0, int(keep_stop[row]) - a)
            segments.append(
                (ov["seq"][i, a : a + length], ov["qual"][i, a : a + length])
            )
        self._fill_alt(tok, ov["rows"], ov["src_chunk"], ov["abs_idx"], segments)

    def _overwrite_post(self, tok1, tok2, ks1, kp1, ks2, kp2):
        """W-last OverwriteRead (default 'CGQAW' op order): the quality
        window is measured on the TRIMMED reads, and the replacement is
        the reverse complement of the partner's trimmed window. Sets the
        affected rows' alt output data on each token and returns the
        (ow1, ow2) replacement masks, or None when no pair triggers."""
        win = self.overwrite.window_size
        eligible = ((kp1 - ks1) >= win) & ((kp2 - ks2) >= win)
        if not eligible.any():
            return None
        ow1, ow2 = self._overwrite_masks(
            eligible,
            self._window_mean(tok1.chunk, tok1.sub, ks1),
            self._window_mean(tok2.chunk, tok2.sub, ks2),
        )
        if not (ow1.any() or ow2.any()):
            return None
        comp = _complement_lut()

        def build_alt(tok_dst, mask, tok_src, ks_src, kp_src):
            rows = np.nonzero(mask)[0]
            if rows.size == 0:
                return
            chunk = tok_src.chunk
            abs_idx = np.arange(chunk.n)[tok_src.sub][rows]
            segments = []
            for i, row in enumerate(rows):
                a, b = int(ks_src[row]), int(kp_src[row])
                b = max(a, b)
                s_off = int(chunk.seq_off[abs_idx[i]])
                q_off = int(chunk.qual_off[abs_idx[i]])
                segments.append((
                    comp[chunk.buf[s_off + a : s_off + b][::-1]],
                    chunk.buf[q_off + a : q_off + b][::-1],
                ))
            self._fill_alt(tok_dst, rows, chunk, abs_idx, segments)

        build_alt(tok1, ow1, tok2, ks2, kp2)
        build_alt(tok2, ow2, tok1, ks1, kp1)
        return ow1, ow2

    # -- resolve: windows -> pair filters -> formatters ------------------------

    def _resolve_item(self, item):
        """Resolve one in-flight batch: either an insert-pair token or a
        (tok1, tok2) per-mate pair."""
        began = time.perf_counter()
        try:
            if self.insert_pair is not None:
                tok1, tok2 = item.tok1, item.tok2
                self._check_pair_names(tok1, tok2)
                ks1, kp1, matched1, ks2, kp2, matched2 = (
                    self.insert_pair.resolve(item)
                )
            else:
                tok1, tok2 = item
                self._check_pair_names(tok1, tok2)
                ks1, kp1, matched1 = self.lane1.resolve_windows(tok1)
                ks2, kp2, matched2 = self.lane2.resolve_windows(tok2)
            ks1, kp1 = self.lane1.apply_post(tok1, ks1, kp1, matched1)
            ks2, kp2 = self.lane2.apply_post(tok2, ks2, kp2, matched2)
            ow_masks = None
            if self.overwrite is not None:
                if self._ow_mode == "pre":
                    for tok, ks, kp in ((tok1, ks1, kp1), (tok2, ks2, kp2)):
                        self._build_overwrite_alt(tok, ks, kp)
                        if tok.ow is not None:
                            self._overwritten += len(tok.ow["rows"])
                else:
                    ow_masks = self._overwrite_post(
                        tok1, tok2, ks1, kp1, ks2, kp2
                    )
                    if ow_masks is not None:
                        ow1, ow2 = ow_masks
                        self._overwritten += int((ow1 | ow2).sum())
                        # the replaced read carries a COPY of its partner's
                        # match (Sequence.reverse_complement provenance)
                        m1, m2 = matched1, matched2
                        matched1 = np.where(ow1, m2, m1)
                        matched2 = np.where(ow2, m1, m2)
            self._finish_pair(
                tok1, tok2, ks1, kp1, matched1, ks2, kp2, matched2,
                ow=ow_masks,
            )
        finally:
            self._resolve_seconds += time.perf_counter() - began

    def _check_pair_names(self, tok1, tok2):
        validate_pair_names(
            tok1.chunk, tok1.sub, tok2.chunk, tok2.sub,
            interleaved=bool(self.options.interleaved_input),
        )

    def _finish_pair(self, tok1, tok2, ks1, kp1, matched1, ks2, kp2,
                     matched2, ow=None):
        len1 = kp1 - ks1
        len2 = kp2 - ks2
        if ow is not None:
            # W-last overwrite: a replaced mate's filter-visible state
            # (length, N content) is its partner's trimmed window — the
            # reverse complement preserves both
            ow1, ow2 = ow
            raw1, raw2 = len1, len2
            len1 = np.where(ow1, raw2, raw1)
            len2 = np.where(ow2, raw1, raw2)

        # pair filters in registration order (first match wins). The
        # PairedWrapper combines per-mate criteria with min_affected
        # (1 = any, 2 = both); legacy 'first' mode wraps SingleWrapper,
        # which only inspects read1.
        dest_none = np.ones(tok1.batch, bool)
        dest_masks = []
        for ftype, wrapper in self.record_handler.filters.filters.items():
            c1 = self.lane1.criterion_hits(
                ftype, wrapper, tok1, ks1, kp1, matched1
            )
            if ow is not None and ow1.any():
                c1 = np.where(
                    ow1,
                    self.lane2.criterion_hits(
                        ftype, wrapper, tok2, ks2, kp2, matched1
                    ),
                    c1,
                )
            if isinstance(wrapper, PairedWrapper):
                c2 = self.lane2.criterion_hits(
                    ftype, wrapper, tok2, ks2, kp2, matched2
                )
                if ow is not None and ow2.any():
                    c2 = np.where(
                        ow2,
                        self.lane1.criterion_hits(
                            ftype, wrapper, tok1, ks1, kp1, matched2
                        ),
                        c2,
                    )
                hit = (c1 | c2) if wrapper.min_affected == 1 else (c1 & c2)
            else:
                hit = c1
            hit = dest_none & hit
            wrapper.filtered += int(hit.sum())
            dest_none &= ~hit
            dest_masks.append((ftype, hit))

        keep = dest_none
        if self.stats is not None:
            self._collect_turbo_stats(
                [
                    (self.lane1, tok1, ks1, kp1),
                    (self.lane2, tok2, ks2, kp2),
                ],
                dest_masks + [(NoFilter, keep)],
            )
        # per-destination routing (see the SE runner): dests with a
        # SingleEndFormatter write mate 1 only — the scalar semantics when
        # a side output was given without its paired counterpart
        formatters = self.record_handler.formatters
        masks1 = {}
        masks2 = {}
        masks_il = {}
        for ftype, mask in dest_masks + [(NoFilter, keep)]:
            formatter = formatters.seq_formatters.get(ftype)
            count = int(mask.sum())
            if formatter is None:
                formatters.discarded += count
                continue
            formatter.written += count
            formatter.read1_bp += int(len1[mask].sum())
            interleaved = isinstance(formatter, InterleavedFormatter)
            file2 = getattr(formatter, "file2", None)
            if file2 is not None or interleaved:
                formatter.read2_bp += int(len2[mask].sum())
            if count:
                table = masks_il if interleaved else masks1
                prev = table.get(formatter.file1)
                table[formatter.file1] = mask if prev is None else (prev | mask)
                if file2 is not None:
                    prev2 = masks2.get(file2)
                    masks2[file2] = mask if prev2 is None else (prev2 | mask)

        for tok, ks, kp, masks in (
            (tok1, ks1, kp1, masks1), (tok2, ks2, kp2, masks2),
        ):
            for path, mask in masks.items():
                self._writer.write(
                    self._open_output(path),
                    partial(
                        _format_records,
                        tok.chunk, tok.sub, ks, kp, mask,
                        fmt=self._fmt_of(path), alt=tok.alt,
                    ),
                )

        def interleave(fmt, mask):
            return _interleave_records(*(
                (
                    _format_records(
                        tok.chunk, tok.sub, ks, kp, mask, fmt, alt=tok.alt
                    ),
                    _record_byte_lengths(
                        tok.chunk, tok.sub, ks, kp, mask, fmt, alt=tok.alt
                    ),
                )
                for tok, ks, kp in ((tok1, ks1, kp1), (tok2, ks2, kp2))
            ))

        for path, mask in masks_il.items():
            self._writer.write(
                self._open_output(path),
                partial(interleave, self._fmt_of(path), mask),
            )
        self._emit_side_files([(self.lane1, tok1), (self.lane2, tok2)])
