"""Turbo trim path: zero-Python-object, latency-hiding streaming trim.

Counterpart of ``atropos_tpu/engine/turbo.py`` for single-end input. For
interval-expressible configurations (fixed cuts + quality/NextSeq trimming
+ adapter trimming + conditional cuts/N-trimming + length/N filters,
action=trim) the entire per-read pipeline is *interval arithmetic*: each
stage only narrows a per-read keep-window [start, stop). The runner
streams FASTQ/FASTA chunks through the native C parser
(:mod:`atropos_tpu_torch.runtime`), runs one device step per batch,
resolves the final windows, and assembles output bytes with the native
formatters — no per-read Python objects anywhere.

Layout:

- :class:`_MateLane` — the read's stage configuration and device work
  (prepare/submit a batch, resolve its keep-windows + statistics, apply
  post-adapter stages).
- :class:`TurboTrimRunner` — the single-end runner: one lane, filters,
  per-destination routing.

The device interaction is pipelined (``DEPTH`` batches in flight):

- **submit**: one bit-packed upload per batch (2-4 bits/base), written by
  the native packer straight into a pinned host buffer and copied
  ``non_blocking`` on a side stream; on the compute stream the step
  unpacks the codes, decodes each adapter's view with a table gather into
  the ``[L, B]`` column-major layout, runs one DP kernel launch per
  adapter (:mod:`atropos_tpu_torch.align.cuda_kernel`), packs the results
  into an int16 ``bundle`` and copies it into a pinned buffer, followed by
  an event.
- **resolve**: wait for that batch's event only, then all interval
  resolution, validation, statistics (vectorized bincounts) and the
  native formatter run on host while later batches compute on the card.

Quality and NextSeq trimming run on the host-native path (the windows are
computed from the chunk buffer before the upload). Everything the turbo
runner of ``atropos_tpu`` declines, and paired input, the sharded mesh,
the device quality kernels, side files, ``--stats`` and demultiplexing,
raise :class:`~atropos_tpu_torch.NotPortedError`.

Output is byte-identical to ``atropos_tpu``; all summary statistics
(per-adapter histograms, trimmed-bp counters, filter counts) are
accumulated into the same stat objects, so reports are unchanged.
"""
import collections
import logging
import time
from functools import partial

import numpy as np
import torch

from atropos_tpu_torch import NotPortedError, resolve_device, runtime
from atropos_tpu_torch.adapters import (
    ANYWHERE,
    FRONT,
    PREFIX,
    SUFFIX,
    Adapter,
)
from atropos_tpu_torch.align.batched import _translation_lut
from atropos_tpu_torch.commands.trim.filters import (
    NContentFilter,
    NoFilter,
    TooLongReadFilter,
    TooShortReadFilter,
    TrimmedFilter,
    UntrimmedFilter,
)
from atropos_tpu_torch.commands.trim.modifiers import (
    AdapterCutter,
    MinCutter,
    NEndTrimmer,
    NextseqQualityTrimmer,
    QualityTrimmer,
    UnconditionalCutter,
)
from atropos_tpu_torch.engine import _PrefixSuffixMatcher, make_batch_aligner
from atropos_tpu_torch.io import xopen
from atropos_tpu_torch.io.compression import get_file_opener
from atropos_tpu_torch.io.seqio import (
    FastaFormat,
    FastqFormat,
    FormatError,
    guess_format_from_name,
)
from atropos_tpu_torch.runtime import _i32, _i64, _u8
from atropos_tpu_torch.commands.cli import int_or_str
from atropos_tpu_torch.util import truncate_string

_UPPER_LUT = None

#: telemetry of the last :meth:`TurboTrimRunner.run`: reads, batches, wall
#: seconds and where the main thread and its helper threads spent them
LAST_RUN = {}


def _upper(arr):
    global _UPPER_LUT
    if _UPPER_LUT is None:
        lut = np.arange(256, dtype=np.uint8)
        lut[ord("a") : ord("z") + 1] = np.arange(
            ord("A"), ord("Z") + 1, dtype=np.uint8
        )
        _UPPER_LUT = lut
    return _UPPER_LUT[arr]


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
        "match_data", "win_start", "win_stop", "qclip",
    )

    def __init__(self, **kw):
        self.bundle = None
        self.event = None
        self.slot = None
        self.match_data = None
        self.win_start = None
        self.win_stop = None
        self.qclip = None
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


LaneTables = collections.namedtuple("LaneTables", "view_luts aligner_view")


def lane_tables_from_numpy(view_luts, aligner_view):
    """A lane's decode state from numpy arrays: ``view_luts`` is a
    sequence of 256-entry uint8 byte -> view-byte tables (uppercasing and
    the per-adapter wildcard translation collapsed into one lookup), and
    ``aligner_view[i]`` the index of the table device aligner ``i`` reads
    through. :meth:`_MateLane.load_tables` installs the result, so two
    implementations can decode from the very same tables."""
    luts = np.ascontiguousarray(
        np.stack([np.asarray(lut) for lut in view_luts]).astype(np.uint8)
    )
    if luts.ndim != 2 or luts.shape[1] != 256:
        raise ValueError("view_luts must be [n_views, 256]")
    views = tuple(int(v) for v in aligner_view)
    if any(v < 0 or v >= luts.shape[0] for v in views):
        raise ValueError("aligner_view indexes a missing view")
    return LaneTables(luts, views)


class _MateLane:
    """One read's stage configuration and device work.

    ``submit`` turns a (chunk, sub) record range into an in-flight device
    batch; ``resolve_windows`` waits for the batch's bundle and produces
    the final per-read keep-windows plus matched flags, accumulating every
    modifier statistic exactly as the scalar pipeline would.
    """

    def __init__(self, *, cut_front, cut_back, quality, nextseq, cutter,
                 cutter_mod, post_mods=(), device=None):
        self.device = resolve_device(device)
        self.cut_front = cut_front
        self.cut_back = cut_back
        self.quality = quality
        self.nextseq = nextseq
        self.cutter = cutter
        self.cutter_mod = cutter_mod
        self.post_mods = list(post_mods)
        self.adapters = cutter.adapters if cutter else []

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

        upper_lut = _upper(np.arange(256, dtype=np.uint8))
        aligner_view = [
            add_view(upper_lut if lut is None else lut[upper_lut])
            for lut in luts
        ]
        if not view_luts:
            view_luts.append(upper_lut)
        self.load_tables(lane_tables_from_numpy(view_luts, aligner_view))

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
        self._view_luts = [lut for lut in tables.view_luts]
        self._aligner_view = list(tables.aligner_view)
        self._view_luts_dev = torch.from_numpy(tables.view_luts.copy()).to(
            self.device
        )

    @classmethod
    def from_modifier_list(cls, mods, device=None):
        """Build a lane from the read's ordered modifier list, or a
        decline-reason string when a stage is unsupported or out of the
        default C -> G -> Q -> A order."""
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
        return cls(
            cut_front=cut_front,
            cut_back=cut_back,
            quality=quality,
            nextseq=nextseq,
            cutter=cutter,
            cutter_mod=cutter_mod,
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

    def _core(self, width, bits, main, win16, tables):
        """Per-batch device compute: unpack the 2/4-bit codes of ``main``
        ([B, width * bits / 8] uint8; raw bytes when ``bits`` is 0),
        decode each aligner's view with a gather from ``tables``
        ([n_views, n_codes] uint8) into the [L, B] column-major layout
        (neighbouring threads of the DP kernel then read neighbouring
        bytes), and run one DP per adapter. Returns the per-aligner result
        rows and the int32 window lengths."""
        if bits == 2:
            parts = [(main >> shift) & 3 for shift in (0, 2, 4, 6)]
            codes = torch.stack(parts, dim=-1).reshape(main.shape[0], width)
        elif bits == 4:
            codes = torch.stack([main & 15, main >> 4], dim=-1).reshape(
                main.shape[0], width
            )
        else:
            codes = main
        codes_T = codes.T.long()  # [L, B] gather indices
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
        return rows, win_len

    def _step(self, width, bits, main, win16, tables):
        """The single-read device step for one batch: :meth:`_core`, one
        int16 bundle out.

        Bundle rows per device aligner: 3 packed rows or the flat 7
        (found, start1, stop1, start2, stop2, matches, cost), by
        :meth:`res_rows`."""
        rows, win_len = self._core(width, bits, main, win16, tables)
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

    def prepare(self, chunk, sub):
        """Host-side batch prep: fixed cuts, the native host quality
        windows, the host window gather, the pack decision, and the
        staging of the device arguments in the batch's slot. Returns
        (token, args | None, bits) where args = (main, win16, tables |
        None) are host tensors that feed :meth:`_step` once uploaded
        (``tables`` None: raw upload, decoded with the lane's own
        256-entry views)."""
        n = chunk.seq_len[sub].astype(np.int32)
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
        win_len = keep_stop - keep_start
        qclip = None

        if self._needs_quals:
            # native host quality path: windows + stats computed here,
            # nothing quality-related crosses the link
            g_stop, q_start, q_stop = self._native_quality(
                chunk, sub, keep_start, win_len
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
        pack = _pack_info(chunk)
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
            # raw upload (> 16 distinct symbols): the window bytes cross
            # the link as they are and the lane's 256-entry views decode
            bits = 0
            main = slot.buffer("main", (pad_b, width), torch.uint8)
            main.numpy()[...] = seqs
            tables = None
        return tok, (main, win16, tables), bits

    def submit(self, chunk, sub):
        """Prepare the batch, upload it and run the device step; nothing
        here waits for the device. On a CUDA device the upload goes
        ``non_blocking`` from the slot's pinned buffers on the side
        stream, the step runs on the current stream behind it, and the
        bundle is copied into the slot's pinned fetch buffer followed by
        the token's event."""
        began = time.perf_counter()
        tok, args, bits = self.prepare(chunk, sub)
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
            main, win16, tables = dev_args
            bundle = self._step(
                tok.width, bits, main, win16,
                self._view_luts_dev if tables is None else tables,
            )
            fetch = tok.slot.buffer("bundle", tuple(bundle.shape), torch.int16)
            fetch.copy_(bundle, non_blocking=True)
            tok.bundle = fetch
            tok.event = torch.cuda.Event()
            tok.event.record(compute)

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

    def _native_quality(self, chunk, sub, keep_start, win_len):
        """Relative (g_stop, q_start, q_stop) window arrays for this
        lane's NextSeq/quality stages, computed by the native host
        kernel straight from the chunk buffer (scalar spec
        ``commands/trim/qualtrim.py``)."""
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
        return g_stop, q_start, q_stop

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


def _format_records(chunk, sub, keep_start, keep_stop, keep, fmt="fastq"):
    """Native formatter: trimmed FASTQ/FASTA bytes for the kept records."""
    name_off = np.ascontiguousarray(chunk.name_off[sub])
    name_len = np.ascontiguousarray(chunk.name_len[sub])
    seq_off = np.ascontiguousarray(chunk.seq_off[sub])
    ks = np.ascontiguousarray(keep_start, np.int32)
    kp = np.ascontiguousarray(keep_stop, np.int32)
    kmask = np.ascontiguousarray(keep.astype(np.uint8))
    kept_bp = int(np.maximum(kp - ks, 0)[keep].sum())
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
            None, None, None, None, None, None, None, None,
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
        """The turbo runner of ``atropos_tpu`` hands such a configuration
        to its batched engine or scalar pipeline; neither exists here."""
        raise NotPortedError(
            "a configuration outside the turbo runner ({})".format(reason),
            "engine",
        )

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
    def _collect_output_formats(cls, formatters):
        """{path: format} for every destination formatter (main output
        plus untrimmed / too-short / too-long files), or a decline-reason
        string. The format comes from the formatter the trim stack
        already holds (so extension-less paths like /dev/null work
        exactly like the scalar writers)."""
        fmts = {}
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
            path = formatter.file1
            if not path or not isinstance(path, str) or path == "-":
                return "stdout/non-path output"
            fmts[path] = fmt
        return fmts

    def _fmt_of(self, path):
        """Output format for a destination path."""
        fmt = self._out_fmts.get(path)
        if fmt is None:
            fmt = self._stream_format(path)
            self._out_fmts[path] = fmt
        return fmt

    def _open_output(self, path):
        """Binary output handle (bytes from the native formatter go
        straight through — no text-codec round trip). Registers with the
        Writers container so close/force-create bookkeeping stays
        unified."""
        handle = self.writers.writers.get(path)
        if handle is None:
            handle = xopen(path, "wb")
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
        summary.update(self.record_handler.summarize())


class TurboTrimRunner(_TurboRunnerBase):
    """Streaming interval-based trim for eligible single-end configs."""

    @classmethod
    def build(cls, command_runner, record_handler, writers, device=None):
        """Return a runner for a turbo-eligible configuration; raise
        :class:`~atropos_tpu_torch.NotPortedError` for every other."""
        options = command_runner.options
        if options.paired or options.input2 or options.interleaved_input:
            raise NotPortedError("paired-end trimming", "paired")
        reason = cls._check_common(command_runner, record_handler)
        if reason:
            return cls._decline(reason)
        input1 = options.input1
        if not input1 or not isinstance(input1, str):
            return cls._decline("non-path input")
        in_fmt = cls._stream_format(input1, options.format)
        if in_fmt is None:
            return cls._decline("unsupported input format")
        formatters = record_handler.formatters
        if formatters.multiplexed:
            raise NotPortedError("demultiplexed output", "side-files")
        if formatters.info_formatters:
            raise NotPortedError(
                "info/rest/wildcard side files", "side-files"
            )
        out_fmts = cls._collect_output_formats(formatters)
        if isinstance(out_fmts, str):
            return cls._decline(out_fmts)

        mods = [
            entry[0] if isinstance(entry, list) else entry
            for entry in record_handler.modifiers.modifiers
        ]
        lane = _MateLane.from_modifier_list(mods, device=device)
        if isinstance(lane, str):
            return cls._decline(lane)
        if in_fmt == "fasta" and lane._needs_quals:
            return cls._decline("quality stage without qualities")
        return cls(command_runner, record_handler, writers, lane, in_fmt,
                   out_fmts)

    def __init__(self, command_runner, record_handler, writers, lane,
                 in_fmt="fastq", out_fmts=None):
        self.command_runner = command_runner
        self.options = command_runner.options
        self.record_handler = record_handler
        self.writers = writers
        self.lane = lane
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
        # --max-reads caps the record stream (scalar batcher semantics:
        # the first N records of the input)
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
                total_records += avail
                total_bp += int(chunk.seq_len[:avail].sum())
                for start in range(0, avail, self.MAX_BATCH):
                    sub = slice(start, min(start + self.MAX_BATCH, avail))
                    inflight.append(self.lane.submit(chunk, sub))
                    batches += 1
                    while len(inflight) >= self.DEPTH:
                        self._resolve(inflight.popleft())
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

