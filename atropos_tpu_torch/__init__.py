"""atropos_tpu_torch — the PyTorch + CUDA port of atropos_tpu.

The same NGS read trimmer, written for an NVIDIA Hopper GPU: reads are
parsed and bit-packed on the host by the native runtime, uploaded from
pinned buffers, decoded and aligned on the card (one hand-written CUDA
kernel launch per adapter and batch runs the whole semi-global
adapter-alignment DP, one thread per read), and the int16 result bundle
is resolved, filtered and formatted on the host while later batches
compute. Output bytes and summaries are identical to ``atropos_tpu``.

Modules carry the names of their ``atropos_tpu`` counterparts:

- ``atropos_tpu_torch.util``      — host-side primitives (merge algebra, RMP, ...)
- ``atropos_tpu_torch.align``     — NumPy oracle, plain PyTorch versions, CUDA kernels (DP, diagonal counts)
- ``atropos_tpu_torch.io``        — sequence I/O (FASTA/FASTQ, FASTA+qual, colorspace, SAM/BAM, SRA)
- ``atropos_tpu_torch.adapters``  — adapter parsing/matching/caching
- ``atropos_tpu_torch.runtime``   — native FASTQ/FASTA parser, packer, formatter
- ``atropos_tpu_torch.engine``    — the turbo single-end and paired-end runners and their device steps, and the batched TrimEngine of the per-record pipeline
- ``atropos_tpu_torch.commands``  — the trim command (turbo, per-record pipeline, ``--threads`` workers), the qc, detect and error commands, CLI, reports, read statistics
- ``atropos_tpu_torch.parallel``  — multi-process ranks over ``torch.distributed``
- ``atropos_tpu_torch.tools``     — measurement tools (the dtype probe of the DP column body)

The package imports ``torch`` and ``numpy`` only. Every entry point takes
its device explicitly; ``None`` means ``cuda``, and only an explicit
``cpu`` runs on the CPU (see :func:`resolve_device`). Whatever lies
outside the ported slice raises :class:`NotPortedError`.
"""

__version__ = "0.1.0"


class AtroposError(Exception):
    """Base exception for expected errors (analog of the reference's
    ``atropos.AtroposError``)."""


#: what is still to be ported, keyed by a short topic name; the values
#: name the ROADMAP.md queue item that will bring it
ROADMAP_ITEMS = {
    "device-quality": "queue 1 item 5 (device quality-trimming kernels)",
    "multi-gpu": (
        "queue 1 item 7a (the split of one device batch over a host's cards)"
    ),
}


class NotPortedError(NotImplementedError):
    """Raised for everything ``atropos_tpu`` does that this package does
    not do yet. The message names the ROADMAP.md queue item that ports it;
    nothing carries on along another path."""

    def __init__(self, what, topic):
        self.what = what
        self.topic = topic
        super().__init__(
            "{} is not ported to atropos_tpu_torch yet: ROADMAP.md {}".format(
                what, ROADMAP_ITEMS[topic]
            )
        )


class DeviceUnavailableError(RuntimeError):
    """``cuda`` was requested (or implied) and no card is usable."""


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``cuda``. ``cuda`` without a usable card raises; only
    an explicit ``cpu`` selects the CPU — nothing falls back.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("unsupported device {!r}".format(str(dev)))
    return dev
