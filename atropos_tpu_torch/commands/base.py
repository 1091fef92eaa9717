"""Shared command machinery: the summary tree and the base command runner.

The runner owns the input reader (whose ``summarize`` feeds the report's
input section) and the run's summary; summaries are merge-capable dict
trees that collapse to plain data at the end of a run. Counterpart of
``atropos_tpu/commands/base.py`` without the per-record batch loop, which
only the scalar pipeline uses.
"""
import platform
import sys
from collections.abc import Sequence

from atropos_tpu_torch import NotPortedError, __version__
from atropos_tpu_torch.adapters import AdapterCache
from atropos_tpu_torch.io.seqio import open_reader
from atropos_tpu_torch.util import Const, MergingDict, Summarizable, Timing


class Summary(MergingDict):
    """The run's summary tree.

    While the run is live, nodes may be Summarizable/Const objects;
    ``finish`` walks the tree bottom-up replacing them with plain data so
    the result serializes cleanly.
    """

    @property
    def has_exception(self):
        return "exception" in self

    def finish(self):
        self._collapse(self)

    def _collapse(self, node):
        if node is None:
            return
        for key, value in tuple(node.items()):
            if value is None:
                continue
            if isinstance(value, Summarizable):
                node[key] = value = value.summarize()
            if isinstance(value, dict):
                self._collapse(value)
            elif isinstance(value, Sequence) and self._is_dict_list(value):
                for child in value:
                    self._collapse(child)
            else:
                if isinstance(value, Const):
                    node[key] = value = value.value
                self._post_process_other(node, key, value)

    @staticmethod
    def _is_dict_list(value):
        return len(value) > 0 and all(
            child is None or isinstance(child, dict) for child in value
        )

    def _post_process_other(self, parent, key, value):
        pass


class BaseCommandRunner:
    """Owns the reader and the summary for one command invocation.

    Attribute lookups fall through to the reader and then to the parsed
    options, so command code can write ``self.quality_base`` etc. without
    caring where the value lives.
    """

    def __init__(self, options, summary_class=Summary):
        self.options = options
        self.summary = summary_class()
        self.timing = Timing()
        self.return_code = None
        self.size = options.batch_size or 1000
        self.batches = 0
        self.done = False
        self.reader = self._open_input(options)
        self.init_summary()

    #: reader-constructor arguments copied verbatim from the options
    _READER_OPTIONS = ("quality_base", "colorspace", "input_read", "alphabet")

    @classmethod
    def _open_input(cls, options):
        common = {
            name: getattr(options, name) for name in cls._READER_OPTIONS
        }
        if getattr(options, "sra_reader", None):
            raise NotPortedError("SRA streaming input", "engine")
        interleaved = bool(options.interleaved_input)
        if interleaved:
            input1, input2, qualfile = options.interleaved_input, None, None
        elif options.paired:
            input1, input2, qualfile = options.input1, options.input2, None
        else:
            input1, input2, qualfile = options.input1, None, options.input2
        return open_reader(
            file1=input1,
            file2=input2,
            file_format=options.format,
            qualfile=qualfile,
            interleaved=interleaved,
            **common,
        )

    def __getattr__(self, name):
        if hasattr(self.reader, name):
            return getattr(self.reader, name)
        if hasattr(self.options, name):
            return getattr(self.options, name)
        raise ValueError("Unknown attribute: {}".format(name))

    # -- summary / lifecycle ---------------------------------------------------

    def init_summary(self):
        self.summary["program"] = "Atropos"
        self.summary["version"] = __version__
        self.summary["python"] = platform.python_version()
        self.summary["command"] = self.name
        # the device is reported beside the options, so the options
        # section equals that of an atropos_tpu run of the same argv
        options = self.options.__dict__.copy()
        self.summary["device"] = options.pop("device", None)
        self.summary["options"] = options
        self.summary["timing"] = self.timing
        self.summary["sample_id"] = self.options.sample_id
        self.summary["input"] = self.reader.summarize()
        self.summary["input"].update(
            batch_size=self.size, max_reads=self.max_reads, batches=self.batches
        )

    def run(self):
        """Execute the command under timing; returns (retcode, summary)."""
        with self.timing:
            try:
                self.return_code = self()
            except NotPortedError:
                raise
            except Exception as err:  # pylint: disable=broad-except
                self.summary["exception"] = dict(
                    message=str(err), details=sys.exc_info()
                )
                self.return_code = 1
            finally:
                self.finish()
        return (self.return_code, self.summary)

    def __call__(self):
        raise NotImplementedError()

    def finish(self):
        if not self.done:
            self.done = True
            self.reader.close()
        self.summary.finish()

    def load_known_adapters(self):
        """Build the adapter-name cache per the run's options."""
        cache_file = (
            self.options.adapter_cache_file
            if self.options.cache_adapters
            else None
        )
        cache = AdapterCache(cache_file)
        if cache.empty and self.options.default_adapters:
            cache.load_default()
        for spec in self.options.known_adapter or ():
            name, seq = spec.split("=")
            cache.add(name, seq)
        for url in self.options.known_adapters_file or ():
            cache.load_from_url(url)
        if self.options.cache_adapters:
            cache.save()
        return cache
