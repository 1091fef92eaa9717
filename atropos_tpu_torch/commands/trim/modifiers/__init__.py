"""Read modifiers: every transformation the trim command can apply.

Organized as: the modifier protocol (``base``), single-read transforms
(``single``), the adapter cutter (``adapter_cutter``), the insert-match
adapter cutter of read pairs (``paired``), and — below — the ordered
containers that hold a configured single-end or paired-end modifier
chain. All names re-export here; behavior matches the reference
(``atropos/commands/trim/modifiers.py``). The turbo runners
(:mod:`atropos_tpu_torch.engine.turbo`) read each stage's parameters
from the chain and accumulate its statistics into it. Of the pair-level
modifiers of ``atropos_tpu/commands/trim/modifiers/paired.py`` only
``InsertAdapterCutter`` and ``OverwriteRead`` have counterparts here.
"""
from atropos_tpu_torch.commands.trim.modifiers.base import (  # noqa: F401
    Modifier,
    ReadPairModifier,
    Trimmer,
)
from atropos_tpu_torch.commands.trim.modifiers.adapter_cutter import (  # noqa: F401
    AdapterCutter,
)
from atropos_tpu_torch.commands.trim.modifiers.single import (  # noqa: F401
    DoubleEncoder,
    LengthTagModifier,
    MinCutter,
    NEndTrimmer,
    NextseqQualityTrimmer,
    NonDirectionalBisulfiteTrimmer,
    PrefixSuffixAdder,
    PrimerTrimmer,
    QualityTrimmer,
    RRBSTrimmer,
    SuffixRemover,
    TruSeqBisulfiteTrimmer,
    UnconditionalCutter,
    ZeroCapper,
)
from atropos_tpu_torch.commands.trim.modifiers.paired import (  # noqa: F401
    InsertAdapterCutter,
    OverwriteRead,
)


class Modifiers:
    """An ordered chain of modifiers plus a type index.

    Entries are either a ``[read1_mod, read2_mod]`` pair (independent
    per-mate modifiers; either slot may be None) or a single
    ReadPairModifier instance.
    """

    def __init__(self):
        self.modifiers = []
        self.modifier_indexes = {}

    def _register(self, mod_class, entry):
        position = len(self.modifiers)
        self.modifiers.append(entry)
        self.modifier_indexes.setdefault(mod_class, []).append(position)
        return position

    def has_modifier(self, mod_class):
        return mod_class in self.modifier_indexes

    def get_modifiers(self, mod_class=None, read=None):
        """Entries, optionally restricted by type and/or mate number."""
        if mod_class is None:
            entries = list(self.modifiers)
        else:
            entries = [
                self.modifiers[i]
                for i in self.modifier_indexes.get(mod_class, ())
            ]
        if not (entries and read):
            return entries
        selected = []
        for entry in entries:
            if isinstance(entry, ReadPairModifier):
                selected.append(entry)
            elif entry[read - 1] is not None:
                selected.append(entry[read - 1])
        return selected

    def get_adapters(self):
        """[read1_adapters, read2_adapters] across cutter stages."""
        adapters = [[], []]
        if self.has_modifier(AdapterCutter):
            cutter1, cutter2 = self.get_modifiers(AdapterCutter)[0]
            if cutter1:
                adapters[0] = cutter1.adapters
            if cutter2:
                adapters[1] = cutter2.adapters
        elif self.has_modifier(InsertAdapterCutter):
            cutter = self.get_modifiers(InsertAdapterCutter)[0]
            adapters[0] = [cutter.adapter1]
            adapters[1] = [cutter.adapter2]
        return adapters

    # subclass responsibilities
    def add_modifier(self, mod_class, read=1 | 2, **kwargs):
        raise NotImplementedError()

    def add_modifier_pair(self, mod_class, read1_args=None, read2_args=None):
        raise NotImplementedError()

    def modify(self, read1, read2=None):
        raise NotImplementedError()

    def summarize(self):
        raise NotImplementedError()


class SingleEndModifiers(Modifiers):
    """Modifier chain over read1 only."""

    def add_modifier(self, mod_class, read=1, **kwargs):
        if read != 1:
            raise ValueError("'read' must be 1 for single-end data")
        return self._register(mod_class, [mod_class(**kwargs), None])

    def add_modifier_pair(self, mod_class, read1_args=None, read2_args=None):
        if read1_args is not None:
            return self.add_modifier(mod_class, **read1_args)

    def modify(self, read1, read2=None):
        for entry in self.modifiers:
            read1 = entry[0](read1)
        return (read1,)

    def summarize(self):
        report = {}
        for entry in self.modifiers:
            mod = entry[0]
            stats = {key: (value,) for key, value in mod.summarize().items()}
            stats["desc"] = mod.description
            report[mod.name] = stats
        return report


class PairedEndModifiers(Modifiers):
    """Modifier chain over read pairs.

    ``paired == 'both'`` allows per-mate and pair modifiers; the legacy
    ``'first'`` mode only ever modifies read1.
    """

    def __init__(self, paired):
        super().__init__()
        self.paired = paired

    def add_modifier(self, mod_class, read=1 | 2, **kwargs):
        if issubclass(mod_class, ReadPairModifier):
            if self.paired != "both" and read == 1 | 2:
                raise ValueError(
                    "Must have paired-end reads to use modifer {}".format(
                        mod_class
                    )
                )
            return self._register(mod_class, mod_class(**kwargs))
        entry = [
            mod_class(**kwargs) if read & 1 else None,
            mod_class(**kwargs) if (read & 2 and self.paired == "both") else None,
        ]
        if not any(entry):
            return None
        return self._register(mod_class, entry)

    def add_modifier_pair(self, mod_class, read1_args=None, read2_args=None):
        entry = [
            mod_class(**read1_args) if read1_args is not None else None,
            mod_class(**read2_args)
            if (read2_args is not None and self.paired == "both")
            else None,
        ]
        if any(entry):
            return self._register(mod_class, entry)

    def modify(self, read1, read2=None):
        for entry in self.modifiers:
            if isinstance(entry, ReadPairModifier):
                read1, read2 = entry(read1, read2)
            else:
                if entry[0] is not None:
                    read1 = entry[0](read1)
                if entry[1] is not None:
                    read2 = entry[1](read2)
        return (read1, read2)

    def summarize(self):
        report = {}
        for entry in self.modifiers:
            if isinstance(entry, ReadPairModifier):
                stats = entry.summarize()
                stats["desc"] = entry.description
                report[entry.name] = stats
            elif any(entry):
                self._summarize_pair(report, entry)
        return report

    @staticmethod
    def _summarize_pair(report, entry):
        """Zip per-mate summaries into (read1_value, read2_value) tuples."""
        mod1, mod2 = entry
        stats1 = mod1.summarize() if mod1 else {}
        stats2 = mod2.summarize() if mod2 else {}
        if mod1 and stats1:
            name, desc, keys = mod1.name, mod1.description, stats1.keys()
            if mod2 and stats2:
                assert name == mod2.name
                assert desc == mod2.description
                assert set(keys) == set(stats2.keys())
        elif mod2 and stats2:
            name, desc, keys = mod2.name, mod2.description, stats2.keys()
        else:
            return
        merged = {
            key: (stats1.get(key, None), stats2.get(key, None)) for key in keys
        }
        merged["desc"] = desc
        report[name] = merged
