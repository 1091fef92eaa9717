"""Read modifiers: every transformation the trim command can apply.

Organized as: the modifier protocol (``base``), single-read transforms
(``single``), the adapter cutter (``adapter_cutter``), and — below —
the ordered container that holds a configured single-end modifier chain.
All names re-export here; behavior matches the reference
(``atropos/commands/trim/modifiers.py``). The turbo runner
(:mod:`atropos_tpu_torch.engine.turbo`) reads each stage's parameters
from the chain and accumulates its statistics into it; the pair-level
modifiers of ``atropos_tpu/commands/trim/modifiers/paired.py`` have no
counterpart here yet.
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
