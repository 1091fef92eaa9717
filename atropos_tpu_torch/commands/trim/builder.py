"""Assembly of the trim stack from parsed options.

Translates the CLI option namespace into the four pipeline pieces —
modifier chain, filter chain, formatter table, writers — honoring the
user's ``--op-order`` for the reorderable stages. Option semantics follow
the reference build switch (``atropos/commands/trim/__init__.py:338-648``);
the structure here is table-driven (option->constructor maps and a
filter/output registration table) rather than a monolithic method.
"""
import sys

from atropos_tpu_torch import NotPortedError
from atropos_tpu_torch.adapters import AdapterParser, BACK
from atropos_tpu_torch.commands.trim import filters as filt
from atropos_tpu_torch.commands.trim import modifiers as mod
from atropos_tpu_torch.commands.trim import writers as wrt
from atropos_tpu_torch.io import STDOUT
from atropos_tpu_torch.util import RandomMatchProbability


class TrimStackBuilder:
    """Builds (modifiers, filters, formatters, writers) from options."""

    def __init__(self, runner):
        self.runner = runner
        self.options = runner.options
        self.match_probability = RandomMatchProbability()
        self.adapters1 = []
        self.adapters2 = []

    def build(self):
        self.parse_adapters()
        self.validate()
        modifiers = self.build_modifiers()
        filters, formatters, writers = self.build_output_stack()
        return modifiers, filters, formatters, writers

    # -- adapters -------------------------------------------------------------

    #: AdapterParser constructor argument -> options attribute
    _PARSER_OPTION_MAP = (
        ("colorspace", "colorspace"),
        ("max_error_rate", "error_rate"),
        ("min_overlap", "overlap"),
        ("read_wildcards", "match_read_wildcards"),
        ("adapter_wildcards", "match_adapter_wildcards"),
        ("indels", "indels"),
        ("indel_cost", "indel_cost"),
        ("gc_content", "gc_content"),
        ("alphabet", "alphabet"),
    )

    def parse_adapters(self):
        options = self.options
        specs1 = (options.adapters, options.anywhere, options.front)
        specs2 = (options.adapters2, options.anywhere2, options.front2)
        if not (any(specs1) or any(specs2)):
            return

        cache = self.runner.load_known_adapters()
        parser_args = {
            arg: getattr(options, opt) for arg, opt in self._PARSER_OPTION_MAP
        }
        parser_args.update(
            cache=cache, match_probability=self.match_probability
        )
        if options.adapter_max_rmp:
            parser_args["max_rmp"] = options.adapter_max_rmp
        parser = AdapterParser(**parser_args)
        if any(specs1):
            self.adapters1 = parser.parse_multi(*specs1)
        if any(specs2):
            self.adapters2 = parser.parse_multi(*specs2)
        if options.cache_adapters:
            cache.save()

    def validate(self):
        options = self.options
        if not (self.adapters1 or self.adapters2) and self._nothing_else_to_do():
            raise ValueError("You need to provide at least one adapter sequence.")
        if options.aligner == "insert" and any(
            not a or len(a) != 1 or a[0].where != BACK
            for a in (self.adapters1, self.adapters2)
        ):
            raise ValueError(
                "Insert aligner requires a single 3' adapter for each read"
            )
        if options.debug:
            for adapter in self.adapters1 + self.adapters2:
                adapter.enable_debug()

    def _nothing_else_to_do(self):
        """True when no option implies any modification or filtering."""
        options = self.options
        implied_work = (
            bool(options.quality_cutoff),
            options.nextseq_trim is not None,
            bool(options.cut or options.cut2),
            bool(options.cut_min or options.cut_min2),
            options.minimum_length is not None and options.minimum_length > 0,
            options.maximum_length < sys.maxsize,
            bool(options.trim_n),
            bool(self.runner.has_qualfile),
            options.max_n is not None,
            bool(options.paired and options.overwrite_low_quality),
        )
        return not any(implied_work)

    # -- modifiers --------------------------------------------------------------

    def build_modifiers(self):
        options = self.options
        chain = (
            mod.PairedEndModifiers(options.paired)
            if options.paired
            else mod.SingleEndModifiers()
        )
        for opcode in options.op_order:
            self._OP_STAGES[opcode](self, chain)
        for stage in self._FIXED_STAGES:
            stage(self, chain)
        return chain

    def _op_overwrite(self, chain):
        if not self.options.overwrite_low_quality:
            return
        lowq, highq, window = self.options.overwrite_low_quality
        chain.add_modifier(
            mod.OverwriteRead,
            worse_read_min_quality=lowq,
            better_read_min_quality=highq,
            window_size=window,
            base=self.options.quality_base,
        )

    def _op_adapters(self, chain):
        options = self.options
        if not (self.adapters1 or self.adapters2):
            return
        if options.aligner == "insert":
            chain.add_modifier(
                mod.InsertAdapterCutter,
                adapter1=self.adapters1[0],
                adapter2=self.adapters2[0],
                action=options.action,
                mismatch_action=options.correct_mismatches,
                max_insert_mismatch_frac=options.insert_match_error_rate,
                max_adapter_mismatch_frac=options.insert_match_adapter_error_rate,
                match_probability=self.match_probability,
                insert_max_rmp=options.insert_max_rmp,
                read_wildcards=options.match_read_wildcards,
                adapter_wildcards=options.match_adapter_wildcards,
            )
            return

        def cutter_args(adapters):
            if not adapters:
                return None
            return dict(
                adapters=adapters, times=options.times, action=options.action
            )

        chain.add_modifier_pair(
            mod.AdapterCutter,
            cutter_args(self.adapters1),
            cutter_args(self.adapters2),
        )

    def _op_cut(self, chain):
        if self.options.cut or self.options.cut2:
            chain.add_modifier_pair(
                mod.UnconditionalCutter,
                dict(lengths=self.options.cut),
                dict(lengths=self.options.cut2),
            )

    def _op_nextseq(self, chain):
        if self.options.nextseq_trim is not None:
            chain.add_modifier(
                mod.NextseqQualityTrimmer,
                cutoff=self.options.nextseq_trim,
                base=self.options.quality_base,
            )

    def _op_quality(self, chain):
        if self.options.quality_cutoff:
            chain.add_modifier(
                mod.QualityTrimmer,
                cutoff_front=self.options.quality_cutoff[0],
                cutoff_back=self.options.quality_cutoff[1],
                base=self.options.quality_base,
            )

    _OP_STAGES = {
        "W": _op_overwrite,
        "A": _op_adapters,
        "C": _op_cut,
        "G": _op_nextseq,
        "Q": _op_quality,
    }

    # stages with a fixed position after the reorderable block

    def _stage_bisulfite(self, chain):
        preset = self.options.bisulfite
        if not preset:
            return
        if isinstance(preset, str):
            if "non-directional" in preset:
                chain.add_modifier(
                    mod.NonDirectionalBisulfiteTrimmer,
                    rrbs=preset == "non-directional-rrbs",
                )
            elif preset == "rrbs":
                chain.add_modifier(mod.RRBSTrimmer)
            elif preset == "swift":
                raise NotPortedError("--bisulfite swift", "engine")
            # 'epignome'/'truseq': trimming leads to worse results — no-op
            return
        if preset[0]:
            chain.add_modifier(mod.MinCutter, read=1, **preset[0])
        if len(preset) > 1 and preset[1]:
            chain.add_modifier(mod.MinCutter, read=2, **preset[1])

    def _stage_trim_n(self, chain):
        if self.options.trim_n:
            chain.add_modifier(mod.NEndTrimmer)

    def _stage_cut_min(self, chain):
        if self.options.cut_min or self.options.cut_min2:
            chain.add_modifier_pair(
                mod.MinCutter,
                dict(lengths=self.options.cut_min),
                dict(lengths=self.options.cut_min2),
            )

    def _stage_names(self, chain):
        options = self.options
        if options.length_tag:
            chain.add_modifier(
                mod.LengthTagModifier, length_tag=options.length_tag
            )
        if options.strip_suffix:
            chain.add_modifier(mod.SuffixRemover, suffixes=options.strip_suffix)
        if options.prefix or options.suffix:
            chain.add_modifier(
                mod.PrefixSuffixAdder,
                prefix=options.prefix,
                suffix=options.suffix,
            )

    def _stage_colorspace(self, chain):
        options = self.options
        if options.double_encode:
            chain.add_modifier(mod.DoubleEncoder)
        if options.zero_cap and self.runner.delivers_qualities:
            chain.add_modifier(
                mod.ZeroCapper, quality_base=options.quality_base
            )
        if options.trim_primer:
            chain.add_modifier(mod.PrimerTrimmer)

    def _stage_merge(self, chain):
        options = self.options
        if options.merge_overlapping:
            raise NotPortedError("--merge-overlapping", "engine")

    _FIXED_STAGES = (
        _stage_bisulfite,
        _stage_trim_n,
        _stage_cut_min,
        _stage_names,
        _stage_colorspace,
        _stage_merge,
    )

    # -- filters / formatters / writers ---------------------------------------------

    def _filter_registrations(self):
        """Filter-priority registration table: one row per category, in
        the reference's fixed order — (enabled, filter type, filter args,
        attach-output?, output paths)."""
        options = self.options
        return (
            (
                bool(options.merge_overlapping),
                filt.MergedReadFilter, (),
                bool(options.merged_output),
                (options.merged_output,),
            ),
            (
                options.minimum_length is not None
                and options.minimum_length > 0,
                filt.TooShortReadFilter, (options.minimum_length,),
                bool(options.too_short_output),
                (options.too_short_output, options.too_short_paired_output),
            ),
            (
                options.maximum_length < sys.maxsize,
                filt.TooLongReadFilter, (options.maximum_length,),
                options.too_long_output is not None,
                (options.too_long_output, options.too_long_paired_output),
            ),
            (
                options.max_n is not None,
                filt.NContentFilter, (options.max_n,),
                False, (),
            ),
            (
                bool(options.discard_trimmed),
                filt.TrimmedFilter, (),
                False, (),
            ),
        )

    def build_output_stack(self):
        options = self.options
        min_affected = 2 if options.pair_filter == "both" else 1
        chain = filt.Filters(filt.FilterFactory(options.paired, min_affected))

        if options.interleaved_output:
            output1, output2 = options.interleaved_output, None
            interleaved = True
        else:
            output1, output2 = options.output, options.paired_output
            interleaved = False

        formatters = wrt.Formatters(
            output1,
            dict(
                qualities=self.runner.delivers_qualities,
                colorspace=options.colorspace,
                interleaved=interleaved,
            ),
        )
        force_create = []

        for enabled, ftype, fargs, attach, outputs in self._filter_registrations():
            if not enabled:
                continue
            chain.add_filter(ftype, *fargs)
            if attach:
                formatters.add_seq_formatter(ftype, *outputs)

        keep_untrimmed = not options.discard_untrimmed

        def register_main(path1, path2=None):
            formatters.add_seq_formatter(filt.NoFilter, path1, path2)
            if path1 != STDOUT and options.writer_process:
                force_create.append(path1)
                if path2 is not None:
                    force_create.append(path2)

        if not formatters.multiplexed:
            if output1 is not None:
                register_main(output1, output2)
            elif not (options.discard_trimmed and options.untrimmed_output):
                register_main(options.default_outfile)

        if options.discard_untrimmed or options.untrimmed_output:
            chain.add_filter(filt.UntrimmedFilter)
        if keep_untrimmed:
            if formatters.multiplexed:
                untrimmed = (
                    options.untrimmed_output or output1.format(name="unknown")
                )
                formatters.add_seq_formatter(filt.UntrimmedFilter, untrimmed)
                formatters.add_seq_formatter(filt.NoFilter, untrimmed)
            elif options.untrimmed_output:
                formatters.add_seq_formatter(
                    filt.UntrimmedFilter,
                    options.untrimmed_output,
                    options.untrimmed_paired_output,
                )

        for option_value, formatter_class in (
            (options.rest_file, wrt.RestFormatter),
            (options.info_file, wrt.InfoFormatter),
            (options.wildcard_file, wrt.WildcardFormatter),
        ):
            if option_value:
                formatters.add_info_formatter(formatter_class(option_value))

        return chain, formatters, wrt.Writers(force_create)
