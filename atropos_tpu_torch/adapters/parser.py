"""Adapter specification grammar.

A spec is ``[name=]SEQ`` where SEQ supports ``^``/``$`` anchoring,
``A...B`` linked adapters, ``x{n}`` repeat expansion, and ``file:FILE``
(one adapter per FASTA record). Grammar parity with the reference
(``atropos/adapters/__init__.py:80-229,933-970``).
"""
import itertools
import re

from atropos_tpu_torch.io.seqio import FastaReader

_BRACE_TOKEN = re.compile(r"\{(\d+)\}")


def parse_braces(sequence):
    """Expand ``x{n}`` repeats: ``N{3}`` -> ``NNN`` (0 <= n <= 10000)."""
    out = []
    cursor = 0
    for token in _BRACE_TOKEN.finditer(sequence):
        literal = sequence[cursor : token.start()]
        if not literal:
            raise ValueError('"{" must be used after a character')
        count = int(token.group(1))
        if count > 10000:
            raise ValueError("Value {} invalid".format(count))
        out.append(literal[:-1])
        out.append(literal[-1] * count)
        cursor = token.end()
    tail = sequence[cursor:]
    if "{" in tail or "}" in tail:
        raise ValueError("Invalid expression: {!r}".format(sequence))
    out.append(tail)
    return "".join(out)


def split_named_spec(spec):
    """``name=SEQ`` -> (name, SEQ); plain specs -> (None, SEQ)."""
    name, sep, seq = spec.partition("=")
    if not sep:
        return None, spec.strip()
    return name.strip(), seq.strip()


_ADAPTER_IDS = itertools.count(1)


def next_adapter_name():
    return str(next(_ADAPTER_IDS))


class AdapterParser:
    """Turns spec strings into Adapter objects.

    Construction arguments other than ``colorspace``/``cache`` pass
    through to every Adapter built.
    """

    def __init__(self, colorspace=False, cache=None, **kwargs):
        from atropos_tpu_torch.adapters.model import Adapter
        from atropos_tpu_torch.adapters.colorspace import ColorspaceAdapter

        self.colorspace = colorspace
        self.cache = cache
        self.constructor_args = kwargs
        self.adapter_class = ColorspaceAdapter if colorspace else Adapter

    def parse(self, spec, cmdline_type="back"):
        """Yield the adapter(s) for one spec (``file:`` yields several)."""
        if spec.startswith("file:"):
            with FastaReader(spec[5:]) as fasta:
                for record in fasta:
                    name = record.name.split(None, 1)[0]
                    yield self.parse_from_spec(
                        record.sequence, cmdline_type, name
                    )
        else:
            yield self.parse_from_spec(spec, cmdline_type)

    def parse_multi(self, back=None, anywhere=None, front=None):
        """All adapters from the -a/-b/-g option lists, in that order."""
        adapters = []
        for specs, cmdline_type in (
            (back, "back"),
            (anywhere, "anywhere"),
            (front, "front"),
        ):
            for spec in specs or ():
                adapters.extend(self.parse(spec, cmdline_type))
        return adapters

    # -- single-spec parsing ----------------------------------------------------

    def parse_from_spec(self, spec, cmdline_type="back", name=None):
        from atropos_tpu_torch.adapters.model import (
            ADAPTER_TYPES,
            ANYWHERE,
            BACK,
            FRONT,
            LinkedAdapter,
            PREFIX,
            SUFFIX,
        )

        if cmdline_type not in ADAPTER_TYPES:
            raise ValueError("cmdline_type cannot be {0!r}".format(cmdline_type))
        original = spec
        where = ADAPTER_TYPES[cmdline_type].flags

        name, spec = self._resolve_name(name, spec)

        anchored_5p = spec.startswith("^")
        anchored_3p = spec.endswith("$")
        spec = spec[1 if anchored_5p else 0 :]
        if anchored_3p:
            spec = spec[:-1]

        head, ellipsis, tail = spec.partition("...")

        if where == ANYWHERE:
            if anchored_5p or anchored_3p:
                raise ValueError("'anywhere' (-b) adapters may not be anchored")
            if ellipsis:
                raise ValueError("'anywhere' (-b) adapters may not be linked")
            return self._build(spec, where, name)

        assert where in (FRONT, BACK)
        if ellipsis:
            if not head:
                if where == FRONT:  # -g ...ADAPTER
                    raise ValueError("Invalid adapter specification")
                spec = tail  # -a ...ADAPTER == plain 3'
            elif not tail:
                spec = head
                if where == BACK:  # -a ADAPTER... == anchored 5'
                    where = FRONT
                    anchored_5p = True
                # -g ADAPTER... == plain 5'
            else:
                return self._build_linked(
                    head, tail, name, where, anchored_5p, anchored_3p
                )

        if anchored_5p and anchored_3p:
            raise ValueError(
                'Trying to use both "^" and "$" in adapter specification '
                "{!r}".format(original)
            )
        if anchored_5p:
            if where == BACK:
                raise ValueError("Cannot anchor the 3' adapter at its 5' end")
            where = PREFIX
        elif anchored_3p:
            if where == FRONT:
                raise ValueError("Cannot anchor 5' adapter at 3' end")
            where = SUFFIX

        return self._build(spec, where, name)

    def _resolve_name(self, name, spec):
        """Apply the cache: named lookups and registration of new pairs."""
        if name is None and spec is None:
            raise ValueError("Either name or spec must be given")
        if name is None:
            if self.cache and self.cache.has_name(spec):
                name, spec = spec, self.cache.get_for_name(spec)
        elif spec is None:
            if self.cache and self.cache.has_name(name):
                spec = self.cache.get_for_name(name)
        if spec is None:
            raise ValueError("Name not found: {}".format(name))
        if name is None:
            name, spec = split_named_spec(spec)
        if self.cache and name is not None:
            self.cache.add(name, spec)
        return name, spec

    def _build(self, sequence, where, name):
        return self.adapter_class(
            sequence=sequence, where=where, name=name, **self.constructor_args
        )

    def _build_linked(self, front, back, name, where, anchored_5p, anchored_3p):
        from atropos_tpu_torch.adapters.model import BACK, LinkedAdapter

        if self.colorspace:
            raise NotImplementedError(
                "Using linked adapters in colorspace is not supported"
            )
        if where == BACK:
            anchored_5p = True
        return LinkedAdapter(
            front,
            back,
            name=name,
            front_anchored=anchored_5p,
            back_anchored=anchored_3p,
            **self.constructor_args,
        )
