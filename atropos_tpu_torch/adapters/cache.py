"""Known-adapter name<->sequence cache.

A small pickled bidirectional map (default file ``.adapters``) seeded
from the bundled adapter FASTA or a URL; corrupt cache files are
silently discarded. Reference behavior:
``atropos/adapters/__init__.py:747-931``.
"""
import logging
import os
import pickle
from urllib.error import URLError
from urllib.request import urlopen

from atropos_tpu_torch.io.seqio import FastaReader
from atropos_tpu_torch.util import reverse_complement

DEFAULT_ADAPTERS_URL = (
    "https://raw.githubusercontent.com/jdidion/atropos/master/atropos/"
    "adapters/sequencing_adapters.fa"
)
DEFAULT_ADAPTERS_PATH = os.path.join(
    os.path.dirname(__file__), "sequencing_adapters.fa"
)


class AdapterCache:
    def __init__(self, path=".adapters", auto_reverse_complement=False):
        self.path = path
        self.auto_reverse_complement = auto_reverse_complement
        self.seq_to_name = {}
        self.name_to_seq = {}
        if path and os.path.exists(path):
            try:
                with open(path, "rb") as cache:
                    self.seq_to_name, self.name_to_seq = pickle.load(cache)
            except Exception:
                pass  # a corrupt cache is treated as empty

    @property
    def empty(self):
        return not self.seq_to_name

    def save(self):
        if self.path is not None:
            with open(self.path, "wb") as cache:
                pickle.dump((self.seq_to_name, self.name_to_seq), cache)

    def _register(self, name, seq):
        self.seq_to_name.setdefault(seq, set()).add(name)
        self.name_to_seq[name] = seq

    def add(self, name, seq):
        self._register(name, seq)
        if self.auto_reverse_complement:
            self._register("{}_rc".format(name), reverse_complement(seq))

    # -- bulk loading -------------------------------------------------------------

    def load_from_fasta(self, fasta):
        opened = isinstance(fasta, str)
        if opened:
            fasta = open(fasta, "rt")
        count = None
        try:
            with FastaReader(fasta) as reader:
                for count, record in enumerate(reader, 1):
                    self.add(record.name.split(None, 1)[0], record.sequence)
        finally:
            if opened:
                fasta.close()
        return count

    def load_from_file(self, path=DEFAULT_ADAPTERS_PATH):
        with open(path, "rt") as infile:
            return self.load_from_fasta(infile)

    def load_from_url(self, url=DEFAULT_ADAPTERS_URL):
        logging.getLogger().info(
            "Loading list of known contaminants from %s", url
        )
        try:
            lines = urlopen(url).read().decode().split("\n")
            return self.load_from_fasta(lines)
        except URLError:
            if url.startswith("file:"):
                url = url[5:]
            return self.load_from_file(url)

    def load_default(self):
        """Seed from the bundled adapter database (works offline)."""
        try:
            return self.load_from_file()
        except IOError:
            logging.getLogger().warning(
                "Error loading adapters from file %s", DEFAULT_ADAPTERS_PATH
            )

    # -- queries --------------------------------------------------------------------

    @property
    def names(self):
        return list(self.name_to_seq)

    @property
    def sequences(self):
        return list(self.seq_to_name)

    def iter_names(self):
        return self.name_to_seq.items()

    def iter_sequences(self):
        return self.seq_to_name.items()

    def has_name(self, name):
        return name in self.name_to_seq

    def get_for_name(self, name):
        return self.name_to_seq[name]

    def has_seq(self, seq):
        return seq in self.seq_to_name

    def get_for_seq(self, seq):
        return list(self.seq_to_name[seq])

    def summarize(self):
        return dict(
            path=self.path,
            auto_reverse_complement=self.auto_reverse_complement,
            num_adapter_names=len(self.name_to_seq),
            num_adapter_seqs=len(self.seq_to_name),
        )
