"""The upstream single-end goldens through the port.

Every single-end case of ``tests/test_trim_se.py`` is listed here with its
command line. The cases the JAX package runs through its turbo runner and
that lie in the ported slice go through ``atropos_tpu_torch`` on ``cpu``
and must reproduce ``tests/conformance/expected/`` byte for byte, with
their side files (rest, info and wildcard files, the demultiplexed
outputs) as the upstream tests check them; the others (colorspace, and
what the turbo runner hands to the batched engine or the scalar pipeline)
must raise ``NotPortedError`` naming their ROADMAP.md queue item, before
any output is written.
"""
import os

import pytest

from atropos_tpu_torch import ROADMAP_ITEMS, NotPortedError
from atropos_tpu_torch.commands import get_command

from .conformance_utils import assert_files_equal, cutpath
from .conformance_utils import datapath as D

#: (name, parameters, golden file, input file); ``{tmp}`` is the test's
#: scratch directory
CASES = [
 ("example","-N -b ADAPTER","example.fa","example.fa"),
 ("small","-b TTAGACATATCTCCGTCG","small.fastq","small.fastq"),
 ("empty","-a TTAGACATATCTCCGTCG","empty.fastq","empty.fastq"),
 ("newlines","-e 0.12 -b TTAGACATATCTCCGTCG","dos.fastq","dos.fastq"),
 ("lowercase","-b ttagacatatctccgtcg","lowercase.fastq","small.fastq"),
 ("rest","-b ADAPTER -N -r {tmp}/rest.tmp","rest.fa","rest.fa"),
 ("restfront","-g ADAPTER -N -r {tmp}/rest.tmp","restfront.fa","rest.fa"),
 ("discard","-b TTAGACATATCTCCGTCG --discard","discard.fastq","small.fastq"),
 ("discard_untrimmed","-b CAAGAT --discard-untrimmed","discard-untrimmed.fastq","small.fastq"),
 ("plus","-e 0.12 -b TTAGACATATCTCCGTCG","plus.fastq","plus.fastq"),
 ("extensiontxtgz","-b TTAGACATATCTCCGTCG","s_1_sequence.txt","s_1_sequence.txt.gz"),
 ("format","-f fastq -b TTAGACATATCTCCGTCG","small.fastq","small.myownextension"),
 ("minimum_length","-c -m 5 -a 330201030313112312","minlen.fa","lengths.fa"),
 ("too_short","-c -m 5 -a 330201030313112312 --too-short-output {tmp}/tooshort.tmp.fa","minlen.fa","lengths.fa"),
 ("too_short_no_primer","-c -m 5 -a 330201030313112312 --trim-primer --too-short-output {tmp}/tooshort.tmp.fa","minlen.noprimer.fa","lengths.fa"),
 ("maximum_length","-c -M 5 -a 330201030313112312","maxlen.fa","lengths.fa"),
 ("too_long","-c -M 5 --too-long-output {tmp}/toolong.tmp.fa -a 330201030313112312","maxlen.fa","lengths.fa"),
 ("length_tag","-n 3 -e 0.1 --length-tag length= -b TGAGACACGCAACAGGGGAAAGGCAAGGCACACAGGGGATAGG -b TCCATCTCATCCCTGCGTGTCCCATCTGTTCCCTCCCTGTCTCA","454.fa","454.fa"),
 ("overlap_a","-O 10 -a 330201030313112312 -e 0.0 -N","overlapa.fa","overlapa.fa"),
 ("overlap_b","-O 10 -b TTAGACATATCTCCGTCG -N","overlapb.fa","overlapb.fa"),
 ("qualtrim","-q 10 -a XXXXXX","lowqual.fastq","lowqual.fastq"),
 ("qualbase","-q 10 --quality-base 64 -a XXXXXX","illumina64.fastq","illumina64.fastq"),
 ("quality_trim_only","-q 10 --quality-base 64","illumina64.fastq","illumina64.fastq"),
 ("twoadapters","-a AATTTCAGGAATT -a GTTCTCTAGTTCT","twoadapters.fasta","twoadapters.fasta"),
 ("polya","-m 24 -O 10 -a AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA","polya.fasta","polya.fasta"),
 ("polya_brace_notation","-m 24 -O 10 -a A{35}","polya.fasta","polya.fasta"),
 ("mask_adapter","-b CAAG -n 3 --mask-adapter","anywhere_repeat.fastq","anywhere_repeat.fastq"),
 ("gz_multiblock","-b TTAGACATATCTCCGTCG","small.fastq","multiblock.fastq.gz"),
 ("suffix","-c -e 0.12 -a 1=330201030313112312 -y _my_suffix_{name} --strip-f3 -sq "+D("solid.qual"),"suffix.fastq","solid.csfasta"),
 ("read_wildcard","--match-read-wildcards -b ACGTACGT","wildcard.fa","wildcard.fa"),
 ("adapter_wildcard_a","--wildcard-file {tmp}/wc.txt -a ACGTNNNACGT","wildcard_adapter.fa","wildcard_adapter.fa"),
 ("adapter_wildcard_b","--wildcard-file {tmp}/wc.txt -b ACGTNNNACGT","wildcard_adapter_anywhere.fa","wildcard_adapter.fa"),
 ("wildcard_N","-e 0 -a GGGGGGG --match-read-wildcards","wildcardN.fa","wildcardN.fa"),
 ("illumina_adapter_wildcard","-a VCCGAMCYUCKHRKDCUBBCNUWNSGHCGU","illumina.fastq","illumina.fastq.gz"),
 ("adapter_front","--front ADAPTER -N","examplefront.fa","example.fa"),
 ("literal_N","-N -e 0.2 -a NNNNNNNNNNNNNN","trimN3.fasta","trimN3.fasta"),
 ("literal_N2","-N -O 1 -g NNNNNNNNNNNNNN","trimN5.fasta","trimN5.fasta"),
 ("literal_N_brace_notation","-N -e 0.2 -a N{14}","trimN3.fasta","trimN3.fasta"),
 ("literal_N2_brace_notation","-N -O 1 -g N{14}","trimN5.fasta","trimN5.fasta"),
 ("anchored_front","-g ^FRONTADAPT -N","anchored.fasta","anchored.fasta"),
 ("anchored_front_ellipsis_notation","-a FRONTADAPT... -N","anchored.fasta","anchored.fasta"),
 ("anchored_back","-a BACKADAPTER$ -N","anchored-back.fasta","anchored-back.fasta"),
 ("anchored_back_no_indels","-a BACKADAPTER$ -N --no-indels","anchored-back.fasta","anchored-back.fasta"),
 ("no_indels","-a TTAGACATAT -g GAGATTGCCA --no-indels","no_indels.fasta","no_indels.fasta"),
 ("anywhere_wildcard_file","--anywhere=AACGTN --wildcard-file={tmp}/wc.txt","issue46.fasta","issue46.fasta"),
 ("strip_suffix","--strip-suffix _sequence -a XXXXXXX","stripped.fasta","simple.fasta"),
 ("info_file","--info-file {tmp}/info.txt -a adapt=GCCGAACTTCTTAGACTGCCTTAAGGACGT","illumina.fastq","illumina.fastq.gz"),
 ("info_file_times","--info-file {tmp}/info.txt --times 2 -a adapt=GCCGAACTTCTTA -a adapt2=GACTGCCTTAAGGACGT","illumina5.fastq","illumina5.fastq"),
 ("info_file_fasta","--info-file {tmp}/info.txt -a TTAGACATAT -g GAGATTGCCA --no-indels","no_indels.fasta","no_indels.fasta"),
 ("named_adapter","-a MY_ADAPTER=GCCGAACTTCTTAGACTGCCTTAAGGACGT","illumina.fastq","illumina.fastq.gz"),
 ("adapter_with_U","-a GCCGAACUUCUUAGACUGCCUUAAGGACGU","illumina.fastq","illumina.fastq.gz"),
 ("no_trim","--no-trim --discard-untrimmed -a CCCTAGTTAAAC","no-trim.fastq","small.fastq"),
 ("bzip2","-b TTAGACATATCTCCGTCG","small.fastq","small.fastq.bz2"),
 ("xz","-b TTAGACATATCTCCGTCG","small.fastq","small.fastq.xz"),
 ("anchored_no_indels","-g ^TTAGACATAT --no-indels -e 0.1","anchored_no_indels.fasta","anchored_no_indels.fasta"),
 ("anchored_no_indels_wildcard_read","-g ^TTAGACATAT --match-read-wildcards --no-indels -e 0.1","anchored_no_indels_wildcard.fasta","anchored_no_indels.fasta"),
 ("anchored_no_indels_wildcard_adapt","-g ^TTAGACANAT --no-indels -e 0.1","anchored_no_indels.fasta","anchored_no_indels.fasta"),
 ("unconditional_cut_front","-u 5","unconditional-front.fastq","small.fastq"),
 ("unconditional_cut_back","-u -5","unconditional-back.fastq","small.fastq"),
 ("unconditional_cut_both","-u -5 -u 5","unconditional-both.fastq","small.fastq"),
 ("untrimmed_output","-a TTAGACATATCTCCGTCG --untrimmed-output {tmp}/untrimmed.tmp.fastq","small.trimmed.fastq","small.fastq"),
 ("adapter_file","-a file:"+D("adapter.fasta"),"illumina.fastq","illumina.fastq.gz"),
 ("adapter_file_5p_anchored","-N -g file:"+D("prefix-adapter.fasta"),"anchored.fasta","anchored.fasta"),
 ("adapter_file_3p_anchored","-N -a file:"+D("suffix-adapter.fasta"),"anchored-back.fasta","anchored-back.fasta"),
 ("adapter_file_5p_anchored_no_indels","-N --no-indels -g file:"+D("prefix-adapter.fasta"),"anchored.fasta","anchored.fasta"),
 ("adapter_file_3p_anchored_no_indels","-N --no-indels -a file:"+D("suffix-adapter.fasta"),"anchored-back.fasta","anchored-back.fasta"),
 ("max_n_0","--max-n 0","maxn0.fasta","maxn.fasta"),
 ("max_n_1","--max-n 1","maxn1.fasta","maxn.fasta"),
 ("max_n_2","--max-n 2","maxn2.fasta","maxn.fasta"),
 ("max_n_0.2","--max-n 0.2","maxn0.2.fasta","maxn.fasta"),
 ("max_n_0.4","--max-n 0.4","maxn0.4.fasta","maxn.fasta"),
 ("nextseq","--nextseq-trim 22","nextseq.fastq","nextseq.fastq"),
 ("linked","-a AAAAAAAAAA...TTTTTTTTTT","linked.fasta","linked.fasta"),
 ("fasta","-a TTAGACATATCTCCGTCG","small.fasta","small.fastq"),
 ("custom_bisulfite_1","-b TTAGACATATCTCCGTCG -q 0,0 --bisulfite 2,2,1,1","small.fastq","small.fastq"),
 ("custom_bisulfite_2","-b TTAGACATATCTCCGTCG -q 0,0 --bisulfite 15,15,1,1","small_mincut1.fastq","small.fastq"),
 ("custom_bisulfite_3","-b TTAGACATATCTCCGTCG -q 0,0 --bisulfite 2,2,1,0","small_mincut2.fastq","small.fastq"),
 ("custom_bisulfite_4","-b TTAGACATATCTCCGTCG -q 0,0 --bisulfite 2,2,0,0","small_mincut3.fastq","small.fastq"),
 ("demultiplex","-a first=AATTTCAGGAATT -a second=GTTCTCTAGTTCT","twoadapters.{name}.fasta","twoadapters.fasta"),
]

#: cases outside the slice -> the topic of the ROADMAP.md item they wait for
NOT_PORTED = {
    "minimum_length": "engine",
    "too_short": "engine",
    "too_short_no_primer": "engine",
    "maximum_length": "engine",
    "too_long": "engine",
    "length_tag": "engine",
    "mask_adapter": "engine",
    "suffix": "engine",
    "strip_suffix": "engine",
    "info_file_times": "engine",
    "no_trim": "engine",
    "linked": "engine",
}

#: further output files of the ported cases: (file written, golden file);
#: a golden of ``tests/conformance/data`` is named with its directory
SIDE_OUTPUTS = {
    "untrimmed_output": (("untrimmed.tmp.fastq", "small.untrimmed.fastq"),),
    "rest": (("rest.tmp", "../data/rest.txt"),),
    "restfront": (("rest.tmp", "../data/restfront.txt"),),
    "info_file": (("info.txt", "illumina.info.txt"),),
    "demultiplex": tuple(
        ("twoadapters.{}.fasta".format(name), "twoadapters.{}.fasta".format(name))
        for name in ("first", "second", "unknown")
    ),
}

#: wildcard files of the ported cases: their lines, as the upstream test
#: (``tests/test_trim_se.py::test_adapter_wildcard``) checks them
WILDCARD_LINES = {
    "adapter_wildcard_a": ["AAA 1", "GGG 2", "CCC 3b", "TTT 4b"],
    "adapter_wildcard_b": ["AAA 1", "GGG 2", "CCC 3b", "TTT 4b"],
}

PORTED = [case for case in CASES if case[0] not in NOT_PORTED]
UNPORTED = [case for case in CASES if case[0] in NOT_PORTED]


def _argv(params, expected, inpath, tmp_path):
    out = str(tmp_path / expected)
    argv = params.replace("{tmp}", str(tmp_path)).split()
    argv += ["-se", D(inpath), "-o", out]
    argv += ["--adapter-cache-file", str(tmp_path / ".adapters")]
    argv += ["--report-file", str(tmp_path / "report.txt"), "--quiet"]
    return argv, out


def test_case_table_is_complete():
    assert len(CASES) == len({case[0] for case in CASES}) == 79
    assert set(NOT_PORTED) <= {case[0] for case in CASES}
    assert set(NOT_PORTED.values()) <= set(ROADMAP_ITEMS)
    assert len(PORTED) == 67


@pytest.mark.parametrize(
    "name,params,expected,inpath", PORTED, ids=[c[0] for c in PORTED]
)
def test_golden(name, params, expected, inpath, tmp_path):
    argv, out = _argv(params, expected, inpath, tmp_path)
    retcode, summary = get_command("trim").execute(argv, device="cpu")
    assert "exception" not in summary, summary.get("exception")
    assert retcode == 0
    assert summary["mode"] == "turbo" and summary["device"] == "cpu"
    if name not in SIDE_OUTPUTS or "{name}" not in expected:
        assert_files_equal(cutpath(expected), out)
    for written, golden in SIDE_OUTPUTS.get(name, ()):
        assert_files_equal(cutpath(golden), str(tmp_path / written))
    if name in WILDCARD_LINES:
        with open(str(tmp_path / "wc.txt")) as wct:
            lines = [line.strip() for line in wct.readlines()]
        assert lines == WILDCARD_LINES[name]
    assert os.path.exists(str(tmp_path / "report.txt"))


@pytest.mark.parametrize(
    "name,params,expected,inpath", UNPORTED, ids=[c[0] for c in UNPORTED]
)
def test_outside_the_slice_raises(name, params, expected, inpath, tmp_path):
    argv, out = _argv(params, expected, inpath, tmp_path)
    with pytest.raises(NotPortedError) as err:
        get_command("trim").execute(argv, device="cpu")
    assert err.value.topic == NOT_PORTED[name]
    assert "ROADMAP.md queue 1 item" in str(err.value)
    assert ROADMAP_ITEMS[NOT_PORTED[name]] in str(err.value)
    assert not os.path.exists(out.replace("{name}", "first"))
    assert not os.path.exists(out)
