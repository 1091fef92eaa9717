"""SOLiD colorspace conversion (XOR-of-nucleotides encoding).

Counterpart of ``atropos_tpu/util/colorspace.py``; the
encoding is the standard dibase table where color = index(a) XOR index(b),
with 'N'/'.' mapping to color '4' / base 'N'.
"""


def _initialize_dicts():
    enc = {}
    for i, char1 in enumerate("ACGT"):
        enc["N" + char1] = "4"
        enc[char1 + "N"] = "4"
        enc["." + char1] = "4"
        enc[char1 + "."] = "4"
        for j, char2 in enumerate("ACGT"):
            enc[char1 + char2] = chr(ord("0") + (i ^ j))
    enc.update({"NN": "4", "N.": "4", ".N": "4", "..": "4"})

    dec = {}
    for i, char1 in enumerate("ACGT"):
        dec["." + str(i)] = "N"
        dec["N" + str(i)] = "N"
        dec[char1 + "4"] = "N"
        dec[char1 + "."] = "N"
        for j, char2 in enumerate("ACGT"):
            dec[char1 + chr(ord("0") + (i ^ j))] = char2
    dec["N4"] = "N"

    return (enc, dec)


ENCODE, DECODE = _initialize_dicts()


def encode(nucs):
    """Nucleotides -> colorspace; first char is the primer base."""
    if not nucs:
        return nucs
    encoded = nucs[0:1]
    for idx in range(len(nucs) - 1):
        encoded += ENCODE[nucs[idx : idx + 2]]
    return encoded


def decode(colors):
    """Colorspace -> nucleotides; first char must be a nucleotide."""
    if len(colors) < 2:
        return colors
    result = base = colors[0]
    for col in colors[1:]:
        base = DECODE[base + col]
        result += base
    return result
