// Native FASTQ runtime: chunk parser and trimmed-record formatter.
//
// The Python/device pipeline needs record STRUCTURE (offsets/lengths), not
// string objects: the parser scans a raw buffer once and emits an index
// (per-record offsets of name/sequence/quality and their lengths), which
// numpy wraps zero-copy. The formatter assembles trimmed FASTQ output
// directly from the original buffer plus per-read keep-intervals, without
// materializing per-record Python strings. Together they replace the
// reference's per-record Python parsing (atropos/io/_seqio.pyx FastqReader)
// at native memory bandwidth.
//
// Build: g++ -O3 -march=native -shared -fPIC fastq.cpp -o libfastq.so
// ABI: plain C functions (ctypes-friendly).

#include <cstdint>
#include <cstring>

extern "C" {

// Parse FASTQ records from buf[0:len).
//
// Outputs (arrays of capacity max_records, caller-allocated):
//   name_off/name_len: '@'-line payload (without '@' or newline, CR stripped)
//   seq_off/seq_len:   sequence line
//   plus_off/plus_len: '+'-line payload (without '+')
//   qual_off/qual_len: quality line
//
// Stops at the last COMPLETE record that ends before len (so callers can
// stream arbitrary chunk boundaries); *consumed is set to the offset just
// past the last complete record. Returns the number of records parsed, or
// a negative error code: -1 malformed record start, -2 missing '+',
// -3 seq/qual length mismatch, -4 output capacity exhausted.
int64_t fastq_parse(
    const uint8_t* buf, int64_t len,
    int64_t max_records,
    int64_t* name_off, int32_t* name_len,
    int64_t* seq_off, int32_t* seq_len,
    int64_t* plus_off, int32_t* plus_len,
    int64_t* qual_off, int32_t* qual_len,
    int64_t* consumed)
{
    int64_t pos = 0;
    int64_t n = 0;
    *consumed = 0;

    auto find_eol = [&](int64_t start, int64_t* line_end, int64_t* next) -> bool {
        const uint8_t* nl = (const uint8_t*)memchr(buf + start, '\n', (size_t)(len - start));
        if (!nl) return false;
        int64_t e = nl - buf;
        *next = e + 1;
        if (e > start && buf[e - 1] == '\r') e -= 1;  // CRLF
        *line_end = e;
        return true;
    };

    while (pos < len) {
        if (n >= max_records) { return -4; }
        int64_t l1e, l2e, l3e, l4e, p2, p3, p4, p5;
        if (buf[pos] != '@') {
            // tolerate trailing newline-only garbage at end of buffer
            if (pos + 1 >= len && (buf[pos] == '\n' || buf[pos] == '\r')) break;
            return -1;
        }
        if (!find_eol(pos, &l1e, &p2)) break;
        if (p2 >= len) break;
        if (!find_eol(p2, &l2e, &p3)) break;
        if (p3 >= len || buf[p3] != '+') { if (p3 >= len) break; return -2; }
        if (!find_eol(p3, &l3e, &p4)) break;
        if (p4 >= len) break;
        if (!find_eol(p4, &l4e, &p5)) break;

        name_off[n] = pos + 1;
        name_len[n] = (int32_t)(l1e - pos - 1);
        seq_off[n] = p2;
        seq_len[n] = (int32_t)(l2e - p2);
        plus_off[n] = p3 + 1;
        plus_len[n] = (int32_t)(l3e - p3 - 1);
        qual_off[n] = p4;
        qual_len[n] = (int32_t)(l4e - p4);
        if (seq_len[n] != qual_len[n]) return -3;
        n += 1;
        pos = p5;
        *consumed = pos;
    }
    return n;
}

// Gather variable-length records into a fixed-width padded matrix.
// out must be [n_records * width]; rows are zero-padded.
void gather_padded(
    const uint8_t* buf,
    const int64_t* offs, const int32_t* lens,
    int64_t n_records, int64_t width,
    uint8_t* out)
{
    for (int64_t i = 0; i < n_records; ++i) {
        int64_t l = lens[i];
        if (l > width) l = width;
        memcpy(out + i * width, buf + offs[i], (size_t)l);
        memset(out + i * width + l, 0, (size_t)(width - l));
    }
}

// Parse FASTA records from buf[0:len), normalizing into out.
//
// Mirrors the Python FastaReader's semantics: every line is stripped of
// leading/trailing whitespace; blank lines and '#' comment lines are
// skipped; '>' (after stripping) opens a record; other lines append to
// the current record's sequence (so wrapped records are compacted).
// Records are written DENSELY into out (name bytes then sequence bytes,
// no separators); name/seq offsets index out, not buf.
//
// A record only completes when the next '>' line (or, with final != 0,
// the end of the buffer) is seen; *consumed is the input offset where
// the first incomplete record starts. Returns the record count, or
// -1 for a content line before any record (offending line offset in
// *err_off), -4 if max_records is exceeded.
int64_t fasta_parse(
    const uint8_t* buf, int64_t len,
    int64_t max_records, int64_t final,
    int64_t* name_off, int32_t* name_len,
    int64_t* seq_off, int32_t* seq_len,
    int64_t* consumed,
    uint8_t* out, int64_t* out_used,
    int64_t* err_off)
{
    auto is_space = [](uint8_t c) {
        return c == ' ' || c == '\t' || c == '\r' || c == '\n' ||
               c == '\v' || c == '\f';
    };
    int64_t pos = 0;
    int64_t n = -1;        // index of the open record
    int64_t w = 0;         // write cursor in out
    int64_t rec_start = 0; // input offset where the open record started
    *consumed = 0;

    while (pos < len) {
        const uint8_t* nl = (const uint8_t*)memchr(
            buf + pos, '\n', (size_t)(len - pos));
        int64_t line_end = nl ? (nl - buf) : len;
        int64_t next = nl ? line_end + 1 : len;
        if (!nl && !final) break;  // incomplete trailing line
        // strip
        int64_t a = pos, b = line_end;
        while (a < b && is_space(buf[a])) a += 1;
        while (b > a && is_space(buf[b - 1])) b -= 1;
        if (a == b || buf[a] == '#') { pos = next; continue; }
        if (buf[a] == '>') {
            // previous record is now complete
            if (n + 1 >= max_records) return -4;
            n += 1;
            rec_start = pos;
            name_off[n] = w;
            name_len[n] = (int32_t)(b - a - 1);
            memcpy(out + w, buf + a + 1, (size_t)(b - a - 1));
            w += b - a - 1;
            seq_off[n] = w;
            seq_len[n] = 0;
            *consumed = pos;  // provisional: this record is incomplete
        } else if (n < 0) {
            *err_off = pos;
            return -1;
        } else {
            memcpy(out + w, buf + a, (size_t)(b - a));
            w += b - a;
            seq_len[n] += (int32_t)(b - a);
        }
        pos = next;
    }
    if (n < 0) { *consumed = final ? pos : 0; *out_used = 0; return 0; }
    if (final) {
        *consumed = pos;
        *out_used = w;
        return n + 1;
    }
    // drop the trailing incomplete record (re-parsed with the next chunk)
    *out_used = name_off[n];
    *consumed = rec_start;
    return n;
}

// Assemble trimmed FASTA output: '>' name '\n' seq[start:stop] '\n' for
// records with keep[i] != 0. Returns bytes written, -1 on overflow.
int64_t fasta_format_trimmed(
    const uint8_t* buf,
    const int64_t* name_off, const int32_t* name_len,
    const int64_t* seq_off,
    const int32_t* keep_start, const int32_t* keep_stop,
    const uint8_t* keep,
    int64_t n_records,
    uint8_t* out, int64_t out_cap)
{
    int64_t w = 0;
    for (int64_t i = 0; i < n_records; ++i) {
        if (!keep[i]) continue;
        int64_t klen = keep_stop[i] - keep_start[i];
        if (klen < 0) klen = 0;
        if (w + 3 + name_len[i] + klen > out_cap) return -1;
        out[w++] = '>';
        memcpy(out + w, buf + name_off[i], (size_t)name_len[i]);
        w += name_len[i];
        out[w++] = '\n';
        memcpy(out + w, buf + seq_off[i] + keep_start[i], (size_t)klen);
        w += klen;
        out[w++] = '\n';
    }
    return w;
}

// BWA-style quality-trim windows, batched (host-native twin of the
// device kernels in align/batched.py; scalar spec in
// commands/trim/qualtrim.py and the reference _qualtrim.pyx:7-84).
//
// For each record i with window length win_len[i] at absolute offsets
// seq_off[i]/qual_off[i] (already advanced to the window start):
//   - if nextseq_cutoff >= 0: the NextSeq two-color 3' trim runs first
//     ('G' bases count as quality nextseq_cutoff-1); g_stop[i] is its
//     relative stop, and the quality stage (if any) scans the narrowed
//     window.
//   - if has_quality: the 5'/3' partial-sum scans produce relative
//     (q_start[i], q_stop[i]); start >= stop collapses to (0, 0).
// Records with win_len <= 0 emit zeros (callers mask empties anyway).
void quality_trim_windows(
    const uint8_t* buf,
    const int64_t* seq_off, const int64_t* qual_off,
    const int32_t* win_len,
    int64_t n_records,
    int32_t base,
    int32_t nextseq_cutoff,
    int32_t has_quality, int32_t cutoff_front, int32_t cutoff_back,
    int32_t* g_stop, int32_t* q_start, int32_t* q_stop)
{
    for (int64_t i = 0; i < n_records; ++i) {
        int32_t len = win_len[i];
        if (len <= 0) { g_stop[i] = 0; q_start[i] = 0; q_stop[i] = 0; continue; }
        const uint8_t* q = buf + qual_off[i];
        const uint8_t* sq = buf + seq_off[i];
        if (nextseq_cutoff >= 0) {
            int32_t s = 0, maxq = 0, maxi = len;
            for (int32_t j = len - 1; j >= 0; --j) {
                int32_t qv = (int32_t)q[j] - base;
                if (sq[j] == 'G') qv = nextseq_cutoff - 1;
                s += nextseq_cutoff - qv;
                if (s < 0) break;
                if (s > maxq) { maxq = s; maxi = j; }
            }
            g_stop[i] = maxi;
            len = maxi;
        } else {
            g_stop[i] = len;
        }
        if (!has_quality) { q_start[i] = 0; q_stop[i] = len; continue; }
        int32_t start = 0, stop = len;
        {
            int32_t s = 0, maxq = 0;
            for (int32_t j = 0; j < len; ++j) {
                s += cutoff_front - ((int32_t)q[j] - base);
                if (s < 0) break;
                if (s > maxq) { maxq = s; start = j + 1; }
            }
        }
        {
            int32_t s = 0, maxq = 0;
            for (int32_t j = len - 1; j >= 0; --j) {
                s += cutoff_back - ((int32_t)q[j] - base);
                if (s < 0) break;
                if (s > maxq) { maxq = s; stop = j; }
            }
        }
        if (start >= stop) { start = 0; stop = 0; }
        q_start[i] = start; q_stop[i] = stop;
    }
}

// Presence bitmap of byte values over the given records' payload bytes.
// out_present must be uint8[256]; existing nonzero entries are preserved
// (callers can accumulate over several record ranges).
void scan_alphabet(
    const uint8_t* buf,
    const int64_t* offs, const int32_t* lens,
    int64_t n_records,
    uint8_t* out_present)
{
    for (int64_t i = 0; i < n_records; ++i) {
        const uint8_t* p = buf + offs[i];
        int64_t l = lens[i];
        for (int64_t j = 0; j < l; ++j) out_present[p[j]] = 1;
    }
}

// Gather variable-length records into a bit-packed padded code matrix.
//
// code_lut maps byte -> small code (values < 2^bits); bits must be 2 or 4.
// Each output row holds width codes packed little-endian within each byte
// (code c at column j lands in byte j*bits/8, bit offset (j*bits)%8).
// out must be [n_records * width*bits/8]; width*bits must be a multiple
// of 8. Rows are zero-padded (code 0) past the record length.
void gather_packed(
    const uint8_t* buf,
    const int64_t* offs, const int32_t* lens,
    int64_t n_records, int64_t width,
    const uint8_t* code_lut, int64_t bits,
    uint8_t* out)
{
    const int64_t row_bytes = width * bits / 8;
    const int64_t per_byte = 8 / bits;
    for (int64_t i = 0; i < n_records; ++i) {
        uint8_t* row = out + i * row_bytes;
        const uint8_t* p = buf + offs[i];
        int64_t l = lens[i];
        if (l > width) l = width;
        int64_t full = l / per_byte;
        if (bits == 2) {
            for (int64_t b = 0; b < full; ++b) {
                const uint8_t* q = p + b * 4;
                row[b] = (uint8_t)(code_lut[q[0]] | (code_lut[q[1]] << 2) |
                                   (code_lut[q[2]] << 4) | (code_lut[q[3]] << 6));
            }
        } else {
            for (int64_t b = 0; b < full; ++b) {
                const uint8_t* q = p + b * 2;
                row[b] = (uint8_t)(code_lut[q[0]] | (code_lut[q[1]] << 4));
            }
        }
        int64_t done = full * per_byte;
        if (done < l) {
            uint8_t acc = 0;
            for (int64_t j = done; j < l; ++j)
                acc |= (uint8_t)(code_lut[p[j]] << ((j - done) * bits));
            row[full] = acc;
            full += 1;
        }
        if (full < row_bytes)
            memset(row + full, 0, (size_t)(row_bytes - full));
    }
}

// Assemble trimmed FASTQ output.
//
// For each record i with keep[i] != 0, writes:
//   '@' name '\n' seq[start:stop] '\n' '+' plus '\n' qual[start:stop] '\n'
// into out (capacity out_cap). Records whose bytes were MODIFIED by the
// pipeline (overlap error correction, mate overwrite) supply alternative
// sequence/quality bytes: when alt_seq_beg[i] >= 0, the sequence comes
// from alt_buf[alt_seq_beg[i]:alt_seq_end[i]] and the qualities from
// alt_buf[alt_qual_beg[i]:+same length]. Records whose HEADER changed
// (mate overwrite replaces the whole record with its partner's reverse
// complement) additionally supply alt_name_beg/alt_name_len and
// alt_plus_beg/alt_plus_len into alt_buf (alt pointers may be null when
// no record uses them). Returns bytes written, or -1 if out_cap is
// insufficient.
int64_t fastq_format_trimmed(
    const uint8_t* buf,
    const int64_t* name_off, const int32_t* name_len,
    const int64_t* seq_off,
    const int64_t* plus_off, const int32_t* plus_len,
    const int64_t* qual_off,
    const int32_t* keep_start, const int32_t* keep_stop,
    const uint8_t* keep,
    int64_t n_records,
    uint8_t* out, int64_t out_cap,
    const uint8_t* alt_buf,
    const int64_t* alt_seq_beg, const int64_t* alt_seq_end,
    const int64_t* alt_qual_beg,
    const int64_t* alt_name_beg, const int32_t* alt_name_len,
    const int64_t* alt_plus_beg, const int32_t* alt_plus_len)
{
    int64_t w = 0;
    for (int64_t i = 0; i < n_records; ++i) {
        if (!keep[i]) continue;
        const uint8_t* seq_src;
        const uint8_t* qual_src;
        int64_t klen;
        if (alt_seq_beg && alt_seq_beg[i] >= 0) {
            klen = alt_seq_end[i] - alt_seq_beg[i];
            seq_src = alt_buf + alt_seq_beg[i];
            qual_src = alt_buf + alt_qual_beg[i];
        } else {
            klen = keep_stop[i] - keep_start[i];
            if (klen < 0) klen = 0;
            seq_src = buf + seq_off[i] + keep_start[i];
            qual_src = buf + qual_off[i] + keep_start[i];
        }
        const uint8_t* name_src = buf + name_off[i];
        int64_t nlen = name_len[i];
        const uint8_t* plus_src = buf + plus_off[i];
        int64_t plen = plus_len[i];
        if (alt_name_beg && alt_name_beg[i] >= 0) {
            name_src = alt_buf + alt_name_beg[i];
            nlen = alt_name_len[i];
            plus_src = alt_buf + alt_plus_beg[i];
            plen = alt_plus_len[i];
        }
        int64_t need = 1 + nlen + 1 + klen + 2 + plen + 1 + klen + 1;
        if (w + need > out_cap) return -1;
        out[w++] = '@';
        memcpy(out + w, name_src, (size_t)nlen);
        w += nlen;
        out[w++] = '\n';
        memcpy(out + w, seq_src, (size_t)klen);
        w += klen;
        out[w++] = '\n';
        out[w++] = '+';
        memcpy(out + w, plus_src, (size_t)plen);
        w += plen;
        out[w++] = '\n';
        memcpy(out + w, qual_src, (size_t)klen);
        w += klen;
        out[w++] = '\n';
    }
    return w;
}

}  // extern "C"
