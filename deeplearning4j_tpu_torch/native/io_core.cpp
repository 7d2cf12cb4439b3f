// Native IO core of the port — the host data-loading hot path in C++ (a
// copy of the JAX package's deeplearning4j_tpu/native/io_core.cpp, which
// the port may not import; the two return the same arrays).
//
// The reference keeps its performance-critical runtime in native code
// (libnd4j via JNI; canova's readers feed it). In the port the compute
// native layer is the CUDA kernels of csrc/; what remains host-side and
// hot is record parsing and corpus encoding, implemented here and bound
// via ctypes (deeplearning4j_tpu_torch/native/__init__.py) with
// pure-Python paths when no toolchain is available.
//
// Exposed C ABI:
//   dl4j_csv_dims      — scan a numeric CSV for (rows, cols)
//   dl4j_parse_csv     — parse into a caller-allocated float32 matrix
//   dl4j_svmlight_rows — count records in an SVMLight file
//   dl4j_parse_svmlight— labels + dense float32 features
//   dl4j_encode_tokens — whitespace-tokenize a text buffer and map each
//                        token to its vocab index (open-addressing hash),
//                        -1 for OOV
//   dl4j_encode_corpus — the same over a whole corpus, one sentence a
//                        line, with each token's sentence index: the
//                        corpus-indexing step of Word2Vec's host path.
//
// All functions return -1 on hard errors (unreadable file, malformed
// numeric cell), which the Python side turns into its Python path.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

bool read_file(const char* path, std::string& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    if (n < 0) {  // non-seekable (FIFO/device): not supported here
        std::fclose(f);
        return false;
    }
    std::fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(n));
    size_t got = n ? std::fread(&out[0], 1, static_cast<size_t>(n), f) : 0;
    std::fclose(f);
    return got == static_cast<size_t>(n);
}

// FNV-1a — stable, fast, good enough for vocab-sized tables.
uint64_t fnv1a(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; ++i) {
        h ^= static_cast<unsigned char>(s[i]);
        h *= 1099511628211ull;
    }
    return h;
}

struct TokenHash {
    // open addressing, power-of-two capacity
    std::vector<int64_t> idx;     // vocab index or -1
    std::vector<const char*> key;
    std::vector<size_t> klen;
    size_t mask = 0;

    void build(const char* blob, int64_t blob_len, int64_t n_words) {
        size_t cap = 16;
        while (cap < static_cast<size_t>(n_words) * 2) cap <<= 1;
        idx.assign(cap, -1);
        key.assign(cap, nullptr);
        klen.assign(cap, 0);
        mask = cap - 1;
        const char* p = blob;
        const char* end = blob + blob_len;
        int64_t wi = 0;
        while (p < end && wi < n_words) {
            const char* nl = static_cast<const char*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            size_t len = nl ? static_cast<size_t>(nl - p)
                            : static_cast<size_t>(end - p);
            size_t h = fnv1a(p, len) & mask;
            while (idx[h] != -1) h = (h + 1) & mask;
            idx[h] = wi;
            key[h] = p;
            klen[h] = len;
            ++wi;
            p = nl ? nl + 1 : end;
        }
    }

    int64_t lookup(const char* s, size_t n) const {
        size_t h = fnv1a(s, n) & mask;
        while (idx[h] != -1) {
            if (klen[h] == n && std::memcmp(key[h], s, n) == 0) return idx[h];
            h = (h + 1) & mask;
        }
        return -1;
    }
};

inline bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v'
        || c == '\f';
}

}  // namespace

namespace {

// Scan dims of a numeric CSV. Returns 0 on success, -1 on IO error.
long csv_dims_impl(const char* path, long skip_lines, char delim,
                   long* n_rows, long* n_cols) {
    std::string buf;
    if (!read_file(path, buf)) return -1;
    long rows = 0, cols = 0, line = 0;
    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* eol = nl ? nl : end;
        if (line++ >= skip_lines && eol > p) {
            long c = 1;
            for (const char* q = p; q < eol; ++q)
                if (*q == delim) ++c;
            if (cols == 0) cols = c;
            if (c == cols) ++rows;  // ragged lines skipped like csv.reader+guard
        }
        p = nl ? nl + 1 : end;
    }
    *n_rows = rows;
    *n_cols = cols;
    return 0;
}

// Parse into out[rows*cols]. Returns rows parsed, or -1 on malformed cell.
long parse_csv_impl(const char* path, long skip_lines, char delim,
                    float* out, long max_rows, long n_cols) {
    std::string buf;
    if (!read_file(path, buf)) return -1;
    long rows = 0, line = 0;
    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end && rows < max_rows) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* eol = nl ? nl : end;
        if (line++ >= skip_lines && eol > p) {
            const char* q = p;
            long col = 0;
            bool malformed = false;   // bad numeric cell -> abort fast path
            bool ragged = false;      // wrong cell count -> skip (like dims)
            while (col < n_cols) {
                if (q >= eol) {       // missing cells (incl. empty last cell)
                    malformed = true;
                    break;
                }
                char* cell_end = nullptr;
                float v = std::strtof(q, &cell_end);
                // reject empty/non-numeric cells and values whose text ran
                // past the end of the line (strtof ignores newlines)
                if (cell_end == q || cell_end > eol) {
                    malformed = true;
                    break;
                }
                out[rows * n_cols + col] = v;
                q = cell_end;
                while (q < eol && (*q == ' ' || *q == '\r')) ++q;
                ++col;
                if (col < n_cols) {
                    if (q >= eol || *q != delim) {
                        ragged = true;  // fewer cells than the first line
                        break;
                    }
                    ++q;
                }
            }
            if (!malformed && !ragged && q < eol) {
                ragged = true;          // extra cells beyond n_cols
            }
            if (malformed) return -1;
            if (!ragged) ++rows;
        }
        p = nl ? nl + 1 : end;
    }
    return rows;
}

long svmlight_rows_impl(const char* path) {
    std::string buf;
    if (!read_file(path, buf)) return -1;
    long rows = 0;
    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* eol = nl ? nl : end;
        const char* q = p;
        while (q < eol && is_ws(*q)) ++q;
        if (q < eol && *q != '#') ++rows;
        p = nl ? nl + 1 : end;
    }
    return rows;
}

// labels[max_rows], feats[max_rows*num_features] (feats must be zeroed by
// the caller). Returns rows parsed or -1.
long parse_svmlight_impl(const char* path, long num_features, float* labels,
                         float* feats, long max_rows) {
    std::string buf;
    if (!read_file(path, buf)) return -1;
    long rows = 0;
    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end && rows < max_rows) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* eol = nl ? nl : end;
        const char* q = p;
        while (q < eol && is_ws(*q)) ++q;
        if (q < eol && *q != '#') {
            char* cell_end = nullptr;
            float label = std::strtof(q, &cell_end);
            if (cell_end == q || cell_end > eol) return -1;
            labels[rows] = label;
            q = cell_end;
            while (q < eol) {
                while (q < eol && is_ws(*q)) ++q;
                if (q >= eol || *q == '#') break;
                char* ie = nullptr;
                long idx = std::strtol(q, &ie, 10);
                if (ie == q || ie >= eol || *ie != ':') return -1;
                q = ie + 1;
                float v = std::strtof(q, &cell_end);
                // empty value: strtof would cross the newline and consume
                // the next line's label — same guard as the CSV parser
                if (cell_end == q || cell_end > eol) return -1;
                q = cell_end;
                if (idx >= 1 && idx <= num_features)
                    feats[rows * num_features + (idx - 1)] = v;
            }
            ++rows;
        }
        p = nl ? nl + 1 : end;
    }
    return rows;
}

// Tokenize text[0..text_len) on whitespace; for each token write its vocab
// index (or -1 for OOV) into out. vocab_blob: '\n'-joined words. Returns
// the number of tokens written (<= max_tokens).
long encode_tokens_impl(const char* text, long text_len,
                        const char* vocab_blob, long blob_len, long n_words,
                        int32_t* out, long max_tokens) {
    TokenHash table;
    table.build(vocab_blob, blob_len, n_words);
    long count = 0;
    const char* p = text;
    const char* end = text + text_len;
    while (p < end && count < max_tokens) {
        while (p < end && is_ws(*p)) ++p;
        if (p >= end) break;
        const char* start = p;
        while (p < end && !is_ws(*p)) ++p;
        out[count++] = static_cast<int32_t>(
            table.lookup(start, static_cast<size_t>(p - start)));
    }
    return count;
}

// one-pass corpus encoding: token ids + sentence ids (newline-separated
// sentences), built on a SINGLE vocab hash table for the whole corpus.
long encode_corpus_impl(const char* text, long text_len,
                        const char* vocab_blob, long blob_len, long n_words,
                        int32_t* out_ids, int32_t* out_sent,
                        long max_tokens) {
    TokenHash table;
    table.build(vocab_blob, blob_len, n_words);
    long count = 0;
    int32_t sent = 0;
    const char* p = text;
    const char* end = text + text_len;
    while (p < end && count < max_tokens) {
        while (p < end && is_ws(*p)) {
            if (*p == '\n') ++sent;
            ++p;
        }
        if (p >= end) break;
        const char* start = p;
        while (p < end && !is_ws(*p)) ++p;
        out_ids[count] = static_cast<int32_t>(
            table.lookup(start, static_cast<size_t>(p - start)));
        out_sent[count] = sent;
        ++count;
    }
    return count;
}

}  // namespace

// Every extern "C" entry is an exception barrier: the module contract is
// "hard errors return -1 and Python falls back", and a C++ exception
// escaping extern "C" would std::terminate the host interpreter.
extern "C" {

long dl4j_csv_dims(const char* path, long skip_lines, char delim,
                   long* n_rows, long* n_cols) {
    try { return csv_dims_impl(path, skip_lines, delim, n_rows, n_cols); }
    catch (...) { return -1; }
}

long dl4j_parse_csv(const char* path, long skip_lines, char delim,
                    float* out, long max_rows, long n_cols) {
    try { return parse_csv_impl(path, skip_lines, delim, out, max_rows,
                                n_cols); }
    catch (...) { return -1; }
}

long dl4j_svmlight_rows(const char* path) {
    try { return svmlight_rows_impl(path); }
    catch (...) { return -1; }
}

long dl4j_parse_svmlight(const char* path, long num_features, float* labels,
                         float* feats, long max_rows) {
    try { return parse_svmlight_impl(path, num_features, labels, feats,
                                     max_rows); }
    catch (...) { return -1; }
}

long dl4j_encode_tokens(const char* text, long text_len,
                        const char* vocab_blob, long blob_len, long n_words,
                        int32_t* out, long max_tokens) {
    try { return encode_tokens_impl(text, text_len, vocab_blob, blob_len,
                                    n_words, out, max_tokens); }
    catch (...) { return -1; }
}

long dl4j_encode_corpus(const char* text, long text_len,
                        const char* vocab_blob, long blob_len, long n_words,
                        int32_t* out_ids, int32_t* out_sent,
                        long max_tokens) {
    try { return encode_corpus_impl(text, text_len, vocab_blob, blob_len,
                                    n_words, out_ids, out_sent, max_tokens); }
    catch (...) { return -1; }
}

}  // extern "C"
