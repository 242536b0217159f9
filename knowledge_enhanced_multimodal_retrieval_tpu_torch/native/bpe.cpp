// Native BPE merge engine.
//
// The byte-pair-merge loop is the tokenizer's hot path on the serving host
// (the accelerator handles everything after token ids). This implements exactly the
// algorithm of data/tokenizer.py::CLIPTokenizer.bpe — repeatedly merge the
// lowest-ranked adjacent pair — over UTF-8 code points, returning the merged
// tokens space-joined (the Python wrapper maps them to ids).
//
// C ABI (for ctypes):
//   void*  kemr_bpe_create(const char* merges, size_t len);
//       merges: newline-separated "left right" pairs in rank order.
//   void   kemr_bpe_destroy(void* handle);
//   long   kemr_bpe_apply(void* handle, const char* word, char* out, long cap);
//       word: UTF-8 string of byte-encoder characters (no trailing </w>);
//       out:  space-joined merged tokens, "</w>" appended to the last char.
//       returns bytes written, or -1 if cap is too small / handle invalid.

#include <cstddef>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        std::hash<std::string> h;
        return h(p.first) * 1000003u ^ h(p.second);
    }
};

struct BpeModel {
    std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
};

// Split a UTF-8 string into code-point substrings.
std::vector<std::string> utf8_chars(const char* s, size_t len) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < len) {
        unsigned char c = static_cast<unsigned char>(s[i]);
        size_t n = 1;
        if ((c & 0x80u) == 0x00u) n = 1;
        else if ((c & 0xE0u) == 0xC0u) n = 2;
        else if ((c & 0xF0u) == 0xE0u) n = 3;
        else if ((c & 0xF8u) == 0xF0u) n = 4;
        if (i + n > len) n = 1;  // malformed tail: take the byte as-is
        out.emplace_back(s + i, n);
        i += n;
    }
    return out;
}

}  // namespace

extern "C" {

void* kemr_bpe_create(const char* merges, size_t len) {
    auto* model = new BpeModel();
    size_t start = 0;
    int rank = 0;
    while (start < len) {
        size_t end = start;
        while (end < len && merges[end] != '\n') ++end;
        // line = merges[start:end]; split on the single space
        size_t sp = start;
        while (sp < end && merges[sp] != ' ') ++sp;
        if (sp > start && sp + 1 < end) {
            model->ranks.emplace(
                std::make_pair(std::string(merges + start, sp - start),
                               std::string(merges + sp + 1, end - sp - 1)),
                rank++);
        }
        start = end + 1;
    }
    return model;
}

void kemr_bpe_destroy(void* handle) { delete static_cast<BpeModel*>(handle); }

long kemr_bpe_apply(void* handle, const char* word, char* out, long cap) {
    auto* model = static_cast<BpeModel*>(handle);
    if (model == nullptr || word == nullptr) return -1;
    size_t len = std::strlen(word);
    if (len == 0) return 0;

    std::vector<std::string> parts = utf8_chars(word, len);
    parts.back() += "</w>";

    if (parts.size() > 1) {
        const int kNoRank = 0x7FFFFFFF;
        while (parts.size() > 1) {
            // find the lowest-ranked adjacent pair
            int best_rank = kNoRank;
            size_t best_i = 0;
            for (size_t i = 0; i + 1 < parts.size(); ++i) {
                auto it = model->ranks.find({parts[i], parts[i + 1]});
                if (it != model->ranks.end() && it->second < best_rank) {
                    best_rank = it->second;
                    best_i = i;
                }
            }
            if (best_rank == kNoRank) break;
            // merge every occurrence of that pair (left-to-right), like the
            // reference algorithm
            const std::string first = parts[best_i];
            const std::string second = parts[best_i + 1];
            std::vector<std::string> merged;
            merged.reserve(parts.size());
            size_t i = 0;
            while (i < parts.size()) {
                if (i + 1 < parts.size() && parts[i] == first && parts[i + 1] == second) {
                    merged.push_back(first + second);
                    i += 2;
                } else {
                    merged.push_back(parts[i]);
                    i += 1;
                }
            }
            parts.swap(merged);
        }
    }

    long written = 0;
    for (size_t i = 0; i < parts.size(); ++i) {
        long need = static_cast<long>(parts[i].size()) + (i > 0 ? 1 : 0);
        if (written + need + 1 > cap) return -1;
        if (i > 0) out[written++] = ' ';
        std::memcpy(out + written, parts[i].data(), parts[i].size());
        written += static_cast<long>(parts[i].size());
    }
    out[written] = '\0';
    return written;
}

}  // extern "C"
