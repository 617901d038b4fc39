// sivo_native: C-ABI native runtime components.
//
// The reference implements its whole runtime in C++; the TPU rebuild
// keeps the compute path in XLA but implements the host-side
// performance-critical runtime pieces natively too:
//
//  1. vocabulary text parsing — the reference's dominant startup cost
//     (ref: src/orbslam/System.cc:75-82 loads a ~1M-line ORBvoc.txt via
//     DBoW2 TemplatedVocabulary::loadFromTextFile). A Python line
//     parser takes tens of seconds; this parser streams the file once.
//
//  2. the BoW inverted-file index — per-keyframe insertion/erase and
//     shared-word candidate counting (ref:
//     src/orbslam/KeyFrameDatabase.cc:35-129), called at keyframe rate
//     with word lists of ~1-2k entries over vocabularies of ~1M words.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image). Build: sivo_tpu/native/build.sh (cmake + ninja).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. vocabulary text parser
// ---------------------------------------------------------------------------
// Format (DBoW2 loadFromTextFile): header "k L scoring weighting\n",
// then per node: parent_idx is_leaf b0..b31 weight
//
// Returns 0 on success. Caller provides output buffers sized n_nodes
// (call voc_count_nodes first).

int64_t voc_count_nodes(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t lines = 0;
    char buf[1 << 16];
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f)) > 0) {
        for (size_t i = 0; i < got; ++i)
            if (buf[i] == '\n') ++lines;
    }
    fclose(f);
    return lines > 0 ? lines - 1 : 0;  // minus header
}

int voc_parse(const char* path, int64_t n_nodes, int32_t* k_out,
              int32_t* depth_out, int32_t* parents, uint8_t* leaf_flags,
              uint8_t* descriptors /* n_nodes*32 */, float* weights) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    int k = 0, depth = 0, s = 0, w = 0;
    if (fscanf(f, "%d %d %d %d", &k, &depth, &s, &w) != 4) {
        fclose(f);
        return 2;
    }
    *k_out = k;
    *depth_out = depth;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int parent = 0, leaf = 0;
        if (fscanf(f, "%d %d", &parent, &leaf) != 2) {
            fclose(f);
            return 3;
        }
        parents[i] = parent;
        leaf_flags[i] = (uint8_t)leaf;
        for (int b = 0; b < 32; ++b) {
            int v = 0;
            if (fscanf(f, "%d", &v) != 1) {
                fclose(f);
                return 4;
            }
            descriptors[i * 32 + b] = (uint8_t)v;
        }
        float wt = 0.f;
        if (fscanf(f, "%f", &wt) != 1) {
            fclose(f);
            return 5;
        }
        weights[i] = wt;
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// 2. inverted-file index
// ---------------------------------------------------------------------------

struct InvertedFile {
    int64_t n_words;
    std::vector<std::vector<int32_t>> lists;  // word -> keyframes
};

void* invfile_create(int64_t n_words) {
    auto* f = new InvertedFile();
    f->n_words = n_words;
    f->lists.resize((size_t)n_words);
    return f;
}

void invfile_destroy(void* h) { delete (InvertedFile*)h; }

// add keyframe kf under each word in words[0..n)
void invfile_add(void* h, int32_t kf, const int32_t* words, int64_t n) {
    auto* f = (InvertedFile*)h;
    for (int64_t i = 0; i < n; ++i) {
        int32_t w = words[i];
        if (w >= 0 && w < f->n_words) f->lists[(size_t)w].push_back(kf);
    }
}

void invfile_erase(void* h, int32_t kf, const int32_t* words, int64_t n) {
    auto* f = (InvertedFile*)h;
    for (int64_t i = 0; i < n; ++i) {
        int32_t w = words[i];
        if (w < 0 || w >= f->n_words) continue;
        auto& v = f->lists[(size_t)w];
        for (size_t j = 0; j < v.size(); ++j) {
            if (v[j] == kf) {
                v.erase(v.begin() + (long)j);
                break;
            }
        }
    }
}

// shared-word counts: for query words, count hits per keyframe id into
// counts[0..max_kf) (ref: KeyFrameDatabase.cc:86-118 inverted-file walk)
void invfile_shared_counts(void* h, const int32_t* words, int64_t n,
                           int32_t* counts, int64_t max_kf) {
    auto* f = (InvertedFile*)h;
    memset(counts, 0, sizeof(int32_t) * (size_t)max_kf);
    for (int64_t i = 0; i < n; ++i) {
        int32_t w = words[i];
        if (w < 0 || w >= f->n_words) continue;
        for (int32_t kf : f->lists[(size_t)w]) {
            if (kf >= 0 && kf < max_kf) counts[kf]++;
        }
    }
}

}  // extern "C"
