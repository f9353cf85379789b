// Native word-level edit distance for WER computation.
//
// Role: the eval-time hot loop (train/metrics.py levenshtein — parity
// with essentials.py:576-592; the PyTorch port's copy of
// asr_model_tpu/native/wer.cpp).  Python's O(m*n) DP is the bottleneck
// when scoring thousands of utterances; this engine runs the two-row
// DP over integer word ids.
//
// C API:
//   int wer_levenshtein(const int* ref, int m, const int* hyp, int n);

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int wer_levenshtein(const int32_t* ref, int m, const int32_t* hyp, int n) {
    if (m == 0) return n;
    if (n == 0) return m;
    std::vector<int> prev(n + 1), cur(n + 1);
    for (int k = 0; k <= n; ++k) prev[k] = k;
    for (int q = 1; q <= m; ++q) {
        cur[0] = q;
        const int32_t rw = ref[q - 1];
        for (int k = 1; k <= n; ++k) {
            if (rw == hyp[k - 1]) {
                cur[k] = prev[k - 1];
            } else {
                cur[k] = 1 + std::min({prev[k - 1], cur[k - 1], prev[k]});
            }
        }
        std::swap(prev, cur);
    }
    return prev[n];
}

}  // extern "C"
