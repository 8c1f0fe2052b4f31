// Masked TF-IDF scoring for Hopper (sm_90a): for every document d,
//   score[d] = sum over postings p of d of  w[term[p]] * tf[p] / doc_len[d]
// when doc_mask[d] is set, and 0 otherwise (w = query * idf, computed
// outside).  Postings are sorted by document; doc_ptr[d] .. doc_ptr[d+1] are
// the postings of document d (CSR).
//
// Replaces: src/repro/stores/masked_kernels.py::masked_tfidf_pallas, the TPU
// kernel that takes pre-gathered posting features, builds a one-hot
// (postings x docs) tile per block, reduces it on the MXU and skips posting
// blocks whose keep weights are all zero.  On Hopper the one-hot product is
// O(E * D) work, and the gathers the TPU kernel leaves outside would read
// every posting whatever the mask.  So this kernel gathers inside: one
// thread per document (grid-stride) reads its mask byte and, only when the
// document is kept, walks its postings.  A masked document costs one byte;
// the TPU's all-masked block skip becomes a per-document skip.
//
// Exactness: each thread sums its document's postings in posting order, in
// float32, as ((w * tf) / doc_len) added to a running sum that starts at
// 0 -- the expression and order of the port's dense tfidf_scores.  The
// intrinsics pin every rounding (no FMA contraction, IEEE division), so a
// kept document's score is bitwise equal to the dense one and top-k ties
// break as on the unpushed plan.  No atomics: the result does not change
// from run to run.
//
// Bound: memory.  Every document's mask byte is read and its score written
// (1 + 4 bytes); a kept document also reads doc_ptr[d], doc_ptr[d+1] and
// doc_len[d] (12 bytes) and, per posting, term and tf (8 bytes); the
// vocab-sized w is read once (4 V, cached):
// 5 D + 12 D_kept + 8 E_kept + 4 V bytes over 3.35 TB/s.
//
// Known cost: neighbouring threads walk neighbouring documents, so a warp's
// posting reads are strided by the document length (~16 postings) and
// coalesce only through L1.
#include <cuda_runtime.h>

namespace {

__global__ void masked_tfidf_kernel(const int* __restrict__ doc_ptr,
                                    const int* __restrict__ term_ids,
                                    const float* __restrict__ tf,
                                    const float* __restrict__ doc_len,
                                    const float* __restrict__ w,
                                    const unsigned char* __restrict__ mask,
                                    float* __restrict__ out, int n_docs) {
  const int stride = blockDim.x * gridDim.x;
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < n_docs;
       d += stride) {
    float acc = 0.0f;
    if (__ldg(mask + d) != 0) {
      const int start = __ldg(doc_ptr + d);
      const int end = __ldg(doc_ptr + d + 1);
      const float dl = __ldg(doc_len + d);
      for (int p = start; p < end; ++p) {
        const float c = __fmul_rn(__ldg(w + __ldg(term_ids + p)),
                                  __ldg(tf + p));
        acc = __fadd_rn(acc, __fdiv_rn(c, dl));
      }
    }
    out[d] = acc;
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // 64 blocks per SM
  return (unsigned)blocks;
}

}  // namespace

// doc_ptr holds n_docs + 1 int32 offsets into the postings (term_ids, tf);
// mask holds n_docs bytes (torch.bool); out receives n_docs float32 scores.
// Returns cudaGetLastError() after the launch.
extern "C" int masked_tfidf_f32(const void* doc_ptr, const void* term_ids,
                                const void* tf, const void* doc_len,
                                const void* w, const void* mask, void* out,
                                int n_docs, void* stream) {
  if (n_docs > 0) {
    const int threads = 256;
    masked_tfidf_kernel<<<grid_for(n_docs, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(doc_ptr), static_cast<const int*>(term_ids),
        static_cast<const float*>(tf), static_cast<const float*>(doc_len),
        static_cast<const float*>(w),
        static_cast<const unsigned char*>(mask), static_cast<float*>(out),
        n_docs);
  }
  return static_cast<int>(cudaGetLastError());
}
