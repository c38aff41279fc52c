// Kernel K12: owner-computes row gather from a table split over S shards.
//
// Replaces: bowtie2_tpu/ops/fm.py:55 _take_sharded (reached through _rows
// :74, _take_offs :83 and ops/ref.py:29 _take_words), where every device
// of the mesh's `shard` axis gathers the rows it owns, puts zeros
// elsewhere, and a psum over the axis adds the results. Every index in
// range has one owner, so the result is the owner's row, or zeros where no
// shard owns the index (negative, or at S per or past it).
//
// Here one process reads every shard: shard s holds the global rows
// [s per, (s + 1) per) at the address shards[s] (a device array of S
// addresses on the card that launches, built once per table), and each
// index finds its owner by a divide. No collective runs: a shard on
// another card is read through peer access, which the caller enables.
//
// One thread a 16-byte part of a row where the rows allow it (rows of a
// multiple of 4 words, every shard 16-byte aligned: fm_blocks, 12 words
// a row, takes three), else one thread a word (mark_rows, 5 words; offs
// and the reference words, 1). The bound on the card is the scattered
// row loads: a gather has no reuse for wgmma or TMA to serve.
//
// The index is int32, or int64 (the large mode's word indices, whose
// values stay below 2^31). The table's words are uint32 bits (the port's
// int32 tensors); the output is (n, row_words) words on the launching card.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename IDX, int VEC>
__global__ void __launch_bounds__(THREADS)
take_kernel(const unsigned long long* __restrict__ shards, long long per,
            int S, int row_words, const IDX* __restrict__ idx, long long n,
            uint32_t* __restrict__ out) {
    const int parts = row_words / VEC;                 // threads a row
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= n * parts) return;
    const long long k = t / parts;
    const int u = (int)(t - k * parts);
    const long long g = (long long)__ldg(idx + k);
    const long long s = g >= 0 ? g / per : S;          // negative: no owner
    const bool held = s < S;
    if constexpr (VEC == 4) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (held) {
            const uint4* row = reinterpret_cast<const uint4*>(
                reinterpret_cast<const uint32_t*>(__ldg(shards + s))
                + (g - s * per) * row_words);
            v = __ldg(row + u);
        }
        reinterpret_cast<uint4*>(out + k * row_words)[u] = v;
    } else {
        uint32_t v = 0;
        if (held)
            v = __ldg(reinterpret_cast<const uint32_t*>(__ldg(shards + s))
                      + (g - s * per) * row_words + u);
        out[k * row_words + u] = v;
    }
}

template <typename IDX>
int launch(const void* shards, long long per, int S, int row_words, int vec,
           const void* idx, long long n, void* out, void* stream) {
    if (per <= 0 || S <= 0 || row_words <= 0 ||
        (vec == 4 && row_words % 4 != 0) || (vec != 4 && vec != 1))
        return (int)cudaErrorInvalidValue;
    const long long threads = n * (row_words / vec);
    if (threads <= 0) return (int)cudaGetLastError();
    const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
    const auto* sh = (const unsigned long long*)shards;
    if (vec == 4)
        take_kernel<IDX, 4><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            sh, per, S, row_words, (const IDX*)idx, n, (uint32_t*)out);
    else
        take_kernel<IDX, 1><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            sh, per, S, row_words, (const IDX*)idx, n, (uint32_t*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// out[k, :] = the row idx[k] of the sharded table, or zeros; idx int32,
// or int64 when idx64 is set. vec: 4 for 16-byte parts (rows of a
// multiple of 4 words, shards 16-byte aligned), else 1.
extern "C" int take_sharded(const void* shards, long long per, int S,
                            int row_words, int vec, const void* idx,
                            int idx64, long long n, void* out, void* stream) {
    return idx64 ? launch<long long>(shards, per, S, row_words, vec, idx, n,
                                     out, stream)
                 : launch<int>(shards, per, S, row_words, vec, idx, n, out,
                               stream);
}

// Let `device` read memory on `peer` (a shard on another card). Returns a
// CUDA error, 0 when access is on (also when it already was); the current
// device is put back.
extern "C" int enable_peer(int device, int peer) {
    int cur = 0;
    cudaError_t e = cudaGetDevice(&cur);
    if (e != cudaSuccess) return (int)e;
    e = cudaSetDevice(device);
    if (e == cudaSuccess) {
        e = cudaDeviceEnablePeerAccess(peer, 0);
        if (e == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();          // clear the error it left
            e = cudaSuccess;
        }
    }
    cudaSetDevice(cur);
    return (int)e;
}
