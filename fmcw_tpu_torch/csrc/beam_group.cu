// Cross-beam peak grouping with the top-K extraction's epilogues, on Hopper.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel_beam_group (called through
// peak_group_beams_pallas): keep det[b, r, d] only if it is the maximum over
// beams b - radius .. b + radius at the same (r, d) cell, ties toward the
// lower beam (m >= the beam above, m > the beam below); the beam axis does
// not wrap, and a missing neighbour beyond an edge counts as 0 (it never
// beats a detection).  The semantics of ops/cfar.peak_group_beams.  Besides
// the grouped cube it writes each row's maximum and the number of kept
// detections per cube, which ops/detect.topk_detections takes so that it
// never re-reads the grouped cube.
//
// In:  det float32 (B, NB, R, D) — or, with halo = radius > 0, (B, NB + 2
//      halo, R, D): a beam shard with its neighbours' planes on each side
//      (the sharded array model, fmcw_tpu/parallel/sharded.py:604-616),
//      plane i being global beam (id0 + i) mod n_total.  A neighbour counts
//      only if its global id is the CUT's plus its offset, so the global
//      beam edges stay edges; the contiguous case is halo 0, id0 0,
//      n_total NB.
// Out: grouped det (B, NB, R, D) — a shard's interior planes —, row_max
//      float32 (B, NB * R), n_dets int32 (B,) (zeroed by the caller; integer
//      atomics, exact).
//
// One warp per map row: its lanes stride over the row's D cells, compare
// each with the same cell of the 2 * radius neighbouring beams, store the
// kept value, and reduce the row's maximum and count with shuffles; one
// atomic per block adds the count.  Blocks run beam-fastest over the grid,
// so the neighbour beams' rows are read from L2 while still resident.
//
// Bound on an H100: bytes — the cube read once and written once, 8 B per
// cell, plus the row maxima; a few compares per cell.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors BeamGroupConfig in kernels.py (ctypes.Structure, all int32).
struct BeamGroupConfig {
    int batch, NB, R, D, radius, halo, id0, n_total;
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ int global_beam(int plane,
                                           const BeamGroupConfig& c) {
    const int g = (c.id0 + plane) % c.n_total;
    return g < 0 ? g + c.n_total : g;
}

// kShard: the halo-extended shard with global beam ids (the neighbour
// tests once per row, offsets up to 32); else the whole cube, where a
// neighbour exists if its plane does.
template <bool kShard>
__global__ void __launch_bounds__(kThreads)
beam_group_kernel(const float* __restrict__ det, float* __restrict__ out,
                  float* __restrict__ row_max, int* __restrict__ n_dets,
                  const BeamGroupConfig c) {
    __shared__ int count;
    const int beam = blockIdx.x;
    const int row = blockIdx.y * kWarps + threadIdx.x / 32;
    const int b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    int kept = 0;
    if (row < c.R) {
        const int nb_in = kShard ? c.NB + 2 * c.halo : c.NB;
        const int q = kShard ? beam + c.halo : beam;  // the CUT's plane
        unsigned has_up = 0u, has_dn = 0u;             // bit o - 1: offset o
        if (kShard) {
            const int gq = global_beam(q, c);
            for (int o = 1; o <= c.radius; ++o) {
                if (q + o < nb_in && global_beam(q + o, c) - gq == o)
                    has_up |= 1u << (o - 1);
                if (q - o >= 0 && gq - global_beam(q - o, c) == o)
                    has_dn |= 1u << (o - 1);
            }
        }
        const size_t plane = (size_t)c.R * c.D;
        const size_t base = (((size_t)b * nb_in + q) * c.R + row) * c.D;
        const size_t obase = (((size_t)b * c.NB + beam) * c.R + row) * c.D;
        float mx = 0.f;
        for (int d = lane; d < c.D; d += 32) {
            const float m = det[base + d];
            bool keep = m > 0.f;
            for (int o = 1; o <= c.radius; ++o) {
                const bool u = kShard ? (has_up >> (o - 1)) & 1u
                                      : q + o < nb_in;
                const bool w = kShard ? (has_dn >> (o - 1)) & 1u : q - o >= 0;
                const float up = u ? det[base + o * plane + d] : 0.f;
                const float dn = w ? det[base - o * plane + d] : 0.f;
                keep = keep && m >= up && m > dn;
            }
        const float g = keep ? m : 0.f;
            out[obase + d] = g;
            mx = fmaxf(mx, g);
            kept += keep;
        }
        for (int s = 16; s > 0; s >>= 1) {
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
            kept += __shfl_xor_sync(0xffffffffu, kept, s);
        }
        if (lane == 0) {
            row_max[((size_t)b * c.NB + beam) * c.R + row] = mx;
            if (kept) atomicAdd(&count, kept);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0 && count) atomicAdd(&n_dets[b], count);
}

}  // namespace

// det: float32 (batch, NB + 2 halo, R, D); out: float32 (batch, NB, R, D);
// row_max: float32 (batch, NB * R);
// n_dets: int32 (batch,), zeroed by the caller.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int fmcw_beam_group(const void* det, void* out, void* row_max,
                               void* n_dets, const BeamGroupConfig* cfg,
                               void* stream) {
    const BeamGroupConfig c = *cfg;
    const int row_blocks = (c.R + kWarps - 1) / kWarps;
    if (c.batch < 1 || c.batch > 65535 || c.NB < 1 || c.NB > 65535 ||
        c.R < 1 || c.D < 1 || row_blocks > 65535 || c.radius < 0 ||
        c.halo < 0 || c.n_total < 1 || (c.halo > 0 && c.radius > 32))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(c.NB, row_blocks, c.batch);
    auto kernel = c.halo > 0 ? beam_group_kernel<true>
                             : beam_group_kernel<false>;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(det), static_cast<float*>(out),
        static_cast<float*>(row_max), static_cast<int*>(n_dets), c);
    return (int)cudaGetLastError();
}
